"""Core layers: Dense, Activation, Dropout, Flatten, Lambda (port of
``pipeline/api/keras/layers/core.py``).

Dense rounds its operands to the compute dtype and takes a float32
result (``ops.dtypes.matmul``), or, when its params carry
``kernel_scale``/``act_scale``, runs the int8 product
(``ops.quant.quantized_matmul``); with a bias and the tanh-GeLU
activation its tail goes through the fused bias→GeLU epilogue either
way.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from analytics_zoo_torch.ops import activations as acts
from analytics_zoo_torch.ops.dtypes import matmul as _matmul
from analytics_zoo_torch.pipeline.api.keras.engine import Layer, Params


class Dense(Layer):
    """Fully-connected layer; the contraction is over the last dim, so the
    input may have rank > 2."""

    def __init__(self, output_dim: int, init="glorot_uniform",
                 activation=None, bias: bool = True,
                 parallel_mode: Optional[str] = None, **kwargs):
        super().__init__(**kwargs)
        if parallel_mode is not None:
            raise NotImplementedError(
                "Dense(parallel_mode=...): tensor parallelism comes with "
                "the multi-GPU slice of the port (ROADMAP.md)")
        self.output_dim = int(output_dim)
        self.kernel_init = init
        self.activation = acts.get(activation)
        self.use_bias = bias

    def build(self, rng, input_shape) -> Params:
        in_dim = input_shape[-1]
        params: Params = {}
        self.add_weight(params, rng, "kernel", (in_dim, self.output_dim),
                        init=self.kernel_init)
        if self.use_bias:
            self.add_weight(params, rng, "bias", (self.output_dim,),
                            init="zero")
        return params

    def call(self, params, x, training=False, rng=None):
        if "kernel_scale" in params:
            # calibrated int8 path (ops/quant.py), set by quantization
            from analytics_zoo_torch.ops.quant import quantized_matmul
            y = quantized_matmul(x, params["kernel"], params["kernel_scale"],
                                 params["act_scale"])
        else:
            y = _matmul(x, params["kernel"])
        if self.use_bias and self.activation is acts.gelu:
            # fused bias→GeLU epilogue; its plain form is gelu(y + bias)
            from analytics_zoo_torch.ops import fused
            if fused.fused_enabled():
                return fused.bias_gelu(y, params["bias"])
        if self.use_bias:
            y = y + params["bias"]
        if self.activation is not None:
            y = self.activation(y)
        return y

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


class Activation(Layer):
    """An activation (``ops.activations.get``) as a layer of its own."""

    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self.activation = acts.get(activation) or (lambda x: x)

    def call(self, params, x, training=False, rng=None):
        return self.activation(x)


class Dropout(Layer):
    """Inverted dropout; identity at inference.  The mask is drawn on the
    input's device, from ``rng``, which must live there too."""

    def __init__(self, p: float, **kwargs):
        super().__init__(**kwargs)
        self.p = float(p)

    def call(self, params, x, training=False, rng=None):
        if not training or self.p <= 0.0:
            return x
        if rng is None:
            raise ValueError(
                f"dropout layer {self.name} needs an rng when training")
        keep = 1.0 - self.p
        mask = torch.rand(tuple(x.shape), generator=rng,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


class Flatten(Layer):
    def call(self, params, x, training=False, rng=None):
        return x.reshape(x.shape[0], -1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], int(np.prod(input_shape[1:])))


class Lambda(Layer):
    """Wrap an arbitrary tensor function as a layer."""

    def __init__(self, function, output_shape=None, **kwargs):
        super().__init__(**kwargs)
        self.function = function
        self._out_shape_fn = output_shape

    def call(self, params, x, training=False, rng=None):
        return self.function(x)

    def compute_output_shape(self, input_shape):
        if self._out_shape_fn is None:
            # probe with zeros on a concrete batch of 1
            def concretize(s):
                return tuple(1 if d is None else d for d in s)
            if isinstance(input_shape, list):
                probe = [torch.zeros(concretize(s)) for s in input_shape]
            else:
                probe = torch.zeros(concretize(input_shape))
            out = self.function(probe)
            return (None,) + tuple(out.shape[1:])
        if callable(self._out_shape_fn):
            return self._out_shape_fn(input_shape)
        return (input_shape[0] if not isinstance(input_shape, list)
                else input_shape[0][0],) + tuple(self._out_shape_fn)
