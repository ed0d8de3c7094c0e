"""Core layers: the Dense family (Dense, Highway, MaxoutDense,
SparseDense), Activation, Dropout and the shape layers Flatten, Reshape,
Permute, RepeatVector, Masking and Lambda (port of
``pipeline/api/keras/layers/core.py``).

Dense rounds its operands to the compute dtype and takes a float32
result (``ops.dtypes.matmul``), or, when its params carry
``kernel_scale``/``act_scale``, runs the int8 product
(``ops.quant.quantized_matmul``); with a bias and the tanh-GeLU
activation its tail goes through the fused bias→GeLU epilogue either
way.  Highway, MaxoutDense and SparseDense take the float route of the
same product.  SparseDense keeps the reference's contract: its input is
a dense, mostly-zero array, not a ``torch.sparse`` tensor.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from analytics_zoo_torch.ops import activations as acts
from analytics_zoo_torch.ops.dtypes import get_policy
from analytics_zoo_torch.ops.dtypes import matmul as _matmul
from analytics_zoo_torch.pipeline.api.keras.engine import Layer, Params


class Dense(Layer):
    """Fully-connected layer; the contraction is over the last dim, so the
    input may have rank > 2."""

    def __init__(self, output_dim: int, init="glorot_uniform",
                 activation=None, W_regularizer=None, b_regularizer=None,
                 bias: bool = True, parallel_mode: Optional[str] = None,
                 **kwargs):
        super().__init__(**kwargs)
        if parallel_mode is not None:
            raise NotImplementedError(
                "Dense(parallel_mode=...): tensor parallelism comes with "
                "the multi-GPU slice of the port (ROADMAP.md)")
        self.output_dim = int(output_dim)
        self.kernel_init = init
        self.activation = acts.get(activation)
        self.use_bias = bias
        self.W_regularizer = W_regularizer
        self.b_regularizer = b_regularizer

    def build(self, rng, input_shape) -> Params:
        in_dim = input_shape[-1]
        params: Params = {}
        self.add_weight(params, rng, "kernel", (in_dim, self.output_dim),
                        init=self.kernel_init, regularizer=self.W_regularizer)
        if self.use_bias:
            self.add_weight(params, rng, "bias", (self.output_dim,),
                            init="zero", regularizer=self.b_regularizer)
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


class Reshape(Layer):
    """Reshape the non-batch dims; one -1 is inferred."""

    def __init__(self, target_shape: Sequence[int], **kwargs):
        super().__init__(**kwargs)
        self.target_shape = tuple(int(d) for d in target_shape)

    def _resolve(self, input_shape):
        n = int(np.prod(input_shape[1:]))
        tgt = list(self.target_shape)
        if -1 in tgt:
            i = tgt.index(-1)
            known = int(np.prod([d for d in tgt if d != -1]))
            tgt[i] = n // known
        return tuple(tgt)

    def call(self, params, x, training=False, rng=None):
        return x.reshape((x.shape[0],) +
                         self._resolve((None,) + tuple(x.shape[1:])))

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + self._resolve(input_shape)


class Permute(Layer):
    """Permute the non-batch dims; ``dims`` are 1-indexed as in Keras."""

    def __init__(self, dims: Sequence[int], **kwargs):
        super().__init__(**kwargs)
        self.dims = tuple(int(d) for d in dims)

    def call(self, params, x, training=False, rng=None):
        return x.permute((0,) + self.dims)

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + tuple(
            input_shape[d] for d in self.dims)


class RepeatVector(Layer):
    """(B, F) -> (B, n, F)."""

    def __init__(self, n: int, **kwargs):
        super().__init__(**kwargs)
        self.n = int(n)

    def call(self, params, x, training=False, rng=None):
        return x.unsqueeze(1).repeat(1, self.n, 1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self.n, input_shape[1])


class Masking(Layer):
    """Zero the timesteps whose every feature equals ``mask_value``."""

    def __init__(self, mask_value: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.mask_value = float(mask_value)

    def call(self, params, x, training=False, rng=None):
        keep = (x != self.mask_value).any(dim=-1, keepdim=True)
        return torch.where(keep, x, torch.zeros_like(x))


class Highway(Layer):
    """Highway layer: ``t * h(x) + (1 - t) * x`` with the transform gate
    ``t = sigmoid(x @ gate_kernel + gate_bias)``; the gate bias starts at
    -2 (mostly carrying the input through)."""

    def __init__(self, activation="tanh", bias: bool = True,
                 W_regularizer=None, b_regularizer=None, **kwargs):
        super().__init__(**kwargs)
        self.activation = acts.get(activation) or (lambda v: v)
        self.use_bias = bias
        self.W_regularizer = W_regularizer
        self.b_regularizer = b_regularizer

    def build(self, rng, input_shape) -> Params:
        d = input_shape[-1]
        params: Params = {}
        self.add_weight(params, rng, "kernel", (d, d),
                        regularizer=self.W_regularizer)
        self.add_weight(params, rng, "gate_kernel", (d, d),
                        regularizer=self.W_regularizer)
        if self.use_bias:
            self.add_weight(params, rng, "bias", (d,), init="zero",
                            regularizer=self.b_regularizer)
            params["gate_bias"] = torch.full(
                (d,), -2.0, dtype=get_policy().param_dtype)
        return params

    def call(self, params, x, training=False, rng=None):
        h = _matmul(x, params["kernel"])
        t = _matmul(x, params["gate_kernel"])
        if self.use_bias:
            h = h + params["bias"]
            t = t + params["gate_bias"]
        h = self.activation(h)
        t = torch.sigmoid(t)
        return t * h + (1.0 - t) * x


class MaxoutDense(Layer):
    """Dense with a max over ``nb_feature`` linear pieces."""

    def __init__(self, output_dim: int, nb_feature: int = 4,
                 W_regularizer=None, b_regularizer=None, bias: bool = True,
                 **kwargs):
        super().__init__(**kwargs)
        self.output_dim = int(output_dim)
        self.nb_feature = int(nb_feature)
        self.use_bias = bias
        self.W_regularizer = W_regularizer
        self.b_regularizer = b_regularizer

    def build(self, rng, input_shape) -> Params:
        d = input_shape[-1]
        params: Params = {}
        self.add_weight(params, rng, "kernel",
                        (d, self.nb_feature * self.output_dim),
                        regularizer=self.W_regularizer)
        if self.use_bias:
            self.add_weight(params, rng, "bias",
                            (self.nb_feature * self.output_dim,),
                            init="zero", regularizer=self.b_regularizer)
        return params

    def call(self, params, x, training=False, rng=None):
        y = _matmul(x, params["kernel"])
        if self.use_bias:
            y = y + params["bias"]
        y = y.reshape(tuple(y.shape[:-1]) +
                      (self.nb_feature, self.output_dim))
        return y.amax(dim=-2)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


class SparseDense(Layer):
    """Dense over a dense, mostly-zero input (the reference's contract;
    no ``torch.sparse``)."""

    def __init__(self, output_dim: int, init="glorot_uniform",
                 activation=None, bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.output_dim = int(output_dim)
        self.kernel_init = init
        self.activation = acts.get(activation)
        self.use_bias = bias

    def build(self, rng, input_shape) -> Params:
        d = input_shape[-1]
        params: Params = {}
        self.add_weight(params, rng, "kernel", (d, self.output_dim),
                        init=self.kernel_init)
        if self.use_bias:
            self.add_weight(params, rng, "bias", (self.output_dim,),
                            init="zero")
        return params

    def call(self, params, x, training=False, rng=None):
        y = _matmul(x, params["kernel"])
        if self.use_bias:
            y = y + params["bias"]
        if self.activation is not None:
            y = self.activation(y)
        return y

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


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
