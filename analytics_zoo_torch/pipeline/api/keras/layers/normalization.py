"""BatchNormalization, LayerNorm, L2Normalization and NormalizeScale
(port of ``pipeline/api/keras/layers/normalization.py``).

BatchNormalization is the port's stateful layer: its moving statistics
live in the ``state`` collection and ``apply`` returns the new state
when training.  It follows the reference's arithmetic, not
``torch.nn.functional.batch_norm``'s (whose running variance is the
unbiased one and whose momentum weighs the batch, not the history):
float32 batch statistics from one pass (mean and mean of squares, the
biased variance clamped at 0), ``moving = m * moving + (1 - m) * batch``,
and mean, variance, gamma and beta folded into a float32 per-channel
scale and bias, applied as one multiply-add in the activation's dtype.

With ``activation="gelu"`` LayerNorm's normalisation and activation run
as one fused LayerNorm→GeLU epilogue (``ops/fused.py``); other
activations take the plain path, as the reference's lax route.
"""

from __future__ import annotations

import torch

from analytics_zoo_torch.ops import activations as acts
from analytics_zoo_torch.ops.dtypes import get_policy
from analytics_zoo_torch.pipeline.api.keras.engine import (
    Layer, Params, State,
)


class BatchNormalization(Layer):
    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 beta_init="zero", gamma_init="one", axis: int = -1,
                 scale: bool = True, center: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.epsilon = float(epsilon)
        self.momentum = float(momentum)
        self.axis = axis
        self.scale = scale
        self.center = center
        self.beta_init = beta_init
        self.gamma_init = gamma_init

    def _dim(self, input_shape):
        return input_shape[self.axis]

    def build(self, rng, input_shape) -> Params:
        d = self._dim(input_shape)
        params: Params = {}
        if self.scale:
            self.add_weight(params, rng, "gamma", (d,), init=self.gamma_init)
        if self.center:
            self.add_weight(params, rng, "beta", (d,), init=self.beta_init)
        return params

    def init_state(self, input_shape) -> State:
        d = self._dim(input_shape)
        dtype = get_policy().param_dtype
        return {"moving_mean": torch.zeros((d,), dtype=dtype),
                "moving_var": torch.ones((d,), dtype=dtype)}

    def apply(self, params, x, state=None, training=False, rng=None):
        ax = self.axis % x.ndim
        dims = tuple(i for i in range(x.ndim) if i != ax)
        bshape = [1] * x.ndim
        bshape[ax] = x.shape[ax]
        if training:
            xf = x.float()
            mean = xf.mean(dim=dims)
            var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean,
                              min=0.0)
            m = self.momentum
            # the moving statistics take no gradient: the reference's
            # state is an auxiliary output of its step
            with torch.no_grad():
                new_state = {
                    "moving_mean": m * state["moving_mean"] +
                    (1 - m) * mean,
                    "moving_var": m * state["moving_var"] + (1 - m) * var,
                }
        else:
            mean = state["moving_mean"]
            var = state["moving_var"]
            new_state = state
        inv = torch.rsqrt(var + self.epsilon)
        if self.scale:
            inv = inv * params["gamma"]
        bias = -mean * inv
        if self.center:
            bias = bias + params["beta"]
        y = x * inv.reshape(bshape).to(x.dtype) \
            + bias.reshape(bshape).to(x.dtype)
        return y, new_state


class LayerNorm(Layer):
    """Layer normalization over the last dim."""

    def __init__(self, epsilon: float = 1e-5, activation=None, **kwargs):
        super().__init__(**kwargs)
        self.epsilon = float(epsilon)
        self.activation = acts.get(activation)

    def build(self, rng, input_shape) -> Params:
        d = input_shape[-1]
        params: Params = {}
        self.add_weight(params, rng, "gamma", (d,), init="one")
        self.add_weight(params, rng, "beta", (d,), init="zero")
        return params

    def call(self, params, x, training=False, rng=None):
        if self.activation is acts.gelu:
            from analytics_zoo_torch.ops import fused
            if fused.fused_enabled():
                return fused.layernorm_act(
                    x, params["gamma"], params["beta"],
                    eps=self.epsilon, activation=self.activation)
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (x - mean) / torch.sqrt(var + self.epsilon)
        y = (y * params["gamma"] + params["beta"]).to(x.dtype)
        if self.activation is not None:
            y = self.activation(y)
        return y


def _l2_normalize(x, axis, epsilon):
    norm = torch.linalg.vector_norm(x, dim=axis, keepdim=True)
    return x / torch.clamp(norm, min=epsilon)


class L2Normalization(Layer):
    """Unit-L2 normalize along ``axis`` (the norm floored at
    ``epsilon``)."""

    def __init__(self, axis: int = -1, epsilon: float = 1e-12, **kwargs):
        super().__init__(**kwargs)
        self.axis = axis
        self.epsilon = epsilon

    def call(self, params, x, training=False, rng=None):
        return _l2_normalize(x, self.axis, self.epsilon)


class NormalizeScale(Layer):
    """Unit-L2 normalize along ``axis``, then multiply by a learned
    per-channel scale that starts at ``scale_init`` (the SSD conv4_3
    feature rescaler)."""

    def __init__(self, axis: int = -1, scale_init: float = 20.0,
                 epsilon: float = 1e-12, **kwargs):
        super().__init__(**kwargs)
        self.axis = int(axis)
        self.scale_init = float(scale_init)
        self.epsilon = float(epsilon)

    def build(self, rng, input_shape) -> Params:
        c = input_shape[self.axis]
        params: Params = {}
        s = self.scale_init
        self.add_weight(params, rng, "scale", (c,),
                        init=lambda gen, shape, dtype:
                        torch.full(shape, s, dtype=dtype))
        return params

    def call(self, params, x, training=False, rng=None):
        y = _l2_normalize(x, self.axis, self.epsilon)
        shape = [1] * x.ndim
        shape[self.axis] = -1
        return y * params["scale"].reshape(shape)
