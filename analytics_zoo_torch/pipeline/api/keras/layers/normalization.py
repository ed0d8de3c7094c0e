"""LayerNorm (port of ``LayerNorm`` in
``pipeline/api/keras/layers/normalization.py``).

With ``activation="gelu"`` the normalisation and the activation run as
one fused LayerNorm→GeLU epilogue (``ops/fused.py``); other activations
take the plain path, as the reference's lax route.
"""

from __future__ import annotations

import torch

from analytics_zoo_torch.ops import activations as acts
from analytics_zoo_torch.pipeline.api.keras.engine import Layer, Params


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
