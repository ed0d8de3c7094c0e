"""Parametric and advanced activation layers (port of
``pipeline/api/keras/layers/advanced_activations.py``; ref
zoo/pipeline/api/keras/layers/AdvancedActivation.scala — LeakyReLU, ELU,
PReLU, SReLU, ThresholdedReLU, Softmax).  PReLU's and SReLU's learned
parameters are per channel, over the last dim."""

from __future__ import annotations

import torch

from analytics_zoo_torch.pipeline.api.keras.engine import Layer, Params


class LeakyReLU(Layer):
    def __init__(self, alpha: float = 0.3, **kwargs):
        super().__init__(**kwargs)
        self.alpha = float(alpha)

    def call(self, params, x, training=False, rng=None):
        return torch.where(x >= 0, x, self.alpha * x)


class ELU(Layer):
    def __init__(self, alpha: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.alpha = float(alpha)

    def call(self, params, x, training=False, rng=None):
        # as jax.nn.elu: expm1 of the negative part only, so that no
        # overflowed branch reaches the gradient
        neg = torch.where(x > 0, torch.zeros_like(x), x)
        return torch.where(x > 0, x, self.alpha * torch.expm1(neg))


class ThresholdedReLU(Layer):
    def __init__(self, theta: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.theta = float(theta)

    def call(self, params, x, training=False, rng=None):
        return torch.where(x > self.theta, x, torch.zeros_like(x))


class PReLU(Layer):
    """Per-channel learnable negative slope."""

    def build(self, rng, input_shape) -> Params:
        params: Params = {}
        self.add_weight(params, rng, "alpha", (input_shape[-1],),
                        init="zero")
        return params

    def call(self, params, x, training=False, rng=None):
        return torch.where(x >= 0, x, params["alpha"] * x)


class SReLU(Layer):
    """S-shaped ReLU with four learnable per-channel params: linear with
    slope ``a_left`` below ``t_left``, ``a_right`` above ``t_right``, the
    identity between."""

    def build(self, rng, input_shape) -> Params:
        d = (input_shape[-1],)
        params: Params = {}
        self.add_weight(params, rng, "t_left", d, init="zero")
        self.add_weight(params, rng, "a_left", d, init="glorot_uniform")
        self.add_weight(params, rng, "t_right", d, init="glorot_uniform")
        self.add_weight(params, rng, "a_right", d, init="one")
        return params

    def call(self, params, x, training=False, rng=None):
        tl, al = params["t_left"], params["a_left"]
        tr, ar = params["t_right"], params["a_right"]
        y_left = tl + al * (x - tl)
        y_right = tr + ar * (x - tr)
        return torch.where(x <= tl, y_left,
                           torch.where(x >= tr, y_right, x))


class Softmax(Layer):
    def call(self, params, x, training=False, rng=None):
        return torch.softmax(x, dim=-1)
