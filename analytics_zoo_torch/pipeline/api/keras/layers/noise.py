"""Noise and structured-dropout layers (port of
``pipeline/api/keras/layers/noise.py``; ref
zoo/pipeline/api/keras/layers/Noise.scala — GaussianNoise,
GaussianDropout; Dropout.scala SpatialDropout1D/2D/3D).

Each is the identity in eval (and at p = 0), and in training draws on the
input's device from the ``torch.Generator`` it is given, which must live
there.  ``torch.Generator`` cannot reproduce ``jax.random``'s bits, so
the two packages agree on the training path in distribution only: the
same mask shape, keep rate and noise spread.
"""

from __future__ import annotations

import torch

from analytics_zoo_torch.pipeline.api.keras.engine import Layer


def _need_rng(layer, rng):
    if rng is None:
        raise ValueError(f"layer {layer.name} needs an rng when training")
    return rng


def _normal(rng, x):
    return torch.randn(tuple(x.shape), generator=rng, device=x.device,
                       dtype=x.dtype)


class GaussianNoise(Layer):
    """Adds N(0, sigma^2) noise in training."""

    def __init__(self, sigma: float, **kwargs):
        super().__init__(**kwargs)
        self.sigma = float(sigma)

    def call(self, params, x, training=False, rng=None):
        if not training:
            return x
        return x + self.sigma * _normal(_need_rng(self, rng), x)


class GaussianDropout(Layer):
    """Multiplies by N(1, p / (1 - p)) noise in training."""

    def __init__(self, p: float, **kwargs):
        super().__init__(**kwargs)
        self.p = float(p)

    def call(self, params, x, training=False, rng=None):
        if not training or self.p <= 0:
            return x
        stddev = (self.p / (1.0 - self.p)) ** 0.5
        return x * (1.0 + stddev * _normal(_need_rng(self, rng), x))


class _SpatialDropout(Layer):
    """Inverted dropout of whole channels: one keep draw per (example,
    channel), broadcast over the spatial axes of a channels-last input."""
    spatial = 1

    def __init__(self, p: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.p = float(p)

    def call(self, params, x, training=False, rng=None):
        if not training or self.p <= 0:
            return x
        rng = _need_rng(self, rng)
        mshape = (x.shape[0],) + (1,) * self.spatial + (x.shape[-1],)
        keep = 1.0 - self.p
        mask = torch.rand(mshape, generator=rng, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


class SpatialDropout1D(_SpatialDropout):
    spatial = 1


class SpatialDropout2D(_SpatialDropout):
    spatial = 2


class SpatialDropout3D(_SpatialDropout):
    spatial = 3
