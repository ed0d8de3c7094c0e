"""Weight initializers, addressable by Keras-1 string names (port of
``ops/initializers.py``).

Each takes an explicit ``torch.Generator`` and draws on the CPU; the
caller moves the result to its device.  The draws differ from the
reference's ``jax.random`` bits for the same seed; weights meant to match
the reference are carried over with ``interop.load_jax_variables``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


def _fans(shape: Sequence[int]):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels (spatial..., in, out)
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def _uniform(gen, shape, dtype, lo, hi):
    return torch.rand(tuple(shape), generator=gen, dtype=torch.float32) \
        .mul_(hi - lo).add_(lo).to(dtype)


def _normal(gen, shape, dtype, stddev):
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32) \
        .mul_(stddev).to(dtype)


def zero(gen, shape, dtype=torch.float32):
    return torch.zeros(tuple(shape), dtype=dtype)


def one(gen, shape, dtype=torch.float32):
    return torch.ones(tuple(shape), dtype=dtype)


def uniform(gen, shape, dtype=torch.float32, scale=0.05):
    return _uniform(gen, shape, dtype, -scale, scale)


def normal(gen, shape, dtype=torch.float32, stddev=0.05):
    return _normal(gen, shape, dtype, stddev)


def glorot_uniform(gen, shape, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(gen, shape, dtype, -limit, limit)


def glorot_normal(gen, shape, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    return _normal(gen, shape, dtype, math.sqrt(2.0 / (fan_in + fan_out)))


def he_normal(gen, shape, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    return _normal(gen, shape, dtype, math.sqrt(2.0 / fan_in))


def he_uniform(gen, shape, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    limit = math.sqrt(6.0 / fan_in)
    return _uniform(gen, shape, dtype, -limit, limit)


def lecun_uniform(gen, shape, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    limit = math.sqrt(3.0 / fan_in)
    return _uniform(gen, shape, dtype, -limit, limit)


def orthogonal(gen, shape, dtype=torch.float32, gain=1.0):
    if len(shape) < 2:
        return normal(gen, shape, dtype)
    rows = math.prod(shape[:-1])
    cols = shape[-1]
    flat = torch.randn((max(rows, cols), min(rows, cols)), generator=gen)
    q, r = torch.linalg.qr(flat)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return (gain * q[:rows, :cols]).reshape(tuple(shape)).to(dtype)


_REGISTRY: dict = {
    "zero": zero, "zeros": zero,
    "one": one, "ones": one,
    "uniform": uniform,
    "normal": normal, "gaussian": normal,
    "glorot_uniform": glorot_uniform, "xavier": glorot_uniform,
    "glorot_normal": glorot_normal,
    "he_normal": he_normal, "msra": he_normal,
    "he_uniform": he_uniform,
    "lecun_uniform": lecun_uniform,
    "orthogonal": orthogonal,
}


def get(init) -> Callable:
    """Resolve a string name or callable to an initializer function."""
    if callable(init):
        return init
    try:
        return _REGISTRY[str(init)]
    except KeyError:
        raise ValueError(f"unknown initializer: {init!r}") from None
