"""Activation functions addressable by Keras-1 string names (port of
``ops/activations.py``).

``gelu`` is the tanh approximation written in the reference's own order
(``jax.nn.gelu(approximate=True)``), which the CUDA epilogue kernels
repeat; ``gelu_erf`` is the exact form.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_SQRT_HALF = math.sqrt(0.5)


def linear(x):
    return x


def relu(x):
    return torch.relu(x)


def relu6(x):
    return torch.clamp(torch.relu(x), max=6.0)


def tanh(x):
    return torch.tanh(x)


def sigmoid(x):
    return torch.sigmoid(x)


def hard_sigmoid(x):
    # Keras-1 definition: clip(0.2 * x + 0.5, 0, 1)
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def hard_sigmoid_torch(x):
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def hard_swish(x):
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def softmax(x):
    return torch.softmax(x, dim=-1)


def log_softmax(x):
    return torch.log_softmax(x, dim=-1)


def softplus(x):
    return F.softplus(x)


def softsign(x):
    return F.softsign(x)


def elu(x, alpha: float = 1.0):
    return F.elu(x, alpha)


def selu(x):
    return F.selu(x)


def gelu(x):
    """tanh-approximate GELU: ``x * 0.5 * (1 + tanh(c * (x + 0.044715 x³)))``."""
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))))
    return x * cdf


def gelu_erf(x):
    """Exact (erf-based) GELU."""
    return 0.5 * x * torch.erfc(-x * _SQRT_HALF)


def swish(x):
    return F.silu(x)


def exp(x):
    return torch.exp(x)


_REGISTRY = {
    "linear": linear, None: linear,
    "relu": relu,
    "relu6": relu6,
    "tanh": tanh,
    "sigmoid": sigmoid,
    "hard_sigmoid": hard_sigmoid,
    "hard_sigmoid_torch": hard_sigmoid_torch,
    "hard_swish": hard_swish,
    "hardswish": hard_swish,
    "softmax": softmax,
    "log_softmax": log_softmax,
    "softplus": softplus,
    "softsign": softsign,
    "elu": elu,
    "selu": selu,
    "gelu": gelu,
    "gelu_erf": gelu_erf,
    "swish": swish,
    "silu": swish,
    "exp": exp,
}


def get(activation) -> Optional[Callable]:
    """Resolve a name/callable; returns None for identity (no-op)."""
    if activation is None:
        return None
    if callable(activation):
        return activation
    name = str(activation).lower()
    if name == "linear":
        return None
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown activation: {activation!r}") from None
