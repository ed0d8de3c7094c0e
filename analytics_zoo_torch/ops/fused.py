"""Epilogue kernels: bias-add→GeLU and LayerNorm→activation (port of the
epilogue half of ``ops/fused.py``), and the suite's mode key.

Each function has a CUDA kernel (``csrc/bias_gelu.cu``,
``csrc/layernorm_act.cu``) and a plain PyTorch version beside it.  The
fused optimizer half of the reference module comes with the training
slice.

Mode selection (``ops.fused`` config key):

* ``auto`` (default) — the CUDA kernel for CUDA tensors, the plain
  version for CPU tensors.
* ``torch`` — the plain versions everywhere (the reference's ``lax``).
* ``off`` — the suite is off; call sites take their unfused forms.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from analytics_zoo_torch.ops import activations as acts
from analytics_zoo_torch.ops import kernels

MODES = ("auto", "torch", "off")


def _mode() -> str:
    from analytics_zoo_torch.common.config import get_config
    m = str(get_config().get("ops.fused", "auto") or "auto").lower()
    if m not in MODES:
        raise ValueError(f"ops.fused={m!r}; the port takes one of {MODES}")
    return m


def fused_enabled() -> bool:
    """Whether the fused call sites should fire at all."""
    return _mode() != "off"


def use_kernel(x: torch.Tensor) -> bool:
    """Kernel or plain version for this tensor: the kernel exactly when
    the tensor lies on the card and the mode is ``auto``."""
    return x.is_cuda and _mode() == "auto"


def _check_cuda_f32(kernel: str, **tensors) -> None:
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{kernel}: {name} must be a CUDA tensor")
        if t.dtype != torch.float32:
            raise ValueError(f"{kernel}: the kernel takes float32, "
                             f"{name} is {t.dtype}")
        if t.requires_grad:
            raise RuntimeError(f"{kernel}: the CUDA kernel is forward-only; "
                               "call it under torch.no_grad()")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: inputs on different devices {devices}")


# ------------------------------------------------------------- bias→GeLU
def bias_gelu_ref(x, bias):
    """Plain version: ``gelu_tanh(x + bias)``."""
    return acts.gelu(x + bias)


def bias_gelu_kernel(x, bias):
    """``gelu_tanh(x + bias)`` by the CUDA kernel; x (..., d), bias (d,)."""
    name = "bias_gelu"
    _check_cuda_f32(name, x=x, bias=bias)
    d = x.shape[-1]
    if bias.shape != (d,):
        raise ValueError(f"{name}: bias shape {tuple(bias.shape)} != ({d},)")
    x, bias = x.contiguous(), bias.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    kernels.launch(name, x.device, x.data_ptr(), bias.data_ptr(),
                   out.data_ptr(), rows, d)
    return out


def bias_gelu(x, bias):
    """Fused bias-add→GeLU epilogue (the dense/FFN tail)."""
    if use_kernel(x):
        return bias_gelu_kernel(x, bias)
    return bias_gelu_ref(x, bias)


# --------------------------------------------------------- LayerNorm→act
KERNEL_ACTIVATIONS = {None: 0, acts.gelu: 1}


def layernorm_act_ref(x, gamma, beta, eps: float = 1e-5,
                      activation: Optional[Callable] = None):
    """Plain version, in the reference's lax order: biased variance,
    ``(x - mean) / sqrt(var + eps) * gamma + beta``, cast, activation."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    y = (y * gamma + beta).to(x.dtype)
    if activation is not None:
        y = activation(y)
    return y


def layernorm_act_kernel(x, gamma, beta, eps: float = 1e-5,
                         activation: Optional[Callable] = None):
    """LayerNorm→activation by the CUDA kernel; activation None or gelu."""
    name = "layernorm_act"
    _check_cuda_f32(name, x=x, gamma=gamma, beta=beta)
    if activation not in KERNEL_ACTIVATIONS:
        raise ValueError(f"{name}: the kernel applies no activation or "
                         f"tanh-GeLU, not {activation}")
    d = x.shape[-1]
    if gamma.shape != (d,) or beta.shape != (d,):
        raise ValueError(f"{name}: gamma/beta must be ({d},), got "
                         f"{tuple(gamma.shape)}, {tuple(beta.shape)}")
    x, gamma, beta = x.contiguous(), gamma.contiguous(), beta.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    kernels.launch(name, x.device, x.data_ptr(), gamma.data_ptr(),
                   beta.data_ptr(), out.data_ptr(), rows, d, float(eps),
                   KERNEL_ACTIVATIONS[activation])
    return out


def layernorm_act(x, gamma, beta, eps: float = 1e-5,
                  activation: Optional[Callable] = None):
    """Fused LayerNorm→activation."""
    if use_kernel(x):
        return layernorm_act_kernel(x, gamma, beta, eps=eps,
                                    activation=activation)
    return layernorm_act_ref(x, gamma, beta, eps=eps, activation=activation)
