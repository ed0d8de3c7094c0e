"""Flash-attention forward: the CUDA kernel and its plain version (port of
``ops/pallas_attention.py``).

``flash_attention(q, k, v, causal, scale)`` returns O for (B, H, T, D)
inputs.  For a CUDA tensor it launches ``csrc/flash_attention_fwd.cu``
(float32, head_dim 64 or 128), which also writes the per-row log-sum-exp
that the backward kernels of the training slice will read.  For a CPU
tensor, or under ``ops.fused=torch``, it takes ``flash_attention_ref``.

Forward only: serving needs no gradient.  A CUDA input that requires a
gradient raises rather than return a tensor with no gradient path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from analytics_zoo_torch.ops import kernels

KERNEL = "flash_attention_fwd"
HEAD_DIMS = (64, 128)


def flash_attention_ref(q, k, v, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense softmax attention in the kernel's order of operations.

    Returns O (B, H, T, D) in the input dtype and LSE (B*H, T, 1) float32,
    the layout of the reference kernel's outputs."""
    b, h, t, d = q.shape
    if scale is None:
        scale = d ** -0.5
    s = torch.matmul(q * scale, k.transpose(-1, -2)).float()
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril_()
        s = torch.where(keep, s, s.new_tensor(-1e30))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.matmul(p.to(v.dtype), v).float() / l_safe
    lse = (m + torch.log(l_safe)).reshape(b * h, t, 1)
    return o.to(q.dtype), lse


def kernel_supports(q: torch.Tensor) -> bool:
    """Whether the CUDA kernel takes this q (and same-shaped k, v)."""
    return (q.dtype == torch.float32 and q.dim() == 4 and
            q.shape[-1] in HEAD_DIMS)


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE) from the CUDA kernel; raises on inputs it does not take."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_fwd: q, k, v must be CUDA tensors")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError(
            "flash_attention: the CUDA kernel is forward-only (no backward "
            "yet); call it under torch.no_grad() or inference_mode()")
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"flash_attention_fwd: q, k, v must share one "
                         f"(B, H, T, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise ValueError("flash_attention_fwd: the kernel takes float32, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {q.shape[-1]} "
                         f"not in {HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_fwd: q, k, v on different devices")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, h, t, d = q.shape
    if scale is None:
        scale = d ** -0.5
    o = torch.empty_like(q)
    lse = torch.empty((b * h, t, 1), dtype=torch.float32, device=q.device)
    kernels.launch(KERNEL, q.device, q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), o.data_ptr(), lse.data_ptr(), b * h, t, d,
                   float(scale), int(causal))
    return o, lse


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q,k,v: (B, H, T, D) -> O (B, H, T, D)."""
    from analytics_zoo_torch.ops.fused import use_kernel
    if use_kernel(q):
        return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
    return flash_attention_ref(q, k, v, causal=causal, scale=scale)[0]
