"""Attention primitives (port of ``ops/attention.py``).

``scaled_dot_product_attention`` is the dense single-device path: the
plain version of the flash kernel and the route for every shape or mask
the kernel does not take.  Masked logits are set to ``-1e30`` as in the
reference, not ``-inf``.
"""

from __future__ import annotations

from typing import Optional

import torch


def scaled_dot_product_attention(q, k, v, mask=None, causal: bool = False,
                                 scale: Optional[float] = None):
    """q,k,v: (B, H, T, D). mask: broadcastable to (B, H, Tq, Tk), 1=keep.

    Softmax statistics are computed in f32 even for bf16 inputs.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        keep = (torch.arange(tq, device=q.device)[:, None] >=
                torch.arange(tk, device=q.device)[None, :])
        logits = logits.masked_fill(~keep, -1e30)
    if mask is not None:
        logits = logits.masked_fill(~mask.to(torch.bool), -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)
