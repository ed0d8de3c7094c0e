"""Attention primitives (port of ``ops/attention.py``).

``scaled_dot_product_attention`` is the dense single-device path: the
plain version of the flash kernel and the route for every shape or mask
the kernel does not take.  Masked logits are set to ``-1e30`` as in the
reference, not ``-inf``.  ``blockwise_attention_step`` is the
online-softmax step that ring attention (``parallel/ring_attention.py``)
runs on each key block it holds.
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


def blockwise_attention_step(q, k_blk, v_blk, acc, m, l, scale,
                             logits_bias=None):
    """One online-softmax accumulation step (the flash/ring inner loop).

    q: (B,H,Tq,D); k_blk/v_blk: (B,H,Tb,D);
    acc: (B,H,Tq,D) f32; m,l: (B,H,Tq) f32 running max / normalizer.
    Returns updated (acc, m, l).
    """
    s = torch.einsum("bhqd,bhkd->bhqk", q, k_blk).float() * scale
    if logits_bias is not None:
        s = s + logits_bias
    m_blk = torch.amax(s, dim=-1)
    m_new = torch.maximum(m, m_blk)
    # rescale the previous accumulation
    correction = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * correction + torch.sum(p, dim=-1)
    acc_new = acc * correction[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p.to(v_blk.dtype), v_blk).float()
    return acc_new, m_new, l_new
