"""Ring attention — sequence-parallel exact attention over the ``seq``
group (port of ``parallel/ring_attention.py``).

The sequence is split over the mesh's ``seq`` axis: each rank holds one
block of Q, K and V.  K/V blocks move one hop around the ring a step
(``batch_isend_irecv`` to the previous rank, from the next), while each
rank accumulates its queries' attention with the online-softmax
recurrence (``ops.attention.blockwise_attention_step``), the causal bias
built from global positions.  Memory stays O(T/n · T/n) a rank.

The reference differentiates its ``ppermute`` loop with ``jax.grad``; the
port's backward is written out: it rotates K, V and the dK/dV
accumulators together around the same ring, so after ``n`` hops each
rank holds the gradient of its own K/V block, summed over every query
block.  The reference runs no Pallas kernel here, and the port no CUDA
kernel: the steps are plain products.
"""

from __future__ import annotations

from typing import Optional

import torch

from analytics_zoo_torch.ops.attention import (
    blockwise_attention_step, scaled_dot_product_attention,
)
from analytics_zoo_torch.parallel import comm
from analytics_zoo_torch.parallel.mesh import SEQ_AXIS, current_mesh


def _bias(causal: bool, me: int, src: int, t_blk: int, device):
    """The causal bias of query block ``me`` against key block ``src``
    (global positions), or None."""
    if not causal:
        return None
    q_pos = me * t_blk + torch.arange(t_blk, device=device)[:, None]
    k_pos = src * t_blk + torch.arange(t_blk, device=device)[None, :]
    return torch.where(q_pos >= k_pos, 0.0, -1e30).float()


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        n, me = comm.group_size(group), comm.group_rank(group)
        b, h, t_blk, d = q.shape
        acc = torch.zeros((b, h, t_blk, d), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, h, t_blk), -float("inf"), dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, t_blk), dtype=torch.float32, device=q.device)
        k_cur, v_cur = k, v
        for i in range(n):
            # the block held at step i came from rank (me + i) % n
            src = (me + i) % n
            acc, m, l = blockwise_attention_step(
                q, k_cur, v_cur, acc, m, l, scale,
                logits_bias=_bias(causal, me, src, t_blk, q.device))
            if i < n - 1:
                k_cur = comm._ppermute(k_cur, group, -1)
                v_cur = comm._ppermute(v_cur, group, -1)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        lse = m + torch.log(l)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n, me = comm.group_size(group), comm.group_rank(group)
        t_blk = q.shape[2]
        qf, do = q.float(), dout.float()
        delta = (do * out).sum(-1)
        dq = torch.zeros_like(qf)
        dk = torch.zeros_like(k, dtype=torch.float32)
        dv = torch.zeros_like(v, dtype=torch.float32)
        k_cur, v_cur = k, v
        for i in range(n):
            src = (me + i) % n
            kf, vf = k_cur.float(), v_cur.float()
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
            bias = _bias(causal, me, src, t_blk, q.device)
            if bias is not None:
                s = s + bias
            p = torch.exp(s - lse[..., None])
            dv = dv + torch.einsum("bhqk,bhqd->bhkd", p, do)
            dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
            dk = dk + torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
            # the accumulators travel with their block: after n hops
            # each rank holds its own block's
            dk = comm._ppermute(dk, group, -1)
            dv = comm._ppermute(dv, group, -1)
            if i < n - 1:
                k_cur = comm._ppermute(k_cur, group, -1)
                v_cur = comm._ppermute(v_cur, group, -1)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention(q, k, v, mesh=None, causal: bool = False,
                   scale: Optional[float] = None,
                   axis_name: str = SEQ_AXIS):
    """Exact attention over a sequence split on ``axis_name``.

    q, k, v: this rank's (B, H, T/n, D) blocks (block ``i`` is positions
    ``[i T/n, (i+1) T/n)``); returns this rank's block of the output.
    With an axis of size 1 it is dense attention."""
    mesh = mesh if mesh is not None else current_mesh()
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if mesh.size(axis_name) == 1:
        return scaled_dot_product_attention(q, k, v, causal=causal,
                                            scale=scale)
    return _Ring.apply(q, k, v, mesh.group(axis_name), causal, float(scale))
