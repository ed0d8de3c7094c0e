"""Explicit collectives over the mesh's process groups, and their
differentiable forms.

The reference never writes a collective: GSPMD derives every one from
the sharding annotations, and ``jax.grad`` transposes them.  The port
calls them where the reference's partitioner would put them, so each
autograd rule below says what the transpose is:

- ``copy_to_group``     — identity forward, all-reduce backward: a tensor
  every rank of the group holds whole enters a computation that each
  rank does on its own part (Megatron's *f*);
- ``reduce_from_group`` — all-reduce forward, identity backward: the
  parts' partial results are summed, and what follows is computed alike
  on every rank (Megatron's *g*);
- ``gather_from_group`` — all-gather forward, this rank's slice of the
  gradient backward (what follows is computed alike on every rank);
- ``sum_across_group``  — all-reduce forward and backward: ranks that
  each compute a loss of their own share a sum (BatchNormalization's
  global statistics);
- ``ppermute``          — send to the next rank of the group and receive
  from the previous one; the backward sends the gradient the other way
  (the ring of ring attention, the pipeline's baton);
- ``all_to_all``        — chunk ``i`` of dim 0 to rank ``i``; the
  backward is the same exchange of the gradients (MoE's token exchange).

Backends.  NCCL takes CUDA tensors for all of them.  Gloo takes CPU
tensors for all of them and CUDA tensors for all-reduce and broadcast
only; for the others a CUDA tensor is staged through host memory.  That
staging serves only the rehearsal of several ranks on one card (which
NCCL refuses): such ranks join a gloo group themselves
(``zoo_context.init_process_group(..., backend="gloo")``) before
``init_zoo_context``.  A group the context forms on CUDA is NCCL's and
never stages.  ``COLLECTIVE_LOG`` records, for each op run, whether it ran on device
tensors (``"device"``) or was staged (``"host"``), so a run on one card
can say which collectives it carried there.
"""

from __future__ import annotations

from typing import Dict, List, Set

import torch
import torch.distributed as dist

#: op -> {"device", "host"}: where each collective this process ran
#: moved its data
COLLECTIVE_LOG: Dict[str, Set[str]] = {}

# the ops gloo carries on CUDA tensors
_GLOO_CUDA_OPS = ("all_reduce", "broadcast")


def reset_collective_log() -> None:
    COLLECTIVE_LOG.clear()


def _staged(op: str, t: torch.Tensor, group) -> bool:
    """Whether ``op`` on ``t`` goes through host memory (gloo, a CUDA
    tensor, an op gloo does not take on CUDA), logged either way."""
    staged = (t.is_cuda and dist.get_backend(group) == "gloo" and
              op not in _GLOO_CUDA_OPS)
    COLLECTIVE_LOG.setdefault(op, set()).add(
        "host" if staged or not t.is_cuda else "device")
    return staged


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


# ------------------------------------------------------------ plain ops
def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the group (a new tensor)."""
    out = t.detach().clone().contiguous()
    if group is None:
        return out
    _staged("all_reduce", out, group)
    dist.all_reduce(out, group=group)
    return out


def all_gather_list(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every group rank's ``t`` (same shape on each), in group order."""
    n = group_size(group)
    if n == 1:
        return [t]
    x = t.detach().contiguous()
    dev = x.device
    if _staged("all_gather", x, group):
        x = x.cpu()
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.reshape(-1), group=group)
    return list(out.to(dev).view((n,) + tuple(x.shape)).unbind(0))


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return torch.cat(all_gather_list(t, group), dim=dim)


def reduce_scatter_sum(t: torch.Tensor, group, dim: int = 0
                       ) -> torch.Tensor:
    """Piece ``group_rank`` of ``n`` along ``dim`` of the group's sum of
    ``t``."""
    n = group_size(group)
    if n == 1:
        return t.detach().clone()
    x = t.detach().movedim(dim, 0).contiguous()
    dev = x.device
    if _staged("reduce_scatter", x, group):
        x = x.cpu()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.to(dev).movedim(0, dim)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.detach().contiguous()
    dev = x.device
    if _staged("all_to_all", x, group):
        x = x.cpu()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out.to(dev)


def _ppermute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = group_size(group)
    me = group_rank(group)
    x = x.detach().contiguous()
    dev = x.device
    if _staged("send_recv", x, group):
        x = x.cpu()
    out = torch.empty_like(x)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    ops = [dist.P2POp(dist.isend, x, dst, group=group),
           dist.P2POp(dist.irecv, out, src, group=group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out.to(dev)


# ------------------------------------------------------ autograd forms
class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumAcrossGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, blocks):
        from analytics_zoo_torch.parallel.mesh import unpiece
        ctx.group, ctx.dim, ctx.blocks = group, dim, blocks
        return unpiece(all_gather_list(x, group), dim, blocks)

    @staticmethod
    def backward(ctx, g):
        from analytics_zoo_torch.parallel.mesh import piece
        return (piece(g, ctx.dim, ctx.blocks, group_size(ctx.group),
                      group_rank(ctx.group)).contiguous(),
                None, None, None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ppermute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.group, -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def sum_across_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumAcrossGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int,
                      blocks: int = 1) -> torch.Tensor:
    dim = dim % x.ndim
    return x if group is None else _GatherFromGroup.apply(x, group, dim,
                                                          blocks)


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Group rank i's ``x`` lands on rank ``(i + shift) % n``."""
    return x if group is None else _PPermute.apply(x, group, shift)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 of ``x`` holds ``n`` chunks; chunk j goes to group rank j,
    and chunk i of the result came from rank i."""
    return x if group is None else _AllToAll.apply(x, group)


def local_part(x: torch.Tensor, group, dim: int, blocks: int = 1
               ) -> torch.Tensor:
    """This group rank's piece of a tensor every rank holds whole."""
    if group is None:
        return x
    from analytics_zoo_torch.parallel.mesh import piece
    return piece(x, dim % x.ndim, blocks, group_size(group),
                 group_rank(group))


def barrier(group=None) -> None:
    if dist.is_available() and dist.is_initialized():
        dist.barrier(group=group)
