"""Flash attention, forward and backward: the CUDA kernels and their plain
versions (port of ``ops/pallas_attention.py``).

``flash_attention(q, k, v, causal, scale)`` returns O for (B, H, T, D)
inputs and is differentiable.  ``takes_kernels`` routes it: for CUDA
tensors under ``ops.fused=auto`` whose q, k and v share one dtype the
kernels take and one shape with a head_dim the kernels of that dtype take
(``HEAD_DIMS``: 64, 128, 192 and 256 for bfloat16; those and every
multiple of 64 from 320 to 2048 for float32), it launches the forward,
which also writes the per-row log-sum-exp; the backward recomputes the
probabilities from it: one kernel for dQ, one for dK/dV, as the
reference's ``custom_vjp`` runs two Pallas kernels.  ``kernel_names``
says which kernels take an input: at head_dim 64 to 256
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu`` for
float32, ``csrc/flash_attention_fwd_bf16.cu`` and
``csrc/flash_attention_bwd_bf16.cu`` for bfloat16 (``KERNELS``); float32
past 256 ``csrc/flash_attention_wide.cu`` (the forward) and
``csrc/flash_attention_wide_bwd.cu`` (dQ and dK/dV) (``WIDE_KERNELS``,
head_dim taken at run time, each block a share of the output's columns;
the backward's column blocks of a row tile form one cluster, which takes
the scores once and sums its blocks' partials in distributed shared
memory).  Each
kernel has a launch count of its own.  The float32 kernels take their
products on the tensor cores in split TF32, on the tile code of
``csrc/flash_tile.cuh`` (about float32's accuracy); the bfloat16 kernels
take bf16 products where both operands are bf16 values and three bf16
products where one is float32, on ``wgmma`` (``csrc/wgmma_tile.cuh``).
``delta = rowsum(dO * O)`` is a PyTorch op between them, as the reference
leaves it to XLA.  Every other input (a CPU tensor, ``ops.fused=torch``,
float16, any other head_dim) takes the plain versions,
``flash_attention_ref`` and ``flash_attention_bwd_ref``, which follow the
reference's order of operations in every dtype and judge the kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from analytics_zoo_torch.ops import kernels

# the head_dims of flash_attention_wide.cu and flash_attention_wide_bwd.cu,
# float32 only
WIDE_HEAD_DIMS = tuple(range(320, 2049, 64))
# the head_dims each dtype's kernels take
HEAD_DIMS = {torch.float32: (64, 128, 192, 256) + WIDE_HEAD_DIMS,
             torch.bfloat16: (64, 128, 192, 256)}
# the kernels' names by input dtype at head_dim 64 to 256: (forward, dQ,
# dK/dV)
KERNELS = {
    torch.float32: ("flash_attention_fwd", "flash_attention_dq",
                    "flash_attention_dkv"),
    torch.bfloat16: ("flash_attention_fwd_bf16", "flash_attention_dq_bf16",
                     "flash_attention_dkv_bf16"),
}
# the same three at WIDE_HEAD_DIMS
WIDE_KERNELS = ("flash_attention_fwd_wide", "flash_attention_dq_wide",
                "flash_attention_dkv_wide")


def kernel_names(dtype: torch.dtype, head_dim: int) -> Tuple[str, str, str]:
    """The kernels (forward, dQ, dK/dV) that take q, k, v of ``dtype`` at
    ``head_dim``; ``head_dim`` must be in ``HEAD_DIMS[dtype]``."""
    return WIDE_KERNELS if head_dim in WIDE_HEAD_DIMS else KERNELS[dtype]


def _widths(dtype: torch.dtype) -> str:
    dims = HEAD_DIMS.get(dtype, ())
    narrow = [d for d in dims if d not in WIDE_HEAD_DIMS]
    text = ", ".join(map(str, narrow))
    if len(narrow) < len(dims):
        text += (f" and {WIDE_HEAD_DIMS[0]} to {WIDE_HEAD_DIMS[-1]} in steps "
                 f"of 64")
    return text


def _causal_keep(t: int, device) -> torch.Tensor:
    return torch.ones(t, t, dtype=torch.bool, device=device).tril_()


def q_scale(scale: float, dtype: torch.dtype) -> float:
    """The scale as the reference multiplies q by it.  A Python float is
    weakly typed in JAX, so ``q * scale`` is taken in q's dtype: for bf16
    (or float16) the scale is rounded to that dtype first."""
    if dtype == torch.float32:
        return scale
    return float(torch.tensor(scale, dtype=dtype))


def _scaled_q(q, scale):
    """``q * scale`` in q's dtype, as the reference takes it.  Below
    float32 the product of two such values is exact in float32 and is
    rounded once, to nearest even."""
    if q.dtype == torch.float32:
        return q * scale
    return (q.float() * q_scale(scale, q.dtype)).to(q.dtype)


def flash_attention_ref(q, k, v, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense softmax attention in the kernel's order of operations: S in
    float32 from ``q * scale`` (in q's dtype) and K, P rounded to v's
    dtype before P V, a float32 product, and O rounded to q's dtype from
    ``acc / max(l, 1e-30)``.

    Returns O (B, H, T, D) in the input dtype and LSE (B*H, T, 1) float32,
    the layout of the reference kernel's outputs."""
    b, h, t, d = q.shape
    if scale is None:
        scale = d ** -0.5
    s = torch.matmul(_scaled_q(q, scale).float(), k.float().transpose(-1, -2))
    if causal:
        s = s.masked_fill(~_causal_keep(t, q.device), -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    lse = (m + torch.log(l_safe)).reshape(b * h, t, 1)
    return o.to(q.dtype), lse


def flash_attention_delta(o, do) -> torch.Tensor:
    """``rowsum(dO * O)`` in float32, (B*H, T, 1)."""
    b, h, t, d = o.shape
    return (do.float() * o.float()).sum(dim=-1, keepdim=True).reshape(
        b * h, t, 1)


def _recompute_p_ds(q, k, v, lse, do, delta, causal, scale):
    """The backward kernels' shared recompute: ``s = (q*scale) k^T``
    (the forward's same-dtype scaling and float32 product, causal cells at
    -1e30), ``p = exp(s - lse)``, ``ds = p * (dO v^T - delta)``; float32,
    P and dS never rounded.  Returns ``q*scale`` in q's dtype too."""
    b, h, t, d = q.shape
    qs = _scaled_q(q, scale)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    if causal:
        s = s.masked_fill(~_causal_keep(t, q.device), -1e30)
    p = torch.exp(s - lse.reshape(b, h, t, 1))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return qs, p, p * (dp - delta.reshape(b, h, t, 1))


def flash_attention_dq_ref(q, k, v, do, lse, delta, causal: bool = False,
                           scale: Optional[float] = None):
    """Plain version of the dQ kernel: ``dq = scale * ds k``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    _, _, ds = _recompute_p_ds(q, k, v, lse, do, delta, causal, scale)
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def flash_attention_dkv_ref(q, k, v, do, lse, delta, causal: bool = False,
                            scale: Optional[float] = None):
    """Plain version of the dK/dV kernel: ``dk = ds^T (scale*q)``,
    ``dv = p^T dO``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qs, p, ds = _recompute_p_ds(q, k, v, lse, do, delta, causal, scale)
    dk = torch.matmul(ds.transpose(-1, -2), qs.float())
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = False,
                            scale: Optional[float] = None):
    """Plain version of the backward, in the kernels' order of operations:
    ``delta = rowsum(dO * O)``, then the dQ and the dK/dV computations,
    all in float32 and cast to the input dtype.  Returns (dq, dk, dv),
    each (B, H, T, D)."""
    delta = flash_attention_delta(o, do)
    dq = flash_attention_dq_ref(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_dkv_ref(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


def _supported(dtypes, shapes) -> bool:
    dtypes, shapes = set(dtypes), {tuple(x) for x in shapes}
    if len(dtypes) != 1 or len(shapes) != 1:
        return False
    (dtype,), (shape,) = dtypes, shapes
    return (dtype in KERNELS and len(shape) == 4 and
            shape[-1] in HEAD_DIMS[dtype])


def kernel_supports(q: torch.Tensor, k: Optional[torch.Tensor] = None,
                    v: Optional[torch.Tensor] = None) -> bool:
    """Whether the CUDA kernels take this q (and k, v, where given): one
    dtype of ``KERNELS`` and one (B, H, T, D) shape with D in that dtype's
    ``HEAD_DIMS``."""
    given = [x for x in (q, k, v) if x is not None]
    return _supported([x.dtype for x in given], [x.shape for x in given])


def takes_kernels(dtypes, shapes, device, mode: str) -> bool:
    """The op's routing, from q/k/v's dtypes and shapes, q's device and
    the ``ops.fused`` mode: the kernels exactly when the mode is ``auto``,
    the device is CUDA and ``kernel_supports`` holds; the plain versions
    for everything else."""
    return (mode == "auto" and torch.device(device).type == "cuda" and
            _supported(dtypes, shapes))


def _check(name: str, **tensors) -> None:
    q = next(iter(tensors.values()))
    for key, x in tensors.items():
        if not x.is_cuda:
            raise ValueError(f"{name}: {key} must be a CUDA tensor")
        if x.dtype not in KERNELS:
            raise ValueError(f"{name}: the kernels take float32 or bfloat16, "
                             f"{key} is {x.dtype}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name}: all inputs must share one dtype, got "
                             f"{q.dtype} and {key} {x.dtype}")
        if x.shape != q.shape:
            raise ValueError(f"{name}: all inputs must share one (B, H, T, D) "
                             f"shape, got {tuple(q.shape)} and {key} "
                             f"{tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name}: inputs on different devices")
    if q.dim() != 4:
        raise ValueError(f"{name}: inputs must be (B, H, T, D), got "
                         f"{tuple(q.shape)}")
    if q.shape[-1] not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} is none of the "
                         f"{q.dtype} kernels' ({_widths(q.dtype)})")
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in tensors.values()):
        raise RuntimeError(
            f"{name} is forward-only: its output has no gradient path; call "
            "flash_attention for a differentiable result")


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE) from the CUDA kernel of q's dtype; raises on inputs no
    kernel takes."""
    _check("flash_attention_fwd", q=q, k=k, v=v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, h, t, d = q.shape
    if scale is None:
        scale = d ** -0.5
    o = torch.empty_like(q)
    lse = torch.empty((b * h, t, 1), dtype=torch.float32, device=q.device)
    kernels.launch(kernel_names(q.dtype, d)[0], q.device, q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                   b * h, t, d, q_scale(scale, q.dtype), int(causal))
    return o, lse


def _check_bwd(name, q, k, v, do, lse, delta) -> None:
    _check(name, q=q, k=k, v=v, do=do)
    b, h, t, _ = q.shape
    for key, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b * h, t, 1) or x.dtype != torch.float32 or \
                x.device != q.device:
            raise ValueError(f"{name}: {key} must be float32 ({b * h}, {t}, "
                             f"1) on {q.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def _bwd_args(q, k, v, do, lse, delta):
    return [x.contiguous() for x in (q, k, v, do, lse, delta)]


def flash_attention_dq(q, k, v, do, lse, delta, causal: bool = False,
                       scale: Optional[float] = None):
    """dq from the dQ kernel of q's dtype; ``lse`` is the forward kernel's
    (B*H, T, 1) output and ``delta`` the (B*H, T, 1) ``rowsum(dO * O)``.
    The bf16 kernel takes the scale twice: rounded to bf16 for
    ``q * scale``, and as it is for ``dq = scale * ds k``."""
    _check_bwd("flash_attention_dq", q, k, v, do, lse, delta)
    b, h, t, d = q.shape
    if scale is None:
        scale = d ** -0.5
    args = _bwd_args(q, k, v, do, lse, delta)
    dq = torch.empty_like(args[0])
    scales = ((float(scale),) if q.dtype == torch.float32 else
              (float(scale), q_scale(scale, q.dtype)))
    kernels.launch(kernel_names(q.dtype, d)[1], q.device,
                   *(x.data_ptr() for x in args), dq.data_ptr(),
                   b * h, t, d, *scales, int(causal))
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, causal: bool = False,
                        scale: Optional[float] = None):
    """(dk, dv) from the dK/dV kernel of q's dtype; arguments as
    ``flash_attention_dq``."""
    _check_bwd("flash_attention_dkv", q, k, v, do, lse, delta)
    b, h, t, d = q.shape
    if scale is None:
        scale = d ** -0.5
    args = _bwd_args(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(args[1]), torch.empty_like(args[2])
    kernels.launch(kernel_names(q.dtype, d)[2], q.device,
                   *(x.data_ptr() for x in args), dk.data_ptr(),
                   dv.data_ptr(), b * h, t, d, q_scale(scale, q.dtype),
                   int(causal))
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False,
                        scale: Optional[float] = None):
    """(dq, dk, dv) from the two CUDA backward kernels, with ``delta``
    computed between them as a PyTorch op."""
    delta = flash_attention_delta(o, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward saves (q, k, v, O, LSE);
    the backward recomputes P from LSE.  O and the gradients keep the
    inputs' dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kernel):
        fwd = flash_attention_fwd if kernel else flash_attention_ref
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.kernel = causal, scale, kernel
        return o

    @staticmethod
    def backward(ctx, do):
        bwd = flash_attention_bwd if ctx.kernel else flash_attention_bwd_ref
        dq, dk, dv = bwd(*ctx.saved_tensors, do, causal=ctx.causal,
                         scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q,k,v: (B, H, T, D) -> O (B, H, T, D) in their dtype;
    differentiable.  ``takes_kernels`` picks the kernels or the plain
    versions."""
    from analytics_zoo_torch.ops.fused import _mode
    kernel = takes_kernels((q.dtype, k.dtype, v.dtype),
                           (q.shape, k.shape, v.shape), q.device, _mode())
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale, kernel)
    if kernel:
        return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
    return flash_attention_ref(q, k, v, causal=causal, scale=scale)[0]
