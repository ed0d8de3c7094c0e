"""Mixed-precision policy (port of ``ops/dtypes.py``).

Parameters and optimizer state stay float32; matrix products round their
operands to the compute dtype (bfloat16 by default) and accumulate in
float32.
"""

from __future__ import annotations

import dataclasses

import torch

from analytics_zoo_torch.common.config import get_config
from analytics_zoo_torch.compile.engine import register_trace_key

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
}

@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype
    compute_dtype: torch.dtype


_policy = None


def get_policy() -> Policy:
    global _policy
    if _policy is None:
        cfg = get_config()
        _policy = Policy(
            param_dtype=_DTYPES[str(cfg.get("dtype.param"))],
            compute_dtype=_DTYPES[str(cfg.get("dtype.compute"))],
        )
    return _policy


def _policy_key():
    p = get_policy()
    return p.param_dtype, p.compute_dtype


# a captured program bakes in the policy it ran under (compile/engine.py)
register_trace_key(_policy_key)


def set_policy(param_dtype: str = "float32",
               compute_dtype: str = "bfloat16") -> Policy:
    global _policy
    _policy = Policy(param_dtype=_DTYPES[param_dtype],
                     compute_dtype=_DTYPES[compute_dtype])
    return _policy


def restore_policy(policy: Policy) -> None:
    """Put back a Policy captured earlier via get_policy()."""
    global _policy
    _policy = policy


class _MatmulF32Out(torch.autograd.Function):
    """``a @ b`` of two low-precision CUDA matrices with a float32 result
    (``torch.mm(..., out_dtype=float32)``, which has no derivative of its
    own).  The backward rounds the float32 cotangent to the operands'
    dtype and takes the same tensor-core products, as mixed-precision
    training does; each gradient is returned in the operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        g = grad.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.mm(g, b.t(), out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.mm(a.t(), g, out_dtype=torch.float32).to(b.dtype)
        return ga, gb


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last dim of ``x`` with both operands rounded to
    the compute dtype and a float32 result — the reference's
    ``dot_general(..., preferred_element_type=float32)``.

    On the CPU the rounded operands are widened back to float32 before
    the product: a product of two bf16 values is exact in float32, so
    only the summation order can differ from the reference.  On the card
    a bf16 product with a float32 output runs on the tensor cores; when a
    gradient is wanted it goes through ``_MatmulF32Out``."""
    cd = get_policy().compute_dtype
    if cd == torch.float32:
        return x.float() @ w.float()
    xc, wc = x.to(cd), w.to(cd)
    if x.is_cuda:
        lead = x.shape[:-1]
        x2 = xc.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (xc.requires_grad or
                                        wc.requires_grad):
            out = _MatmulF32Out.apply(x2, wc)
        else:
            out = torch.mm(x2, wc, out_dtype=torch.float32)
        return out.reshape(*lead, w.shape[-1])
    return xc.float() @ wc.float()
