"""Mixed-precision policy (port of ``ops/dtypes.py``).

Parameters and optimizer state stay float32; matrix products round their
operands to the compute dtype (bfloat16 by default) and accumulate in
float32.
"""

from __future__ import annotations

import dataclasses

import torch

from analytics_zoo_torch.common.config import get_config

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


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last dim of ``x`` with both operands rounded to
    the compute dtype and a float32 result — the reference's
    ``dot_general(..., preferred_element_type=float32)``.

    On the CPU the rounded operands are widened back to float32 before
    the product: a product of two bf16 values is exact in float32, so
    only the summation order can differ from the reference.  On the card
    a bf16 product with a float32 output runs on the tensor cores."""
    cd = get_policy().compute_dtype
    if cd == torch.float32:
        return x.float() @ w.float()
    xc, wc = x.to(cd), w.to(cd)
    if x.is_cuda:
        lead = x.shape[:-1]
        out = torch.mm(xc.reshape(-1, x.shape[-1]), wc,
                       out_dtype=torch.float32)
        return out.reshape(*lead, w.shape[-1])
    return xc.float() @ wc.float()
