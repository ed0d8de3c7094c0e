"""Weight carry-over from the JAX package.

``load_jax_variables(model, variables)`` takes the JAX model's
``get_variables()`` tree — ``{"params": {layer: {param: array}},
"state": {...}}`` with every leaf already a numpy array — and loads it
into the port's model under the same key paths.  Both models must be
built the same way (same layer order after ``reset_name_counters()``),
so that their auto-names agree.  Shapes and dtypes are checked, and a
missing or extra key raises.  This module never imports JAX: the caller
turns the tree into numpy first.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int8): torch.int8,
}


def _convert(src, like, path: str, errors: List[str]):
    if isinstance(like, dict):
        if not isinstance(src, dict):
            errors.append(f"{path}: expected a dict, got {type(src).__name__}")
            return like
        missing = sorted(set(like) - set(src))
        extra = sorted(set(src) - set(like))
        if missing:
            errors.append(f"{path}: missing keys {missing}")
        if extra:
            errors.append(f"{path}: extra keys {extra}")
        return {k: _convert(src[k], like[k], f"{path}/{k}", errors)
                for k in like if k in src}
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(like.shape):
        errors.append(f"{path}: shape {tuple(arr.shape)} != "
                      f"{tuple(like.shape)}")
        return like
    dtype = _NP_TO_TORCH.get(arr.dtype)
    if dtype != like.dtype:
        errors.append(f"{path}: dtype {arr.dtype} does not match {like.dtype}")
        return like
    return torch.from_numpy(np.array(arr, copy=True)).to(like.device)


def load_jax_variables(model, variables: Dict[str, Any]) -> Dict[str, Any]:
    """Load numpy variables exported from the JAX package into ``model``
    (a KerasNet or ZooModel); returns the new variables tree."""
    own = model.get_variables()
    errors: List[str] = []
    new = _convert(variables, own, "", errors)
    if errors:
        raise ValueError("load_jax_variables: the trees differ:\n  " +
                         "\n  ".join(errors))
    model.set_variables(new)
    return new
