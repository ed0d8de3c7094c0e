"""Weight and optimizer-state carry-over from the JAX package.

``load_jax_variables(model, variables)`` takes the JAX model's
``get_variables()`` tree — ``{"params": {layer: {param: array}},
"state": {...}}`` with every leaf already a numpy array — and loads it
into the port's model under the same key paths, the ``state``
collection with the params (BatchNormalization's ``moving_mean`` and
``moving_var`` under each layer's name; a stateless layer's entry is an
empty dict).  Both models must be built the same way (same layer order
after ``reset_name_counters()``), so that their auto-names agree.  A
``TimeDistributed`` layer's entry holds its inner layer's params, and a
layer applied to two inputs (``TransformerLayer``'s shared embedding)
has one entry, as in the JAX package.  Shapes and dtypes are checked,
and a missing or extra key raises.  A quantized tree (the calibrated int8
layout of ``ops/quant.py``: a layer with an int8 ``kernel``, a keepdims
float32 ``kernel_scale`` of shape ``(1, ..., out)`` and a 0-d float32
``act_scale``) loads into a float32 model of the same graph, which then
runs quantized.

``load_jax_opt_state(optim, opt_state)`` takes an optax state of the JAX
package's optimizer (``ScaleByAdamState``/``TraceState``/
``ScaleByScheduleState``/``ScaleByRmsState``/``ScaleByRssState``/
``ScaleByAdaDeltaState``/``EmptyState`` nested in tuples, every leaf a
numpy array: SGD, Adam, AdamWeightDecay, RMSprop, Adagrad, Adadelta and
Adamax) and returns the port optimizer's state with the same
layout and key paths, on the zoo context's device, so a run resumes
where the JAX one stopped.  With optimizer groups, ``optim`` is the
groups' dict (``{group: (OptimMethod, layer names)}``, as
``Estimator(optim_methods=)`` takes it, or ``{group: OptimMethod}``) and
``opt_state`` the reference's group-keyed state ``{group: state}``; each
group's state is carried as above.

This module never imports JAX or optax: the caller turns the trees into
numpy first, and optax's state classes are recognised by name.
"""

from __future__ import annotations

import types
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
    np.dtype(np.int16): torch.int16,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}


def _leaf_like(shape, dtype, device):
    return types.SimpleNamespace(shape=tuple(shape), dtype=dtype,
                                 device=device)


def _quantized_like(like: dict) -> dict:
    """The int8 layout of a float32 layer's params: what a quantized
    layer of the JAX package holds."""
    k = like["kernel"]
    out = dict(like)
    out["kernel"] = _leaf_like(k.shape, torch.int8, k.device)
    out["kernel_scale"] = _leaf_like(
        (1,) * (len(k.shape) - 1) + (k.shape[-1],), torch.float32, k.device)
    out["act_scale"] = _leaf_like((), torch.float32, k.device)
    return out


def _convert(src, like, path: str, errors: List[str]):
    if isinstance(like, dict):
        if not isinstance(src, dict):
            errors.append(f"{path}: expected a dict, got {type(src).__name__}")
            return like
        if "kernel_scale" in src and "kernel" in like and \
                "kernel_scale" not in like:
            like = _quantized_like(like)
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


def _to_port_state(node, device, path: str, errors: List[str]):
    from analytics_zoo_torch.pipeline.api.keras import optimizers as opt
    kinds = {cls.__name__: cls for cls in opt.STATE_TYPES}
    name = type(node).__name__
    if name in kinds and hasattr(node, "_fields"):
        cls = kinds[name]
        if tuple(node._fields) != tuple(cls._fields):
            errors.append(f"{path}: {name} fields {node._fields} != "
                          f"{cls._fields}")
            return cls(*[None] * len(cls._fields))
        return cls(*(_to_port_tree(getattr(node, f), device,
                                   f"{path}/{name}.{f}", errors)
                     for f in cls._fields))
    if isinstance(node, tuple):
        return tuple(_to_port_state(c, device, f"{path}/{i}", errors)
                     for i, c in enumerate(node))
    errors.append(f"{path}: unknown optimizer state {name}")
    return node


def _to_port_tree(node, device, path: str, errors: List[str]):
    if isinstance(node, dict):
        return {k: _to_port_tree(v, device, f"{path}/{k}", errors)
                for k, v in node.items()}
    arr = np.asarray(node)
    if arr.dtype not in _NP_TO_TORCH:
        errors.append(f"{path}: unsupported dtype {arr.dtype}")
        return None
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _layout(node, path=""):
    """(key path, class name or (shape, dtype)) of every node, in order."""
    if hasattr(node, "_fields"):
        out = [(path, type(node).__name__)]
        for f in node._fields:
            out += _layout(getattr(node, f), f"{path}.{f}")
        return out
    if isinstance(node, tuple):
        return [e for i, c in enumerate(node) for e in _layout(c, f"{path}/{i}")]
    if isinstance(node, dict):
        return [e for k in sorted(node) for e in _layout(node[k],
                                                         f"{path}/{k}")]
    return [(path, (tuple(node.shape), node.dtype))]


def load_jax_opt_state(optim, opt_state):
    """The port optimizer ``optim``'s state carried from ``opt_state``, an
    optax state of the same optimizer exported from the JAX package (its
    leaves numpy arrays).  Raises when the layouts differ."""
    from analytics_zoo_torch.common.zoo_context import get_zoo_context
    from analytics_zoo_torch.pipeline.api.keras import optimizers as opt
    if isinstance(optim, dict):
        got = (sorted(opt_state) if isinstance(opt_state, dict)
               else type(opt_state).__name__)
        if got != sorted(optim):
            raise ValueError("load_jax_opt_state: the groups differ: "
                             f"{sorted(optim)} against {got}")
        return {g: load_jax_opt_state(m[0] if isinstance(m, tuple) else m,
                                      opt_state[g])
                for g, m in optim.items()}
    errors: List[str] = []
    state = _to_port_state(opt_state, get_zoo_context().device, "", errors)
    if not errors:
        # the moments' trees stand in for the params the state belongs to
        trees = [getattr(s, f) for s in opt.collect_states(state)
                 for f in ("mu", "trace", "nu", "sum_of_squares", "e_g")
                 if hasattr(s, f)]
        want = _layout(optim.init(trees[0] if trees else {}))
        got = _layout(state)
        if want != got:
            errors.append(f"layout {got} does not match the optimizer's "
                          f"{want}")
    if errors:
        raise ValueError("load_jax_opt_state: the states differ:\n  " +
                         "\n  ".join(errors))
    return state
