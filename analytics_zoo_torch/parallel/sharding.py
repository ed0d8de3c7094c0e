"""Parameter-sharding collection (port of ``parallel/sharding.py``): map
a model's parameter tree to the ``Shard`` specs of ``parallel/mesh.py``.

Three sources, in precedence order, as in the reference:

1. layer-declared tensor-parallel specs (``layer.param_pspecs``, set by
   e.g. ``Dense(parallel_mode="column")``), on the ``model`` or
   ``expert`` axis;
2. FSDP: leaves of at least ``fsdp_min_size`` elements split on their
   largest dim that the ``fsdp`` size divides (ZeRO-style; the
   reference's partitioned ``AllReduceParameter``);
3. replication (None).

Where the reference's GSPMD then derives every collective from these
specs, the port's trainer and layers call them explicitly
(``parallel/comm.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from analytics_zoo_torch.parallel.mesh import Mesh, Shard, fsdp_leaf


def _declared(mesh: Mesh, spec: Optional[Shard]) -> Optional[Shard]:
    if spec is None or mesh.size(spec.axis) == 1:
        return None
    return spec


def collect_param_shardings(model, params: Dict[str, Any], mesh: Mesh,
                            fsdp_min_size: int = 2 ** 12):
    """The spec tree matching ``params`` for ``model``: a ``Shard`` or
    None at every leaf."""

    def visit_layer(layer, sub_params):
        declared = getattr(layer, "param_pspecs", {}) or {}
        sub_layers = {l.name: l for l in getattr(layer, "layers", [])}

        def walk(key_path, node):
            if isinstance(node, dict):
                out = {}
                for k, v in node.items():
                    if k in sub_layers:
                        out[k] = visit_layer(sub_layers[k], v)
                    else:
                        out[k] = walk(key_path + (k,), v)
                return out
            if node is None:
                return None
            key = key_path[-1] if key_path else None
            if key in declared:
                return _declared(mesh, declared[key])
            return fsdp_leaf(mesh, tuple(node.shape), fsdp_min_size)

        return walk((), sub_params)

    return visit_layer(model, params)


def any_sharded(specs) -> bool:
    """Whether a spec tree shards any leaf."""
    if isinstance(specs, dict):
        return any(any_sharded(v) for v in specs.values())
    if isinstance(specs, (list, tuple)):
        return any(any_sharded(v) for v in specs)
    return isinstance(specs, Shard)
