"""Elastic recovery: re-form the process group and the mesh on the
surviving ranks (port of ``resilience/recovery.py``).

The reference builds a fresh ``jax.sharding.Mesh`` over the devices
still reachable; the Estimator then re-places the training state from
the last snapshot and resumes from the checkpointed pipeline position.
The port's ranks are processes, so re-forming is a new process group:
the survivors leave the old one and rendezvous again through a FRESH
file store, the lowest surviving rank becoming rank 0.  A ``file:///p``
coordinator re-forms through ``file:///p.reform<g>`` (``g`` the
re-formation's generation); a ``host:port`` one through
``<run dir>/reform-<host_port>.<g>`` under ``ZOO_TPU_RUN_DIR``: its TCP
store lived in the old rank 0, which may be the rank that was lost, and
no port beside it is reserved.  With neither there is no rendezvous and
the run degrades.  This module owns that and the topology math:

* :func:`surviving_devices` — the ranks to rebuild on, from a classified
  failure (a chaos :class:`LostHost` names them; otherwise every rank of
  the live mesh);
* :func:`viable_data_degree` — graceful degradation: the largest
  data-parallel degree the survivors support *that still tiles the
  batch*;
* :func:`reform_mesh` — the new group and mesh, installed as the live
  ``ZooContext`` mesh.

Raises :class:`NoViableTopology` when nothing survives, or on a rank the
re-formed mesh leaves out — the policy engine turns that into the
DEGRADE (checkpoint-and-queue) path.
"""

from __future__ import annotations

import logging
import os
import re
from typing import List, Optional, Sequence

from analytics_zoo_torch.parallel import mesh as mesh_lib

log = logging.getLogger("analytics_zoo_torch.resilience")

_generation = [0]

REFORM_STORE_PREFIX = "reform-"


class NoViableTopology(RuntimeError):
    """No surviving rank set can run the job — degrade, don't hang."""


def surviving_devices(exc: Optional[BaseException] = None) -> List[int]:
    """Ranks to rebuild on: a chaos :class:`LostHost` names them;
    otherwise every rank of the live mesh (what the reference's
    ``jax.devices()`` still reports)."""
    ids = getattr(exc, "survivors", None)
    if ids is not None:
        return sorted(int(i) for i in ids)
    return [int(r) for r in mesh_lib.current_mesh().devices]


def viable_data_degree(num_devices: int, batch_size: int) -> int:
    """Largest data-parallel degree ``k <= num_devices`` with
    ``batch_size % k == 0`` (0 when no device survives)."""
    if num_devices <= 0 or batch_size <= 0:
        return 0
    for k in range(min(int(num_devices), int(batch_size)), 0, -1):
        if batch_size % k == 0:
            return k
    return 0


def _reform_store_name(coordinator: str, generation: int) -> str:
    """The file name, under the run dir, of the store a ``host:port``
    group re-forms through (the launcher clears stale ones)."""
    tag = re.sub(r"[^A-Za-z0-9]+", "_", coordinator.split("://", 1)[-1])
    return f"{REFORM_STORE_PREFIX}{tag}.{generation}"


def _fresh_coordinator(coordinator: str, generation: int) -> str:
    if coordinator.startswith("file://"):
        return f"{coordinator}.reform{generation}"
    run_dir = os.environ.get("ZOO_TPU_RUN_DIR")
    if not run_dir:
        raise NoViableTopology(
            f"no store to re-form the group of {coordinator} through: a "
            "host:port group re-forms through a file store under the run "
            "dir (ZOO_TPU_RUN_DIR), and none is set")
    return "file://" + os.path.join(
        os.path.abspath(run_dir), _reform_store_name(coordinator, generation))


def reform_mesh(survivors: Sequence[int], batch_size: int,
                coordinator: Optional[str] = None):
    """Leave the old process group, join a new one of the first
    ``viable_data_degree`` survivors (pure data parallelism on the
    remnant, as the reference), build its mesh and install it as the live
    context mesh.  Every surviving rank calls it together."""
    import torch.distributed as dist
    from analytics_zoo_torch.common import zoo_context as zc
    survivors = sorted(int(s) for s in survivors)
    dp = viable_data_degree(len(survivors), batch_size)
    if dp == 0:
        raise NoViableTopology(
            f"no viable topology: {len(survivors)} surviving "
            f"device(s) for batch size {batch_size}")
    ctx = zc.get_zoo_context()
    old = ctx.mesh
    keep = survivors[:dp]
    if old.rank not in keep:
        raise NoViableTopology(
            f"no viable topology for rank {old.rank}: the re-formed mesh "
            f"takes ranks {keep}")
    if dp < len(survivors):
        log.warning("degraded topology: using %d of %d surviving ranks "
                    "(batch %d must tile the data axis)", dp,
                    len(survivors), batch_size)
    _generation[0] += 1
    fresh = None
    if dp > 1:
        coordinator = coordinator or os.environ.get("ZOO_TPU_COORDINATOR")
        if not coordinator:
            raise NoViableTopology("no coordinator to re-form the process "
                                   "group through (ZOO_TPU_COORDINATOR)")
        fresh = _fresh_coordinator(coordinator, _generation[0])
    backend = None
    if dist.is_available() and dist.is_initialized():
        backend = dist.get_backend()
        dist.destroy_process_group()
    if fresh is not None:
        # the old group's backend: a gloo rehearsal on the card stays gloo
        zc.init_process_group(fresh, dp, keep.index(old.rank), ctx.device,
                              backend=backend)
    new_mesh = mesh_lib.create_mesh({mesh_lib.DATA_AXIS: dp})
    ctx.mesh = new_mesh
    log.warning("mesh re-formed: %s -> %s (%d ranks lost)", old.shape,
                new_mesh.shape, old.world_size - len(survivors))
    _count_reformation()
    return new_mesh


def _count_reformation() -> None:
    try:
        from analytics_zoo_torch.observability import get_registry
        get_registry().counter(
            "mesh_reformations_total",
            "elastic recoveries that re-formed the device mesh on a "
            "surviving topology").inc()
    except Exception:   # noqa: BLE001 — metrics must never block recovery
        pass
