"""Collective accounting (port of ``observability/collectives.py``):
estimated bytes moved and time spent per collective (gradient all-reduce,
FSDP all-gather, pipeline point-to-point).

The port calls its collectives explicitly (``parallel/comm.py``), but the
counters stay the reference's estimates so that the two packages' reports
read alike: the TRAFFIC is fully determined by the sharding contract: a ring all-reduce of P bytes over n devices
moves ``2(n-1)/n * P`` bytes per device link, an all-gather moves
``(n-1)/n * P``, a pipeline tick ppermutes one microbatch of
activations per stage.  This module turns those identities into registry counters:

* ``collective_bytes_total{op}``   — estimated per-device link bytes
* ``collective_seconds_total{op}`` — bytes / ``observability.ici_gbps``
  (0 disables the time estimate — set it to your interconnect's
  per-link bandwidth to get collective seconds in the reports)
* ``collective_ops_total{op}``     — how many steps/applies were
  accounted

The cluster aggregator sums these across hosts into the
straggler/collective section of ``obs_report.py --merge-hosts``.

Estimates are HOST-SIDE and cheap (computed once per program build,
counters bumped per dispatch); they never touch device data.  Like all
observability code they must degrade to "fewer counters", never to an
exception on a hot path.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

log = logging.getLogger("analytics_zoo_torch.observability")

# canonical op labels
OP_PSUM_GRADS = "psum_grads"          # data(+fsdp)-axis gradient sync
OP_ALL_GATHER_PARAMS = "all_gather_params"   # FSDP param regather
OP_PPERMUTE = "ppermute"              # pipeline activation baton

# help text shared with the traced pipeline_apply path — whichever
# site registers the family first, the HELP line reads the same
BYTES_PER_STEP_HELP = \
    "estimated per-device link bytes per dispatch, by op"


def ring_all_reduce_bytes(payload_bytes: float, n: int) -> float:
    """Per-device link traffic of a ring all-reduce (reduce-scatter +
    all-gather): 2(n-1)/n of the payload."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * float(payload_bytes)


def all_gather_bytes(payload_bytes: float, n: int) -> float:
    """Per-device link traffic of an all-gather of a sharded payload:
    each device receives the (n-1)/n it doesn't hold."""
    if n <= 1:
        return 0.0
    return (n - 1) / n * float(payload_bytes)


def _dtype_bytes(dtype_str) -> int:
    name = str(dtype_str).replace("torch.", "")
    return {"bfloat16": 2, "float16": 2, "float32": 4,
            "float64": 8}.get(name, 4)


def estimate_train_step_collectives(params, mesh,
                                    grad_sync_dtype: str = "float32"
                                    ) -> Dict[str, float]:
    """Per-step collective bytes implied by the trainer's sharding
    contract: gradients psum over the data×fsdp axes (in
    ``grad_sync_dtype``), and — when fsdp > 1 — the forward/backward
    all-gathers that rematerialize the fsdp-sharded params.  Returns
    ``{op: bytes_per_step}`` (empty when the mesh has no cross-device
    data axes); ``params`` holds the WHOLE leaves (their shapes are what
    counts).  Pure host arithmetic."""
    import numpy as np
    from analytics_zoo_torch.parallel import mesh as mesh_lib
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves

    leaves = [leaf for leaf in tree_leaves(params) if leaf is not None]
    n_elems = sum(int(np.prod(np.shape(leaf))) for leaf in leaves)
    dp = int(mesh.shape[mesh_lib.DATA_AXIS])
    fsdp = int(mesh.shape[mesh_lib.FSDP_AXIS])
    out: Dict[str, float] = {}
    sync = dp * fsdp
    if sync > 1 and n_elems:
        grad_bytes = n_elems * _dtype_bytes(grad_sync_dtype)
        out[OP_PSUM_GRADS] = ring_all_reduce_bytes(grad_bytes, sync)
    if fsdp > 1 and n_elems:
        # forward + backward each regather the sharded params once
        param_bytes = sum(
            int(np.prod(np.shape(leaf)))
            * _dtype_bytes(str(getattr(leaf, "dtype", "float32")))
            for leaf in leaves)
        out[OP_ALL_GATHER_PARAMS] = \
            2.0 * all_gather_bytes(param_bytes, fsdp)
    return out


def estimate_pipeline_ppermute_bytes(microbatch_bytes: float,
                                     num_stages: int,
                                     num_microbatches: int) -> float:
    """Per-device link bytes of one ``pipeline_apply``: every tick of
    the ``M + P - 1`` schedule ppermutes one microbatch of activations
    per stage, plus the P-1 rotations of the final output broadcast."""
    if num_stages <= 1:
        return 0.0
    ticks = num_microbatches + num_stages - 1
    # +1 rotation for last->0, then P-1 broadcast hops of the full
    # output block (num_microbatches microbatches)
    broadcast = num_stages * num_microbatches * float(microbatch_bytes)
    return ticks * float(microbatch_bytes) + broadcast


class _Instruments:
    """Per-op counter children, bound once per live registry: this
    runs on the per-step dispatch hot path, so repeat calls must not
    re-resolve config or re-take the registry lock (rebinds after
    ``reset_registry`` — tests — by keying the cache on the registry
    object)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._registry = None
        self._gbps: Dict[Optional[float], float] = {}
        self._children: Dict = {}     # (op, gbps) -> bound children

    def _resolve_gbps(self, ici_gbps: Optional[float]) -> float:
        if ici_gbps is not None:
            return float(ici_gbps)
        try:
            from analytics_zoo_torch.common.config import get_config
            return float(get_config().get(
                "observability.ici_gbps", 0.0) or 0.0)
        except Exception:
            return 0.0

    def _bind(self, reg, op: str, gbps: float):
        c_bytes = reg.counter(
            "collective_bytes_total",
            "estimated per-device link bytes moved by sharding-implied "
            "collectives (ring/all-gather identities over the mesh)",
            labels=("op",)).labels(op)
        c_ops = reg.counter(
            "collective_ops_total",
            "dispatches accounted into collective_bytes_total",
            labels=("op",)).labels(op)
        c_secs = reg.counter(
            "collective_seconds_total",
            "estimated seconds inside collectives: bytes / "
            "observability.ici_gbps (0 disables)",
            labels=("op",)).labels(op) if gbps > 0 else None
        g = reg.gauge(
            "collective_bytes_per_step", BYTES_PER_STEP_HELP,
            labels=("op",)).labels(op)
        return c_bytes, c_ops, c_secs, g

    def record(self, bytes_by_op: Dict[str, float],
               ici_gbps: Optional[float] = None,
               steps: int = 1) -> None:
        """``bytes_by_op`` is PER-STEP traffic; ``steps`` scales the
        cumulative counters for a fused dispatch while the per-step
        gauge stays per-step — so chunked/epoch-scan and per-step
        engines stay comparable in bench/report diffs."""
        if not bytes_by_op or steps <= 0:
            return
        from analytics_zoo_torch.observability.metrics import get_registry
        reg = get_registry()
        with self._lock:
            if self._registry is not reg:
                self._registry = reg
                self._gbps.clear()
                self._children.clear()
            gbps = self._gbps.get(ici_gbps)
            if gbps is None:
                gbps = self._gbps[ici_gbps] = \
                    self._resolve_gbps(ici_gbps)
            for op, nbytes in bytes_by_op.items():
                handles = self._children.get((op, gbps))
                if handles is None:
                    handles = self._children[(op, gbps)] = \
                        self._bind(reg, op, gbps)
                c_bytes, c_ops, c_secs, g = handles
                total = float(nbytes) * steps
                c_bytes.inc(total)
                c_ops.inc(steps)
                if c_secs is not None:
                    c_secs.inc(total / (gbps * 1e9))
                g.set(float(nbytes))


_instruments = _Instruments()


def record_step_collectives(bytes_by_op: Dict[str, float],
                            ici_gbps: Optional[float] = None,
                            steps: int = 1) -> None:
    """Bump the collective counters for a dispatch covering ``steps``
    training steps of per-step traffic ``bytes_by_op``.  Never
    raises."""
    try:
        _instruments.record(bytes_by_op, ici_gbps, steps)
    except Exception:
        log.debug("collective accounting failed", exc_info=True)
