"""Batch analytics tier — distributed, preemption-tolerant offline
scoring (port of the JAX package's ``batchjobs/``; the NNFrames/
NNEstimator batch-inference analog, SURVEY.md L7; docs/batch.md).

A :class:`BatchJobSpec` binds a ``data`` ``Source`` to a model and an
output directory; :class:`BatchCoordinator` partitions it into a
persisted shard manifest, leases shards to a supervised worker fleet
with heartbeat/lease expiry, and commits every output shard
exactly-once (atomic write-then-rename keyed on shard id + input
fingerprint) — a preempted worker's shard is reclaimed and recomputed
to bit-identical bytes.  Jobs end with a capacity report (rows/sec/chip
→ chips needed at a target deadline).

Import layering: ``spec``/``manifest``/``report`` are stdlib-only (the
CLI's ``report`` imports no torch); ``coordinator`` supervises without
device work; ``worker`` is the device side.  This ``__init__`` therefore
only re-exports the light tier eagerly.
"""

from .spec import BatchJobSpec, ENV_BATCH_JOB  # noqa: F401
from .manifest import (  # noqa: F401
    LeaseClient, LeaseLost, ShardManifest)
from .report import build_report, load_report, render_report  # noqa: F401


def __getattr__(name):
    # heavy tiers on demand, keeping `import analytics_zoo_torch.
    # batchjobs` cheap for control-plane callers
    if name in ("BatchCoordinator", "run_job"):
        from . import coordinator
        return getattr(coordinator, name)
    if name == "BatchWorker":
        from .worker import BatchWorker
        return BatchWorker
    raise AttributeError(name)


__all__ = [
    "BatchJobSpec", "ENV_BATCH_JOB", "LeaseClient", "LeaseLost",
    "ShardManifest", "BatchCoordinator", "BatchWorker", "run_job",
    "build_report", "load_report", "render_report",
]
