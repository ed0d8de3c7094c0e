"""Batch scoring worker — the device side of the batchjobs fleet (port of
the JAX package's ``batchjobs/worker.py``).

Launched per slot by the coordinator (``python -m
analytics_zoo_torch.batchjobs.worker``) with the launcher env contract
(ZOO_TPU_RUN_DIR / PROCESS_ID / METRICS_* / CLOCK_ANCHOR, plus
ZOO_TPU_CHAOS for fault drills).  Each incarnation:

* joins the observability plane (``init_worker_observability``) and
  beats the run-dir heartbeat every batch — the heartbeat is what lets
  the coordinator's detector distinguish "slow" from "dead", while the
  *lease* renewal is what fences the shard ledger;
* rebuilds source + model from the job spec and runs the model's
  ``warm`` before scoring.  The coordinator exports ZOO_TPU_RUN_DIR, so
  the kernel libraries go through the compile farm
  (``<run_dir>/compile-cache``, ``compile/cache.py``): process 0 stores
  what it builds, and a replacement incarnation loads them without
  ``nvcc``.  A ``warm`` that raises ends the worker: it never scores
  on a route it could not prepare;
* runs the claim→score→commit loop: every claimed shard is committed,
  released, or the raise propagates out of the loop.

Every batch keeps the job's batch shape: the worker passes
``batch_size`` to a model's ``predict`` that takes it, so a shard's
short tail is zero-padded to the compiled (captured) shape, and any
incarnation scores a shard to the same bytes.

Chaos: every batch is a ``worker.step`` site trip
(``resilience/chaos.py`` SITE_WORKER_STEP) — the kill-and-resume drill
kills a worker mid-shard here and the replacement produces
bit-identical committed output.
"""

from __future__ import annotations

import inspect
import logging
import os
import sys
import time

import numpy as np

from .spec import BatchJobSpec
from .manifest import (
    LeaseClient, LeaseLost, shard_output_path)

log = logging.getLogger("analytics_zoo_torch.batchjobs.worker")

#: how long an idle worker waits before re-polling the ledger when
#: every pending shard is leased by someone else
IDLE_POLL_S = 0.2

#: the JAX package's directory: a builder file there is never loaded
_REFERENCE_PACKAGE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "analytics_zoo_tpu")


# ------------------------------------------------------------- builders
def resolve_ref(ref: str):
    """Resolve ``module:attr`` or ``/path/to/file.py:attr``.  A file
    under the JAX package's directory is refused: the port loads none of
    its files."""
    mod_part, _, attr = ref.rpartition(":")
    if not mod_part or not attr:
        raise ValueError(f"builder ref {ref!r} is not 'module:attr'")
    if mod_part.endswith(".py") or os.sep in mod_part:
        import importlib.util
        path = os.path.realpath(mod_part)
        if os.path.commonpath([path, os.path.realpath(
                _REFERENCE_PACKAGE)]) == os.path.realpath(
                    _REFERENCE_PACKAGE):
            raise ValueError(
                f"builder ref {ref!r} names a file of the JAX package; "
                "the PyTorch port loads none of them")
        name = "_zoo_batch_builder_" + os.path.basename(mod_part)[:-3]
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    else:
        import importlib
        module = importlib.import_module(mod_part)
    return getattr(module, attr)


def build_source(job: BatchJobSpec):
    kind = job.source.get("kind")
    if kind == "npy_dir":
        from analytics_zoo_torch.data.source import NpyDirSource
        return NpyDirSource(job.source["path"])
    if kind == "builder":
        src = resolve_ref(job.source["ref"])(**job.source.get("args", {}))
        from analytics_zoo_torch.data.source import as_source
        return as_source(src)
    raise ValueError(f"unknown source kind {kind!r}")


def build_model(job: BatchJobSpec):
    """Build and unwrap the model into a ``.predict(x)`` holder.
    Accepts an ``InferenceModel``/``KerasNet`` directly, or a serving
    ``Endpoint`` (uses its model)."""
    obj = resolve_ref(job.model["ref"])(**job.model.get("args", {}))
    if hasattr(obj, "predict"):
        return obj
    inner = getattr(obj, "model", None)
    if inner is not None and hasattr(inner, "predict"):
        return inner
    raise TypeError(
        f"model builder {job.model.get('ref')} returned "
        f"{type(obj).__name__} with no .predict")


def _rows_only(gathered):
    """A Source's ``gather`` mirrors its item structure —
    ``ArraySource``/``NpyDirSource`` return ``(x, y_or_None)``; batch
    scoring consumes the features."""
    if isinstance(gathered, tuple) and len(gathered) == 2:
        return gathered[0]
    return gathered


def _takes_batch_size(predict) -> bool:
    try:
        params = inspect.signature(predict).parameters
    except (TypeError, ValueError):
        return False
    return "batch_size" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


class BatchWorker:
    """One incarnation's claim→score→commit loop over the ledger."""

    def __init__(self, job: BatchJobSpec, run_dir: str, *,
                 process_id: int = 0, source=None, model=None,
                 heartbeat=None, chaos=None):
        self.job = job
        self.run_dir = run_dir
        self.process_id = process_id
        self.source = source if source is not None else build_source(job)
        self.model = model if model is not None else build_model(job)
        self.heartbeat = heartbeat
        self.chaos = chaos
        self._lease = LeaseClient(
            run_dir, owner=f"host-{process_id}:{os.getpid()}")
        self._predict_kw = ({"batch_size": job.batch_size}
                            if _takes_batch_size(self.model.predict)
                            else {})
        self.step = 0               # global batch counter (chaos site)
        self.shards_done = 0
        self.rows_done = 0

        from analytics_zoo_torch.observability import get_registry
        reg = get_registry()
        self._m_rows = reg.counter(
            "batch_rows_total", "rows scored and committed",
            labels=("job",))
        self._m_shard_s = reg.histogram(
            "batch_shard_seconds", "wall seconds per committed shard",
            labels=("job",))
        self._m_shards = reg.counter(
            "batch_shards_committed_total", "output shards committed",
            labels=("job",))
        self._m_recomputed = reg.counter(
            "batch_rows_recomputed_total",
            "rows recomputed after a lease steal (resume overhead)",
            labels=("job",))
        self._m_dup = reg.counter(
            "batch_duplicate_commits_total",
            "commit races lost to an already-present marker",
            labels=("job",))
        self._m_lost = reg.counter(
            "batch_lease_lost_total",
            "shards abandoned because the lease was stolen mid-score",
            labels=("job",))

    # ------------------------------------------------------------ scoring
    def _score_shard(self, shard_id: int, shard: dict) -> np.ndarray:
        """Score one shard's row range batch-by-batch.  Deterministic
        by construction: fixed row order, fixed batch shape, no RNG —
        so ANY incarnation produces the same bytes for a shard."""
        start, end = int(shard["start"]), int(shard["end"])
        bs = self.job.batch_size
        outs = []
        rows_done = 0
        for lo in range(start, end, bs):
            hi = min(lo + bs, end)
            if self.chaos is not None:
                # the drill's kill site: a "kill" fault here dies
                # between renewals, mid-shard
                self.chaos.trip("worker.step", self.step)
            x = _rows_only(self.source.gather(np.arange(lo, hi)))
            y = self.model.predict(x, **self._predict_kw)
            outs.append(np.asarray(y))
            rows_done += hi - lo
            self.step += 1
            self._lease.renew(shard_id, rows_done=rows_done)
            if self.heartbeat is not None:
                self.heartbeat.beat(self.step)
        return np.concatenate(outs, axis=0) if outs else np.zeros((0,))

    def _commit_shard(self, shard_id: int, shard: dict) -> None:
        """Score + atomically publish one claimed shard.  Output goes
        write-then-rename BEFORE the exactly-once marker: a crash
        between the two recomputes to identical bytes, so the rename
        replay is content-neutral."""
        t0 = time.perf_counter()
        result = self._score_shard(shard_id, shard)
        out_path = shard_output_path(self.job.output_dir, shard_id)
        # hand-rolled (not common.fsutil): np.save STREAMS the array
        # into the tmp file, and the commit protocol needs the fsync
        # ordered before the rename
        tmp = f"{out_path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.save(f, result)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, out_path)
        rows = int(shard["end"]) - int(shard["start"])
        recomputed = self._lease._stolen_rows.get(shard_id, 0)
        created = self._lease.commit_shard(
            shard_id, fingerprint=shard["fingerprint"], rows=rows,
            seconds=time.perf_counter() - t0)
        job = self.job.name
        if created:
            self._m_rows.labels(job).inc(rows)
            self._m_shards.labels(job).inc()
            self._m_shard_s.labels(job).observe(time.perf_counter() - t0)
            if recomputed:
                self._m_recomputed.labels(job).inc(recomputed)
            self.shards_done += 1
            self.rows_done += rows
        else:
            self._m_dup.labels(job).inc()

    # --------------------------------------------------------------- loop
    def run(self) -> dict:
        """Drain the ledger: claim, score, commit, repeat until every
        shard in the manifest is committed."""
        while True:
            shards = self._lease.claim_shards(limit=1)
            if not shards:
                progress = self._lease.manifest.progress()
                if progress["complete"]:
                    break
                # everything pending is validly leased elsewhere —
                # poll; an expired lease becomes claimable above
                if self.heartbeat is not None:
                    self.heartbeat.beat(self.step, force=True)
                time.sleep(IDLE_POLL_S)
                continue
            for shard_id, shard in shards:
                try:
                    self._commit_shard(shard_id, shard)
                except LeaseLost:
                    # stolen mid-score: the thief owns the obligation
                    # now; drop ours and move on
                    self._m_lost.labels(self.job.name).inc()
                    self._lease.release_shard(shard_id)
                except BaseException:
                    self._lease.release_shard(shard_id)
                    raise
        return {"shards": self.shards_done, "rows": self.rows_done,
                "steps": self.step}


def main() -> int:
    logging.basicConfig(level=logging.INFO)
    pid = int(os.environ.get("ZOO_TPU_PROCESS_ID", "0"))
    run_dir = os.environ.get("ZOO_TPU_BATCH_JOB") \
        or os.environ.get("ZOO_TPU_RUN_DIR")
    if not run_dir:
        print("batch worker: ZOO_TPU_BATCH_JOB / ZOO_TPU_RUN_DIR not set",
              file=sys.stderr)
        return 2

    from analytics_zoo_torch.observability import (
        flush_worker_observability, init_worker_observability)
    from analytics_zoo_torch.resilience.chaos import active_chaos
    from analytics_zoo_torch.resilience.detector import HostHeartbeat

    init_worker_observability(process_index=pid)
    job = BatchJobSpec.load(run_dir)
    heartbeat = HostHeartbeat.from_env()
    chaos = active_chaos()

    model = build_model(job)
    worker = BatchWorker(job, run_dir, process_id=pid, model=model,
                         heartbeat=heartbeat, chaos=chaos)
    # the warm start, through the compile farm: with ZOO_TPU_RUN_DIR set
    # the kernel libraries' cache lives in the run dir, process 0
    # stores, replacements load; a failure here ends the worker
    warm = getattr(model, "warm", None)
    if callable(warm):
        probe = _rows_only(worker.source.gather(np.arange(
            0, min(job.batch_size, len(worker.source)))))
        warm(probe.shape[1:], job.batch_size, dtype=probe.dtype)

    summary = worker.run()
    flush_worker_observability()
    log.info("batch worker %d done: %s", pid, summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
