"""DataPipeline — deterministic, checkpointable, sharded input engine
(port of the JAX package's ``data/pipeline.py``: numpy and threads; the
same batch stream, the same ``state_dict``).

Reference: the FeatureSet/DataSet layer feeding the distributed
optimizer (SURVEY L1/L2), rebuilt Grain-style: a random-access
:class:`~analytics_zoo_torch.data.source.Source`, a pure-function
:class:`~analytics_zoo_torch.data.sampler.IndexSampler`, composable host
stages, and an explicit ``(epoch, step)`` POSITION that
``state_dict()``/``load_state_dict()`` checkpoint — so a restored run
resumes on the exact next batch instead of replaying the epoch.

Determinism contract:

* same ``(source order, seed)`` => identical batch stream, across runs
  and across processes;
* shard ``h`` of ``S`` sees rows ``[h*B:(h+1)*B]`` of every global
  batch — concatenating all shards' step-``k`` batches reproduces the
  unsharded step-``k`` batch exactly;
* the position advances ONLY when a batch is handed to the consumer
  (``__iter__`` / ``DeviceLoader``), never when a worker merely built
  it ahead — so a checkpoint taken between steps is exact even with
  prefetch in flight.

The position is intentionally NOT buried in a live iterator:
``iter_epoch`` is a pure read (resumable from any ``(epoch, step)``),
``commit`` moves the position, and the consuming loop decides when.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_torch.data.sampler import IndexSampler
from analytics_zoo_torch.data.source import Source, as_source
from analytics_zoo_torch.data.stages import (
    MapStage, Stage, TransformStage, WorkerPool, run_stages)
from analytics_zoo_torch.observability import get_registry

STATE_VERSION = 1


def _pipeline_metrics(name: str):
    reg = get_registry()
    return {
        "batches": reg.counter(
            "data_batches_total",
            "host batches produced by the data pipeline",
            labels=("pipeline",)).labels(name),
        "wait": reg.histogram(
            "data_batch_wait_seconds",
            "consumer wait for the next host batch (0 ≈ the workers "
            "are keeping up)", labels=("pipeline",)).labels(name),
        "qdepth": reg.gauge(
            "data_worker_queue_depth",
            "batches built ahead by the pipeline worker pool",
            labels=("pipeline",)).labels(name),
    }


class DataPipeline:
    """Deterministic sharded batch pipeline over a random-access source.

    Args:
        source: a :class:`Source`, or arrays/pytrees (coerced via
            :class:`ArraySource`; pass ``y=...`` for labels).
        batch_size: rows PER SHARD per step.
        shuffle / seed: deterministic per-epoch shuffling.
        shard_index / shard_count: this host's shard — defaults to the
            ``torch.distributed`` rank and world size (0 and 1 without a
            process group) so the same script shards itself per host.
        remainder: ``"drop"`` (training) or ``"pad"`` (a masked short
            tail batch; the mask is appended to the batch tuple).
        stages: host-side :class:`Stage` chain applied to each batch.
        num_workers: >0 builds batches in a thread pool, ``num_workers``
            wide, pulling ahead of the consumer (ordered — parallelism
            never reorders the stream).
    """

    def __init__(self, source, y=None, *, batch_size: int = 32,
                 shuffle: bool = True, seed: Optional[int] = None,
                 shard_index: Optional[int] = None,
                 shard_count: Optional[int] = None,
                 remainder: str = "drop",
                 stages: Sequence[Stage] = (),
                 num_workers: int = 0,
                 name: str = "train"):
        self.source: Source = as_source(source, y)
        self.sampler = IndexSampler(
            len(self.source), batch_size, shuffle=shuffle, seed=seed,
            shard_index=shard_index, shard_count=shard_count,
            remainder=remainder)
        self.stages = list(stages)
        self.num_workers = int(num_workers)
        self.name = name
        self._epoch = 0
        self._step = 0   # next batch to hand out
        self._pool: Optional[WorkerPool] = None
        self._m = _pipeline_metrics(name)

    # ------------------------------------------------------------ geometry
    @property
    def batch_size(self) -> int:
        return self.sampler.batch_size

    @property
    def num_batches(self) -> int:
        """Steps per epoch (identical on every shard)."""
        return self.sampler.num_batches

    @property
    def size(self) -> int:
        """Records in the underlying source (pre-shard)."""
        return len(self.source)

    @property
    def seed(self) -> int:
        return self.sampler.seed

    @property
    def shuffle(self) -> bool:
        return self.sampler.shuffle

    # ----------------------------------------------------------- builders
    def _derive(self, extra_stage: Stage) -> "DataPipeline":
        return DataPipeline(
            self.source, batch_size=self.sampler.batch_size,
            shuffle=self.sampler.shuffle, seed=self.sampler.seed,
            shard_index=self.sampler.shard_index,
            shard_count=self.sampler.shard_count,
            remainder=self.sampler.remainder,
            stages=self.stages + [extra_stage],
            num_workers=self.num_workers, name=self.name)

    def map(self, fn: Callable, per_leaf: bool = False) -> "DataPipeline":
        """Append a batch-level map stage (``fn(batch) -> batch``)."""
        return self._derive(MapStage(fn, per_leaf=per_leaf))

    def transform(self, preprocessing) -> "DataPipeline":
        """Append a Preprocessing / callable over the X half — the
        ``FeatureSet.transform`` migration hook."""
        return self._derive(TransformStage(preprocessing))

    __rshift__ = transform

    def workers(self, num_workers: int) -> "DataPipeline":
        """Set the stage worker-pool width (chainable)."""
        self.num_workers = int(num_workers)
        return self

    # ------------------------------------------------------- batch assembly
    def _build_batch(self, sel_mask: Tuple[np.ndarray, np.ndarray]):
        sel, mask = sel_mask
        batch = run_stages(self.source.gather(sel), self.stages)
        if self.sampler.remainder == "pad":
            if isinstance(batch, tuple):
                return batch + (mask,)
            return (batch, mask)
        return batch

    def iter_epoch(self, epoch: int, start_step: int = 0
                   ) -> Iterator[Tuple[int, Any]]:
        """Pure read of ``(step, batch)`` pairs for one epoch — does
        NOT move the pipeline position (``commit`` does).  Resumable
        from any step; with ``num_workers`` the batches are assembled
        in the pool, ordered."""
        steps = self.sampler.iter_epoch(epoch, start_step)
        if self.num_workers > 0:
            if self._pool is None:
                self._pool = WorkerPool(self.num_workers,
                                        name=f"data-{self.name}")
            pairs = ((step, (sel, mask)) for step, sel, mask in steps)

            def build(pair):
                step, sel_mask = pair
                return step, self._build_batch(sel_mask)

            yield from self._pool.imap(
                build, pairs, on_depth=self._m["qdepth"].set)
        else:
            for step, sel, mask in steps:
                yield step, self._build_batch((sel, mask))

    # ------------------------------------------------------------ position
    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def step(self) -> int:
        return self._step

    def commit(self, epoch: int, step: int) -> None:
        """Move the position to ``(epoch, step)`` = the next batch to
        deliver; rolls into the next epoch at epoch end."""
        if step >= self.num_batches:
            epoch, step = epoch + 1, 0
        self._epoch, self._step = int(epoch), int(step)

    # ----------------------------------------------------------- iteration
    def __iter__(self) -> Iterator[Any]:
        """Yield the REMAINING batches of the current epoch, committing
        the position as each batch is handed out; at epoch end the
        position rolls to ``(epoch+1, 0)``.  ``for batch in pipeline:``
        therefore consumes exactly one (rest-of-)epoch per loop."""
        epoch = self._epoch
        t0 = time.perf_counter()
        for step, batch in self.iter_epoch(epoch, self._step):
            self._m["wait"].observe(time.perf_counter() - t0)
            self._m["batches"].inc()
            self.commit(epoch, step + 1)
            yield batch
            t0 = time.perf_counter()

    def __len__(self) -> int:
        return self.num_batches

    # -------------------------------------------------------- checkpointing
    def state_dict(self) -> Dict[str, Any]:
        """Position + the stream-identity fingerprint.  Restoring this
        into a pipeline with the same fingerprint resumes the exact
        batch stream at the exact next batch."""
        s = self.sampler
        return {
            "version": STATE_VERSION,
            "epoch": self._epoch,
            "step": self._step,
            "seed": s.seed,
            "shuffle": s.shuffle,
            "batch_size": s.batch_size,
            "shard_index": s.shard_index,
            "shard_count": s.shard_count,
            "num_records": s.num_records,
        }

    def load_state_dict(self, state: Dict[str, Any],
                        strict: bool = True) -> None:
        """Restore the position.  ``strict`` verifies the fingerprint —
        a checkpoint taken with a different seed/batch/shard geometry
        describes a DIFFERENT batch stream, and resuming it silently
        would skip and replay samples."""
        if int(state.get("version", 0)) != STATE_VERSION:
            raise ValueError(
                f"data pipeline state version "
                f"{state.get('version')!r} != {STATE_VERSION}")
        if strict:
            s = self.sampler
            mine = {"seed": s.seed, "shuffle": s.shuffle,
                    "batch_size": s.batch_size,
                    "shard_count": s.shard_count,
                    "num_records": s.num_records}
            diffs = {k: (state.get(k), v) for k, v in mine.items()
                     if int(state.get(k, v)) != int(v)}
            if diffs:
                raise ValueError(
                    "data pipeline state does not match this pipeline "
                    f"(checkpointed vs current): {diffs}; pass "
                    "strict=False to restore the position anyway")
        self._epoch = int(state["epoch"])
        self._step = int(state["step"])
        if self._step >= self.num_batches:
            self._epoch, self._step = self._epoch + 1, 0

    # ------------------------------------------------------------- cleanup
    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __enter__(self) -> "DataPipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
