"""Composable host-side batch stages + the shared worker pool (port of
the JAX package's ``data/stages.py``: numpy and threads only).

Reference: the MTSampleToMiniBatch worker threads that assemble
minibatches ahead of the training tasks (MTSampleToMiniBatch.scala:28)
and the Preprocessing ``->`` chains (Preprocessing.scala).  A stage is
``batch -> batch`` on HOST pytrees; chains run inside the pipeline's
worker pool, overlapping with device compute.

These primitives are deliberately framework-free so the serving path
reuses them: ``ClusterServing`` runs its record decode through the same
:class:`WorkerPool` / :func:`pad_to_batch` that train pipelines use.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

from analytics_zoo_torch.data.source import tree_map


class Stage:
    """One host-side batch transformation."""

    name = "stage"

    def __call__(self, batch: Any) -> Any:
        raise NotImplementedError


class MapStage(Stage):
    """Apply ``fn`` to the whole batch pytree (``fn(batch) -> batch``);
    with ``per_leaf=True`` apply it leaf-wise instead."""

    def __init__(self, fn: Callable, per_leaf: bool = False,
                 name: str = "map"):
        self.fn = fn
        self.per_leaf = per_leaf
        self.name = name

    def __call__(self, batch):
        if self.per_leaf:
            return tree_map(self.fn, batch)
        return self.fn(batch)


class TransformStage(Stage):
    """Run a ``feature.common.Preprocessing`` (or any callable) over
    the X half of an ``(x, y)`` batch — the migration bridge for
    ``FeatureSet.transform`` chains."""

    def __init__(self, preprocessing, name: str = "transform"):
        from analytics_zoo_torch.feature.common import Preprocessing
        self.fn = preprocessing.apply \
            if isinstance(preprocessing, Preprocessing) else preprocessing
        self.name = name

    def __call__(self, batch):
        if isinstance(batch, tuple) and len(batch) == 2:
            x, y = batch
            return (self.fn(x), y)
        return self.fn(batch)


class BatchStage(Stage):
    """Collate a SEQUENCE of per-record samples into one batched
    pytree (stacked leaves) — used by record-at-a-time sources
    (TFRecord) whose ``gather`` has no columnar fast path."""

    name = "batch"

    def __call__(self, samples: Sequence[Any]):
        return tree_map(
            lambda *leaves: np.stack([np.asarray(l) for l in leaves]),
            *samples)


def run_stages(batch: Any, stages: Sequence[Stage]) -> Any:
    for s in stages:
        batch = s(batch)
    return batch


def pad_to_batch(arr: np.ndarray, batch_size: int) -> np.ndarray:
    """Zero-pad rows up to ``batch_size`` so one compiled program
    serves every (possibly short) batch — shared by the serving
    batcher and the pipeline's pad-remainder mode."""
    real = len(arr)
    if real >= batch_size:
        return arr
    return np.concatenate(
        [arr, np.zeros((batch_size - real,) + arr.shape[1:], arr.dtype)])


class WorkerPool:
    """A small named thread pool with an ORDERED pull-ahead map — the
    multi-threaded stage engine (host stages release the GIL inside
    numpy, so threads genuinely overlap; process isolation is not
    worth the pickling for columnar batches).

    ``imap(fn, it, depth)`` keeps up to ``depth`` items in flight and
    yields results strictly in input order — exactly the contract a
    deterministic pipeline needs (parallelism must never reorder the
    batch stream) and the one the serving loop needs (results ack in
    stream order).
    """

    def __init__(self, workers: int = 2, name: str = "data-worker"):
        self.workers = max(int(workers), 1)
        self._pool = ThreadPoolExecutor(self.workers,
                                        thread_name_prefix=name)
        self._closed = False

    def submit(self, fn: Callable, *args) -> Future:
        return self._pool.submit(fn, *args)

    def imap(self, fn: Callable, items: Iterable, depth: Optional[int]
             = None, on_depth: Optional[Callable[[int], None]] = None
             ) -> Iterator:
        """Ordered parallel map: results come back in input order with
        at most ``depth`` (default ``2 x workers``) in flight.
        ``on_depth`` (if given) observes the in-flight count before
        each result is handed out — the worker-queue-depth gauge."""
        if depth is None:
            depth = 2 * self.workers
        depth = max(int(depth), 1)
        from collections import deque
        inflight: deque = deque()
        it = iter(items)
        try:
            while True:
                while len(inflight) < depth:
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    inflight.append(self._pool.submit(fn, item))
                if not inflight:
                    if on_depth is not None:
                        on_depth(0)
                    return
                if on_depth is not None:
                    on_depth(len(inflight))
                yield inflight.popleft().result()
        finally:
            for f in inflight:
                f.cancel()

    def shutdown(self, wait: bool = False) -> None:
        # no closed-guard: Executor.shutdown is itself thread-safe and
        # idempotent, so a check-then-act here would only add a window
        # where two closers race on the flag
        self._closed = True
        self._pool.shutdown(wait=wait)

    close = shutdown

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown()


class PrefetchIterator:
    """Background-thread prefetch over any iterator with queue-depth
    and wait-time instrumentation fed by the caller.

    The generic engine under both ``DataPipeline`` host prefetch and
    ``DeviceLoader`` double-buffering: a daemon thread pulls from
    ``source_iter`` (optionally mapping ``fn`` over each item — e.g.
    the H2D placement) into a bounded queue; exceptions propagate to
    the consumer; the consumer stops early by just abandoning the
    iterator (daemon thread + bounded queue => no leak beyond ``depth``
    buffered items).
    """

    _END = object()

    def __init__(self, source_iter: Iterable, depth: int,
                 fn: Optional[Callable] = None,
                 on_depth: Optional[Callable[[int], None]] = None):
        self.depth = max(int(depth), 1)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._on_depth = on_depth
        self._fn = fn
        self._src = source_iter
        self._abort = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that gives up when the consumer aborted —
        q.put would otherwise block this thread forever (pinning the
        buffered items, which on the DeviceLoader path are
        device-RESIDENT batches) if the consumer walks away
        mid-epoch."""
        while not self._abort.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for item in self._src:
                if self._fn is not None:
                    item = self._fn(item)
                if not self._put(item):
                    return
            self._put(self._END)
        except BaseException as e:   # propagate into the consumer
            self._put(e)

    def close(self) -> None:
        """Stop the worker and release everything it buffered.  Called
        by the consumer when it stops early (e.g. an end-trigger
        firing mid-epoch); idempotent."""
        self._abort.set()
        while True:   # unblock + drop buffered items
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __iter__(self):
        return self

    def __next__(self):
        # depth sampled BEFORE the dequeue so a full steady-state
        # pipeline reads `depth`, not depth-1 (same convention as
        # trainer.prefetch)
        if self._on_depth is not None:
            self._on_depth(self._q.qsize())
        item = self._q.get()
        if item is self._END:
            if self._on_depth is not None:
                self._on_depth(0)
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item
