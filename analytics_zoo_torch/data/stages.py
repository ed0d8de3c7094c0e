"""The two host-side stages the serving path shares with a training
input pipeline (port of ``data/stages.py``'s ``pad_to_batch`` and
``WorkerPool``; numpy and threads only).

Reference: the MTSampleToMiniBatch worker threads that assemble
minibatches ahead of the training tasks (MTSampleToMiniBatch.scala:28).
``ClusterServing`` runs its record decode through :class:`WorkerPool`
and the executor pads each batch with :func:`pad_to_batch`.  The stage
chains over batch trees (``MapStage``, ``TransformStage``,
``BatchStage``, ``WorkerPool.imap``) come with the data slice (NCF,
ROADMAP.md, queue 1).
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable

import numpy as np


def pad_to_batch(arr: np.ndarray, batch_size: int) -> np.ndarray:
    """Zero-pad rows up to ``batch_size`` so one batch shape serves
    every (possibly short) batch — the serving executor pads a composed
    batch to its bucket."""
    real = len(arr)
    if real >= batch_size:
        return arr
    return np.concatenate(
        [arr, np.zeros((batch_size - real,) + arr.shape[1:], arr.dtype)])


class WorkerPool:
    """A small named thread pool (host stages release the GIL inside
    numpy, so threads genuinely overlap the device)."""

    def __init__(self, workers: int = 2, name: str = "data-worker"):
        self.workers = max(int(workers), 1)
        self._pool = ThreadPoolExecutor(self.workers,
                                        thread_name_prefix=name)

    def submit(self, fn: Callable, *args) -> Future:
        return self._pool.submit(fn, *args)

    def shutdown(self, wait: bool = False) -> None:
        # Executor.shutdown is itself thread-safe and idempotent
        self._pool.shutdown(wait=wait)

    close = shutdown
