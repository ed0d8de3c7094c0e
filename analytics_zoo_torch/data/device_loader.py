"""DeviceLoader — double-buffered host→device feeding (port of the JAX
package's ``data/device_loader.py``).

Reference: the prefetch queue bolted onto ``DistributedTrainer``
(``Trainer.prefetch``, the MTSampleToMiniBatch analogue), promoted to a
first-class pipeline component: a background thread pulls host batches
from a :class:`DataPipeline` (a PURE read — no position movement),
places them on the device (``put_fn`` — ``DistributedTrainer.put_batch``
when training, ``parallel.trainer.put_on_device`` onto the zoo context's
device otherwise) and keeps ``depth`` batches in flight, so the
host-to-device copy overlaps the steps.  The loader feeds the ``train_prefetch_queue_depth`` gauge
and the step-attribution histogram's ``data_wait`` component, and
commits the pipeline position ONLY as batches are handed to the caller
— the property that makes a mid-epoch checkpoint exact even with
batches in flight.

On the card the placing thread issues its copies on the stream that was
current in the consuming thread when the epoch began (the stream the
steps, captured replays included, run on), so a step that reads a batch
is ordered after its copy on one stream, with no event to wait on.  Each
copy stages through its own pinned block (``pin_memory``): PyTorch's
caching host allocator records the copy's stream and hands the block out
again only after that copy has completed, so two batches never share a
staging buffer still in flight.  CUDA's current device is per thread:
the thread places under ``torch.cuda.device``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Iterator, Optional

from analytics_zoo_torch.data.pipeline import DataPipeline
from analytics_zoo_torch.data.stages import PrefetchIterator
from analytics_zoo_torch.observability import get_registry
from analytics_zoo_torch.observability.diagnostics import (
    step_attribution_histogram)
from analytics_zoo_torch.resilience.chaos import (
    SITE_DATA_BATCH, active_chaos)


class DeviceLoader:
    """Iterate a pipeline's epochs as DEVICE-resident batches.

    ``depth`` (default ``data.prefetch``) batches are placed ahead on a
    thread; ``depth=2`` is classic double buffering: batch ``k+1``
    transfers while batch ``k`` computes.  Depth 0 places each batch
    synchronously in the consuming thread.  Batches land on the zoo
    context's device.
    """

    def __init__(self, pipeline: DataPipeline,
                 put_fn: Optional[Callable] = None,
                 depth: Optional[int] = None):
        from analytics_zoo_torch.common.config import get_config
        from analytics_zoo_torch.common.zoo_context import get_zoo_context
        if depth is None:
            depth = int(get_config().get("data.prefetch"))
        device = get_zoo_context().device
        if put_fn is None:
            from analytics_zoo_torch.parallel.trainer import put_on_device

            def put_fn(batch):
                return put_on_device(batch, device)
        self.pipeline = pipeline
        self.device = device
        self.put_fn = put_fn
        self.depth = max(int(depth), 0)
        self._m_depth = get_registry().gauge(
            "train_prefetch_queue_depth",
            "device-placed batches waiting in the prefetch queue")
        # step-time attribution: the loader is the training loop's
        # data_wait producer on the DataPipeline path
        self._m_wait = step_attribution_histogram().labels("data_wait")

    def _placing_context(self):
        """The placing thread's CUDA device and stream: the consumer's
        current stream at the epoch's start."""
        if self.device.type != "cuda":
            return contextlib.nullcontext
        import torch
        stream = torch.cuda.current_stream(self.device)

        @contextlib.contextmanager
        def ctx():
            with torch.cuda.device(self.device), torch.cuda.stream(stream):
                yield
        return ctx

    def epoch(self) -> Iterator[Any]:
        """Yield device batches for the pipeline's current epoch from
        its current step; the pipeline position commits per yielded
        batch (exact-resume contract) and rolls to the next epoch at
        the end."""
        pipe = self.pipeline
        epoch, start = pipe.epoch, pipe.step
        placing = self._placing_context()

        def place(pair):
            step, batch = pair
            with placing():
                return step, self.put_fn(batch)

        if self.depth <= 0:   # synchronous
            placed: Iterator = map(place, pipe.iter_epoch(epoch, start))
        else:
            placed = PrefetchIterator(
                pipe.iter_epoch(epoch, start), self.depth, fn=place,
                on_depth=self._m_depth.set)
        t0 = time.perf_counter()
        chaos = active_chaos()
        try:
            for step, batch in placed:
                if chaos is not None:
                    # fault-injection site, keyed on the pipeline's
                    # epoch step index, tripped BEFORE the position
                    # commits: an injected input-side failure never
                    # skips the batch it interrupted
                    chaos.trip(SITE_DATA_BATCH, step)
                # feed the pipeline's own batch counter / wait
                # histogram — device-fed consumption is still pipeline
                # consumption — plus the step-attribution data_wait
                # component
                wait = time.perf_counter() - t0
                pipe._m["wait"].observe(wait)
                self._m_wait.observe(wait)
                pipe._m["batches"].inc()
                pipe.commit(epoch, step + 1)
                yield batch
                t0 = time.perf_counter()
        finally:
            # a consumer stopping mid-epoch (end trigger, retry
            # restore, exception) must release the prefetch thread and
            # the device batches it buffered
            if isinstance(placed, PrefetchIterator):
                placed.close()

    def __iter__(self) -> Iterator[Any]:
        return self.epoch()
