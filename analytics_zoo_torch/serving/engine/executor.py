"""Executor layer: multi-model endpoint registry + bucket-padded
predict.

An :class:`Endpoint` maps a name to an ``InferenceModel`` (anything
with ``predict``; ``warm`` optional), its bucket ladder, top-N
config, and a per-endpoint group queue the batcher schedules across
with weighted round-robin.  :class:`ModelExecutor` runs one composed
batch: stack → pad to the smallest bucket that fits → predict →
top-N softmax postprocess → complete each request.

Buckets are the core of the latency story: instead of ONE padded
shape (always ``batch_size``), each endpoint keeps a small
ladder of batch sizes, every rung warmed at model load, so a partial
batch pays a partial predict — a lone request on a bucket-1 batch, not
a 31/32-padding full batch.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_torch.data.stages import pad_to_batch

log = logging.getLogger("analytics_zoo_torch.serving.engine")


def default_buckets(batch_size: int) -> Tuple[int, ...]:
    """The default ladder: powers of two up to ``batch_size``, plus
    ``batch_size`` itself — ≤ log2(bs)+1 warmed programs, every fill
    level within 2x of its bucket."""
    bs = max(int(batch_size), 1)
    out = []
    b = 1
    while b < bs:
        out.append(b)
        b *= 2
    out.append(bs)
    return tuple(out)


def bucket_for(buckets: Sequence[int], n: int) -> int:
    """Smallest ladder rung that fits ``n`` records — the one
    bucket-selection rule (shared by stateless endpoints and the
    decode slot pool, whose ladders come from the same
    ``parse_buckets``)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def parse_buckets(spec, batch_size: int) -> Tuple[int, ...]:
    """Normalize a bucket spec (``"1,4,16"`` / iterable / None):
    sorted, deduped, capped at ``batch_size``, and always containing
    ``batch_size`` so every composed batch has a rung that fits."""
    if spec in (None, "", ()):
        return default_buckets(batch_size)
    if isinstance(spec, str):
        spec = [s for s in spec.replace("x", ",").split(",")
                if s.strip()]
    buckets = sorted({int(b) for b in spec if int(b) > 0})
    buckets = [b for b in buckets if b <= batch_size]
    if not buckets or buckets[-1] != batch_size:
        buckets.append(int(batch_size))
    return tuple(buckets)


class Endpoint:
    """One served model and its engine-side state."""

    def __init__(self, name: str, model, *, top_n: int = 1,
                 buckets: Sequence[int] = (),
                 batch_size: Optional[int] = None,
                 input_shape=None, weight: int = 1):
        if batch_size is None:
            batch_size = max(buckets) if buckets else 4
        self.name = name
        self.model = model
        self.top_n = int(top_n)
        self.buckets = parse_buckets(buckets, int(batch_size))
        self.input_shape = (tuple(input_shape) if input_shape
                            else None)
        self.weight = max(int(weight), 1)
        #: FIFO of atomic request groups (the batcher owns the lock)
        self.queue: deque = deque()
        self.records_total = 0

    #: generative endpoints override (decode.GenerativeEndpoint) —
    #: the batcher routes on it without importing the decode module
    generative = False

    @property
    def has_work(self) -> bool:
        """Whether the scheduler should hand this endpoint a credit
        (generative endpoints also count active decode slots)."""
        return bool(self.queue)

    def bucket_for(self, n: int) -> int:
        """Smallest warmed bucket that fits ``n`` records."""
        return bucket_for(self.buckets, n)

    def warm(self) -> int:
        """Warm-start every bucket (no-op without a model ``warm``
        or a configured ``input_shape``).  Returns #buckets warmed —
        after a full warm, no fill level pays a first-call setup."""
        warm = getattr(self.model, "warm", None)
        if warm is None or self.input_shape is None:
            return 0
        warmed = 0
        for b in self.buckets:
            try:
                warmed += bool(warm(self.input_shape, b))
            except Exception:   # noqa: BLE001 — warm is best-effort
                log.exception("warm-up failed for endpoint %s "
                              "bucket %d", self.name, b)
        return warmed


class EndpointRegistry:
    """Name → :class:`Endpoint`; iteration order = registration order
    (the batcher's weighted round-robin is deterministic over it)."""

    def __init__(self):
        self._endpoints: Dict[str, Endpoint] = {}
        self._lock = threading.Lock()

    def register(self, name: str, model, **kwargs) -> Endpoint:
        return self.add(Endpoint(name, model, **kwargs))

    def add(self, ep: Endpoint) -> Endpoint:
        """Register a pre-built endpoint (how generative endpoints,
        which carry a decode slot pool, enter the registry)."""
        with self._lock:
            if ep.name in self._endpoints:
                raise ValueError(
                    f"serving endpoint {ep.name!r} already registered")
            self._endpoints[ep.name] = ep
        return ep

    def get(self, name: str) -> Optional[Endpoint]:
        with self._lock:
            return self._endpoints.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._endpoints)

    def __iter__(self) -> Iterator[Endpoint]:
        with self._lock:
            return iter(list(self._endpoints.values()))

    def __len__(self) -> int:
        with self._lock:
            return len(self._endpoints)

    def warm_all(self) -> Dict[str, int]:
        """Warm every endpoint's full bucket ladder; returns
        {endpoint: buckets warmed} and logs each endpoint's captured
        graphs (``aot_signatures`` of its model or decode pool)."""
        out = {}
        for ep in self:
            t0 = time.perf_counter()
            n = ep.warm()
            out[ep.name] = n
            if n:
                holder = getattr(ep, "pool", ep.model)
                log.info(
                    "endpoint %s: %d/%d buckets warm in %.2fs, %d captured "
                    "graphs (buckets=%s)", ep.name, n, len(ep.buckets),
                    time.perf_counter() - t0,
                    int(getattr(holder, "aot_signatures", 0)), ep.buckets)
        return out


class ModelExecutor:
    """Runs one composed batch for one endpoint and completes its
    requests.  Model/stack failures fail the batch's requests (the
    transports turn those into explicit error results) and never
    propagate — except process-fatal BaseExceptions, which the
    batcher re-raises after failing the requests."""

    def __init__(self):
        from analytics_zoo_torch.observability import (
            get_registry, get_tracer)
        self._tracer = get_tracer()
        reg = get_registry()
        # the SAME fill-ratio gauge as before the engine: real records over
        # the endpoint's full batch capacity (its largest bucket) —
        # the saturation signal the fleet autoscaler reads.  Bucket
        # padding waste is visible separately: bucket/records ride the
        # serving_execute span args.
        self._m_fill = reg.gauge(
            "serving_batch_fill_ratio",
            "real records / batch capacity of the last served batch")
        # monotonic batch id stamped on every request's batch_compose
        # station, so a waterfall can group co-riders of one device
        # batch across timelines
        self._batch_seq = 0

    def _mark_batch(self, requests: List, bucket: int,
                    real: int) -> None:
        """Station marks for a composed batch (no-op for untraced
        requests): ``batch_compose`` with batch id + fill ratio +
        co-rider count on the executor thread, closing the flow the
        transport thread opened at submit."""
        if not any(r.trace is not None for r in requests):
            return
        from analytics_zoo_torch.observability.reqtrace import (
            get_request_log)
        self._batch_seq += 1
        reqlog = get_request_log()
        for r in requests:
            tid = r.trace_id
            if not tid:
                continue
            self._tracer.flow_end("serving_request", tid)
            reqlog.mark(tid, "batch_compose", batch=self._batch_seq,
                        fill=round(real / bucket, 4),
                        co_riders=real - 1)

    def execute(self, ep: Endpoint, requests: List) -> int:
        real = len(requests)
        if real == 0:
            return 0
        try:
            bucket = ep.bucket_for(real)
            self._mark_batch(requests, bucket, real)
            x = pad_to_batch(np.stack([r.data for r in requests]),
                             bucket)
            self._m_fill.set(real / ep.buckets[-1])
            traced = [r for r in requests if r.trace_id]
            if traced:
                from analytics_zoo_torch.observability.reqtrace import (
                    get_request_log)
                reqlog = get_request_log()
                now = time.perf_counter()
                for r in traced:
                    reqlog.mark(r.trace_id, "dispatch", t=now,
                                bucket=bucket)
            with self._tracer.span(
                    "serving_execute", endpoint=ep.name, records=real,
                    bucket=bucket,
                    request_ids=[r.request_id for r in requests
                                 if r.request_id][:16]):
                out = np.asarray(ep.model.predict(x))[:real]
            if traced:
                now = time.perf_counter()
                for r in traced:
                    reqlog.mark(r.trace_id, "device_done", t=now)
            values = self.postprocess(out, ep.top_n)
        except Exception as e:
            log.exception("predict failed for endpoint %s "
                          "(%d records)", ep.name, real)
            for r in requests:
                r.fail(e)
            return 0
        for r, v in zip(requests, values):
            r.complete(v)
        ep.records_total += real
        return real

    def execute_decode(self, ep) -> int:
        """One decode-step scheduler iteration for a generative
        endpoint: step the active slots, retire EOS/budget-finished
        sequences, backfill freed slots from the queue — the stateful
        twin of :meth:`execute`.  Failure contract mirrors the
        stateless path: a model ``Exception`` fails exactly the
        sequences whose state shared the fused step program (the pool
        resets, the thread survives); a non-``Exception`` escape
        re-raises after failing them, so the Redis transport's loop
        dies with its batch un-acked — the PEL-reclaim trigger."""
        self._m_fill.set(ep.pool.active_count / ep.pool.capacity)
        try:
            with self._tracer.span(
                    "serving_decode_step", endpoint=ep.name,
                    active=ep.pool.active_count,
                    queued=len(ep.queue)):
                return ep.run_iteration()
        except Exception as e:
            log.exception("decode iteration failed for endpoint %s "
                          "(%d active)", ep.name,
                          ep.pool.active_count)
            ep.pool.fail_all(e)
            return 0
        except BaseException as e:   # noqa: BLE001 — process-death class
            ep.pool.fail_all(e)
            raise

    @staticmethod
    def postprocess(out: np.ndarray, top_n: int) -> List[List]:
        """Top-N softmax (the reference's PostProcessing.scala role):
        per record, ``[[class, prob], ...]`` descending."""
        exp = np.exp(out - out.max(axis=-1, keepdims=True))
        probs = exp / exp.sum(axis=-1, keepdims=True)
        top = np.argsort(-probs, axis=-1)[:, :top_n]
        return [[[int(i), float(p[i])] for i in t]
                for t, p in zip(top, probs)]
