"""Continuous (in-flight) batcher — the middle layer of the serving
engine.

The earlier loop predicted one full ``batch_size`` read at a time: a
lone request waited for the stream read to time out, and a burst
arriving mid-predict waited a whole predict before even being read.
Here the executor is never idle while work is queued: the moment it
frees, a batch is formed from whatever is queued for one endpoint and
padded UP to the nearest warmed bucket size (see
``executor.default_buckets``) — partial batches dispatch immediately
under backlog, so tail latency tracks the device, not the batch
knob.

Requests arrive in *groups* (a Redis bulk read is one group, an HTTP
request is a group of one).  Groups are atomic: a group is never
split across device batches, so the Redis path's batch-scoped
semantics (ack-after-serve, poison-batch error results) survive the
decomposition unchanged, while separate groups DO co-ride one device
batch — the continuous-batching win.

The ``max_wait_ms`` knob applies only on the empty→non-empty edge
(the executor was idle with nothing queued): the first arrivals may
wait up to ``max_wait_ms`` (from the oldest arrival) for co-riders to
fill toward the largest bucket, and are dispatched the moment either
the bucket fills or the deadline passes — a lone request is always
served within ``max_wait_ms`` of arrival plus one predict.  When work
was already queued as the executor freed (the loaded case), dispatch
is immediate and the knob never adds latency.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, List, Optional, Sequence

log = logging.getLogger("analytics_zoo_torch.serving.engine")


class ShedError(TimeoutError):
    """Admission control dropped the request before it burned device
    capacity (deadline passed while queued).  A ``TimeoutError``
    subclass on purpose: the HTTP transport's status mapping answers
    504 for the timeout class, and the message carries the ``shed:``
    marker clients and the loadgen verdict key on.  ``age_ms`` /
    ``deadline_ms`` carry the justification so the Redis transport
    can dead-letter the shed with the same evidence fields the
    stream-path shed records (the verdict proves every shed was
    deadline-earned from exactly these)."""

    def __init__(self, message: str, age_ms: float = 0.0,
                 deadline_ms: float = 0.0):
        super().__init__(message)
        self.age_ms = float(age_ms)
        self.deadline_ms = float(deadline_ms)


@dataclasses.dataclass
class Request:
    """One record flowing through the engine, transport-agnostic.

    The transport that created it blocks on :meth:`wait` (HTTP
    handler thread, or the Redis loop waiting for a submitted bulk
    group) and reads ``result`` / ``error`` after completion."""
    endpoint: str
    uri: str
    data: Any                       # per-record ndarray (no batch dim)
    request_id: Optional[str] = None
    arrival: float = 0.0            # time.perf_counter() at ingress
    result: Any = None
    error: Optional[BaseException] = None
    #: generative-only: per-sequence token budget (clamped to the
    #: endpoint's max_seq_len; None = the endpoint default)
    max_tokens: Optional[int] = None
    #: generative-only: called (index, token) from the scheduler
    #: thread the moment each token is emitted — the per-token
    #: streaming hook.  Must be fast and never raise (it runs between
    #: decode iterations); errors are swallowed.
    on_token: Optional[Any] = None
    #: request-scoped tracing context (observability.reqtrace): a
    #: TraceContext (or bare trace_id) the transport decoded from the
    #: wire; None = untraced.  The batcher/executor/decode layers mark
    #: their lifecycle stations against it.
    trace: Optional[Any] = None
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)

    @property
    def trace_id(self) -> Optional[str]:
        if self.trace is None:
            return None
        if isinstance(self.trace, str):
            return self.trace
        return getattr(self.trace, "trace_id", None)

    def complete(self, result: Any) -> None:
        self.result = result
        self._done.set()

    def fail(self, exc: BaseException) -> None:
        self.error = exc
        self._done.set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        """Block until completed; False on timeout (the request may
        still complete later — the caller decides whether to treat
        that as an error)."""
        return self._done.wait(timeout_s)


class ContinuousBatcher:
    """One executor thread draining per-endpoint group queues.

    All queue state is guarded by one condition variable; predict runs
    OUTSIDE the lock (the device predict releases the GIL, so transports
    keep submitting while the device works).  A failure inside an
    execution fails that batch's requests and never kills the thread —
    the engine twin of the serving loop's poison contract."""

    def __init__(self, registry, executor,
                 max_wait_ms: float = 0.0,
                 clock=time.perf_counter):
        from analytics_zoo_torch.observability import get_registry
        self.registry = registry          # EndpointRegistry
        self.executor = executor          # ModelExecutor
        self.max_wait_ms = max(float(max_wait_ms), 0.0)
        self._clock = clock
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # deterministic weighted scheduling state: endpoint -> credit
        self._credit = {}
        self.batches_dispatched = 0
        reg = get_registry()
        self._m_inflight = reg.gauge(
            "serving_inflight_batches",
            "batches currently executing on the device")
        self._m_wait = reg.histogram(
            "serving_batch_wait_seconds",
            "oldest-request queue wait at batch dispatch")
        self._m_requests = reg.counter(
            "serving_endpoint_requests_total",
            "requests submitted per serving endpoint",
            labels=("endpoint",))

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ContinuousBatcher":
        """Idempotent: a live thread is reused, a stopped batcher
        restarts (``ClusterServing.close()`` + a later ``run()`` is a
        supported sequence)."""
        with self._cv:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="zoo-serving-batcher")
            self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        t = self._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout_s)

    @property
    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # -------------------------------------------------------------- ingress
    def submit(self, requests: Sequence[Request],
               _now: Optional[float] = None) -> List[Request]:
        """Enqueue one atomic group (all requests must share one
        endpoint).  Unknown endpoints fail the whole group immediately
        — the transport writes the error result, nothing is silently
        dropped.  Returns the requests for wait-all convenience."""
        requests = list(requests)
        if not requests:
            return requests
        name = requests[0].endpoint
        now = self._clock() if _now is None else _now
        for r in requests:
            if not r.arrival:
                r.arrival = now
        ep = self.registry.get(name)
        if ep is None or any(r.endpoint != name for r in requests):
            exc = KeyError(
                f"unknown serving endpoint {name!r} (registered: "
                f"{sorted(self.registry.names())})")
            for r in requests:
                r.fail(exc if r.endpoint == name else KeyError(
                    "mixed endpoints in one submitted group"))
            return requests
        self._m_requests.labels(name).inc(len(requests))
        if any(r.trace is not None for r in requests):
            from analytics_zoo_torch.observability.reqtrace import (
                get_request_log)
            from analytics_zoo_torch.observability.tracing import (
                get_tracer)
            reqlog = get_request_log()
            tracer = get_tracer()
            for r in requests:
                tid = r.trace_id
                if not tid:
                    continue
                reqlog.mark(tid, "batch_queue_enter", t=now,
                            endpoint=name)
                # flow OUT of the transport thread's slice; the
                # executor thread closes it at batch compose, giving
                # Perfetto its causal arrow across the two lanes
                tracer.flow_start("serving_request", tid)
        # groups larger than the endpoint's largest bucket are split
        # into bucket-sized atomic chunks (each chunk still serves
        # together; the transport's wait-all covers all chunks).
        # Generative sequences queue individually: slot-pool admission
        # is per sequence (a half-free pool admits half a group and
        # keeps the rest queued), and completion is per sequence too —
        # the transport's wait-all, not co-location, carries the
        # group's ack semantics.
        cap = 1 if ep.generative else ep.buckets[-1]
        with self._cv:
            for lo in range(0, len(requests), cap):
                ep.queue.append(requests[lo:lo + cap])
            self._cv.notify_all()
        return requests

    def submit_one(self, request: Request) -> Request:
        self.submit([request])
        return request

    # ----------------------------------------------------------- scheduling
    def _pick_endpoint(self):
        """Deterministic weighted round-robin over endpoints with
        queued work: every pick debits one credit; when every pending
        endpoint is out of credit, all credits refill to the weights.
        An endpoint with weight 2 gets two batches for every one of a
        weight-1 peer under contention, and never starves anyone."""
        pending = [ep for ep in self.registry if ep.has_work]
        if not pending:
            return None
        for ep in pending:
            self._credit.setdefault(ep.name, ep.weight)
        funded = [ep for ep in pending if self._credit[ep.name] > 0]
        if not funded:
            for ep in pending:
                self._credit[ep.name] = ep.weight
            funded = pending
        ep = funded[0]
        self._credit[ep.name] -= 1
        return ep

    def _compose(self, ep) -> List[Request]:
        """Pop whole groups for ``ep`` into one device batch: groups
        are taken in arrival order while they fit under the largest
        bucket AND share the first group's per-record shape/dtype (a
        mismatched group cannot np.stack with the rest — it waits for
        its own batch instead of poisoning this one).  Requests that
        already completed while queued — a transport timed them out
        and answered their client with an error — are dropped here:
        predicting them would amplify load exactly when the executor
        is already behind."""
        batch: List[Request] = []
        cap = ep.buckets[-1]
        key = None
        while ep.queue:
            group = [r for r in ep.queue[0] if not r.done]
            if not group:
                ep.queue.popleft()
                continue
            gkey = self._shape_key(group)
            if key is None:
                key = gkey
            elif gkey != key:
                break
            if batch and len(batch) + len(group) > cap:
                break
            ep.queue.popleft()
            batch.extend(group)
        return batch

    @staticmethod
    def _shape_key(group):
        try:
            a = group[0].data
            return (tuple(getattr(a, "shape", ())),
                    str(getattr(a, "dtype", "")))
        except Exception:   # noqa: BLE001 — exotic payloads still batch
            return ("?",)

    def _queued_for(self, ep) -> int:
        return sum(len(g) for g in ep.queue)

    def _any_bucket_full(self) -> bool:
        """Does ANY endpoint have a largest-bucket's worth queued?
        Ends the idle-edge fill-wait: a full bucket anywhere beats
        waiting out one endpoint's co-rider timer."""
        return any(self._queued_for(e) >= e.buckets[-1]
                   for e in self.registry if e.queue)

    def _generative_pending(self) -> bool:
        """Any generative endpoint with work ALSO ends the fill-wait:
        a sequence's first token must never sit behind a stateless
        peer's co-rider timer (generative endpoints themselves never
        fill-wait, and that guarantee has to hold when a stateless
        endpoint grabbed the idle edge first)."""
        return any(e.generative and e.has_work for e in self.registry)

    # ------------------------------------------------------------ main loop
    def _loop(self) -> None:
        # whether the previous iteration dispatched a batch: work
        # found right after an execution accumulated WHILE the device
        # was busy and dispatches immediately (the continuous-batching
        # property); work found any other way — batcher just started,
        # or woke from an empty-queue idle — is on the idle edge,
        # where max_wait gives co-riders a chance to fill a bucket
        just_executed = False
        while not self._stop.is_set():
            with self._cv:
                ep = self._pick_endpoint()
                if ep is None:
                    # executor idle, nothing queued: sleep until a
                    # submit notifies
                    just_executed = False
                    self._cv.wait(0.5)
                    ep = self._pick_endpoint()
                    if ep is None:
                        continue
                if ep.generative:
                    # generative endpoints never fill-wait: between
                    # decode iterations every queued sequence is a
                    # backfill candidate anyway, and a timer here
                    # would tax inter-token latency, the metric the
                    # decode scheduler exists to protect
                    pass
                elif not just_executed and self.max_wait_ms > 0.0:
                    # the idle edge: the first arrivals may wait
                    # (from the OLDEST queued arrival) for co-riders
                    # toward the largest bucket — ending the moment
                    # ANY endpoint has a full bucket queued, so a
                    # burst for a peer endpoint never idles the
                    # executor behind one endpoint's lone-request
                    # timer
                    deadline = (min(r.arrival for g in ep.queue
                                    for r in g)
                                + self.max_wait_ms / 1000.0)
                    while not self._stop.is_set() \
                            and not self._any_bucket_full() \
                            and not self._generative_pending():
                        remaining = deadline - self._clock()
                        if remaining <= 0:
                            break
                        self._cv.wait(min(remaining, 0.05))
                if self._stop.is_set():
                    break
                # dispatch NOW, partial or not
                batch = [] if ep.generative else self._compose(ep)
            if ep.generative:
                # one decode ITERATION per scheduling credit: step
                # the active slots, retire finished sequences,
                # backfill from the queue — then fall back into the
                # scheduler so stateless peers interleave per
                # iteration, not per sequence
                self._execute_decode(ep)
                just_executed = True
                continue
            if not batch:
                continue
            self._m_wait.observe(
                max(self._clock() - min(r.arrival for r in batch),
                    0.0))
            self._execute(ep, batch)
            just_executed = True

    def _execute_decode(self, ep) -> None:
        """One generative scheduler iteration under the same
        thread-survival guard as :meth:`_execute`: the executor
        already failed the active sequences on any escape (and reset
        the pool), so this only has to keep the batcher alive."""
        self._m_inflight.set(1)
        try:
            self.executor.execute_decode(ep)
        except BaseException:   # noqa: BLE001 — poison contract
            log.exception("decode iteration escaped for endpoint %s; "
                          "failed sequences carry the error to their "
                          "transports", ep.name)
        finally:
            self._m_inflight.set(0)
            self.batches_dispatched += 1

    def _execute(self, ep, batch: List[Request]) -> None:
        self._m_inflight.set(1)
        try:
            self.executor.execute(ep, batch)
        except BaseException as e:   # noqa: BLE001 — poison contract
            # the executor already fails requests on model errors;
            # this catches executor-level surprises — INCLUDING the
            # non-Exception process-death class — so the batcher
            # thread survives.  The failed requests carry the
            # exception to their transports, and the Redis transport
            # re-raises non-Exception escapes so its loop dies with
            # the batch un-acked (the PEL-reclaim contract); actual
            # process kills (os._exit, signals) never reach here.
            for r in batch:
                if not r.done:
                    r.fail(e)
            log.exception("batch execution failed (%d records, "
                          "endpoint %s)", len(batch), ep.name)
        finally:
            self._m_inflight.set(0)
            self.batches_dispatched += 1
