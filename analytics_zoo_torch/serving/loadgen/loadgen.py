"""Open-loop, coordinated-omission-safe load generator.

Every serving bench before this module was **closed-loop**: a client
submits, waits for the response, then submits again.  A closed-loop
client slows down exactly when the server does — during the stall the
client simply issues fewer requests, so the stall's cost lands on a
handful of samples instead of on every request a real user would have
sent on schedule.  That measurement artifact is *coordinated omission*
(Tene's hiccup analysis), and it is how a fleet "passes" a latency SLO
it would miss in production.

This generator is **open-loop**: requests fire at their *scheduled*
timestamp regardless of how many responses are outstanding, and every
latency is measured **from the scheduled time** — the moment a real
user would have clicked — not from the moment an unblocked client
thread finally got around to sending.  Both numbers are recorded
(``latency_from_scheduled_s`` / ``latency_from_sent_s``) so the gap
itself is observable: under a stalled server the scheduled-basis p99
grows with the stall while the sent-basis p99 stays flat, and the SLO
verdict (``loadgen.verdict``) deliberately reads the former.

Transports (mirroring the serving engine's ingress surface):

* ``redis``    — the bulk path: XADD onto ``serving_stream`` with a
  ``request_id``, results collected by ONE shared poller thread over
  the ``result:<uri>`` hashes (senders never block on responses — the
  open-loop property);
* ``http``     — the fast path: ``POST /predict/<endpoint>``, one
  sender thread held per in-flight request (the transport's own
  concurrency model);
* ``generate`` — the streaming path: ``POST /generate/<endpoint>``
  with per-token timestamps (``first_byte`` = first token on the
  wire).

Request *kinds* let scenarios script hostile traffic: ``ok`` (a
well-formed payload), ``poison`` (the process-killing payload class
the quarantine machinery exists for), ``malformed`` (undecodable
bytes — the decode-error path).

Per-request structured log: scheduled / sent / first-byte / done
monotonic timestamps + terminal status (``ok`` | ``error`` | ``shed``
| ``quarantined`` | ``lost`` | ``send_failed``), exportable as JSONL.
The clock is injectable so scenario engines and tests can anchor
timelines deterministically.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import logging
import queue as _queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_torch.observability.reqtrace import (
    TRACE_FIELD, TRACE_HEADER, TraceContext)

log = logging.getLogger("analytics_zoo_torch.serving.loadgen")

#: terminal statuses a record can end in.  ``lost`` (no result before
#: the per-request timeout) and ``send_failed`` (the send never landed
#: inside its retry budget) are the exactly-once violations the
#: verdict hunts; ``shed``/``quarantined`` are *deliberate* server
#: drops that must each be justified by a dead-letter record.
TERMINAL = ("ok", "error", "shed", "quarantined", "lost",
            "send_failed")


@dataclasses.dataclass
class ScheduledRequest:
    """One planned request: WHEN (offset from run start), WHERE
    (endpoint + transport), and WHAT (kind)."""
    offset_s: float
    endpoint: str = "default"
    transport: str = "redis"          # redis | http | generate
    kind: str = "ok"                  # ok | poison | malformed
    uri: str = ""
    request_id: str = ""
    max_tokens: Optional[int] = None
    phase: str = ""

    def __post_init__(self):
        import uuid
        if not self.request_id:
            self.request_id = uuid.uuid4().hex
        if not self.uri:
            self.uri = f"lg-{self.request_id[:12]}"


@dataclasses.dataclass
class RequestRecord:
    """One request's observed life.  All timestamps are the loadgen
    clock (monotonic by default); ``scheduled`` is the PLANNED fire
    time — latency from it charges dispatcher/sender lag to the
    server-facing number, which is the whole point."""
    spec: ScheduledRequest
    scheduled: float = 0.0
    sent: Optional[float] = None
    first_byte: Optional[float] = None
    done: Optional[float] = None
    status: str = "pending"
    error: str = ""
    tokens: int = 0

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL

    @property
    def trace_id(self) -> str:
        # request_id is uuid4().hex, which is already a valid 32-hex
        # trace id — the loadgen stamps it verbatim on the wire, so
        # the id in this record joins directly against the serving
        # plane's /requests.json timelines.
        return self.spec.request_id

    @property
    def latency_from_scheduled_s(self) -> Optional[float]:
        if self.done is None:
            return None
        return max(self.done - self.scheduled, 0.0)

    @property
    def latency_from_sent_s(self) -> Optional[float]:
        if self.done is None or self.sent is None:
            return None
        return max(self.done - self.sent, 0.0)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "request_id": self.spec.request_id,
            "trace_id": self.trace_id,
            "uri": self.spec.uri,
            "endpoint": self.spec.endpoint,
            "transport": self.spec.transport,
            "kind": self.spec.kind,
            "phase": self.spec.phase,
            "offset_s": round(self.spec.offset_s, 6),
            "scheduled": self.scheduled,
            "sent": self.sent,
            "first_byte": self.first_byte,
            "done": self.done,
            "status": self.status,
            "error": self.error,
            "tokens": self.tokens,
        }


class PayloadFactory:
    """Builds the wire payload for each request kind.  ``shape`` is
    the stateless per-record input shape; generative requests get an
    int token row of ``enc_len``.  Poison follows the fleet-test
    contract (values > 1e8 kill a ``PoisonSensitiveModel`` replica);
    malformed is undecodable on purpose."""

    def __init__(self, shape: Sequence[int] = (4,),
                 poison_value: float = 1e9, enc_len: int = 8,
                 vocab: int = 64, seed: int = 0):
        self.shape = tuple(shape)
        self.poison_value = float(poison_value)
        self.enc_len = int(enc_len)
        self.vocab = int(vocab)
        self._rng = np.random.RandomState(seed)

    def array(self, spec: ScheduledRequest) -> np.ndarray:
        if spec.transport == "generate":
            return self._rng.randint(
                3, self.vocab, (self.enc_len,)).astype(np.int32)
        if spec.kind == "poison":
            return np.full(self.shape, self.poison_value, np.float32)
        return np.zeros(self.shape, np.float32)

    def redis_fields(self, spec: ScheduledRequest) -> Dict[str, Any]:
        fields: Dict[str, Any] = {"uri": spec.uri,
                                  "request_id": spec.request_id}
        if spec.kind == "malformed":
            # not valid base64-of-npy: the server's decode pool fails
            # it and the serve path writes an explicit error result
            fields["data"] = b"!!this-is-not-an-ndarray!!"
        else:
            buf = io.BytesIO()
            np.save(buf, np.ascontiguousarray(self.array(spec)),
                    allow_pickle=False)
            fields["data"] = base64.b64encode(buf.getvalue())
        if spec.endpoint and spec.endpoint != "default":
            fields["endpoint"] = spec.endpoint
        if spec.max_tokens:
            fields["max_tokens"] = str(int(spec.max_tokens))
        # trace context rides the record itself; the fields dict is
        # built ONCE per request, so a send retry after a broker
        # outage re-sends the byte-identical wire value
        fields[TRACE_FIELD] = TraceContext.new(
            spec.request_id).to_wire()
        return fields

    def http_body(self, spec: ScheduledRequest) -> bytes:
        if spec.kind == "malformed":
            return b"{this is not json"
        arr = self.array(spec)
        return json.dumps({
            "data": arr.tolist(), "dtype": str(arr.dtype),
            "uri": spec.uri, "request_id": spec.request_id,
        }).encode()


class LoadgenRun:
    """The finished run: the record log plus the clock anchors that
    let the verdict join monotonic loadgen timestamps against the
    fleet's wall-clock trajectory."""

    def __init__(self, records: List[RequestRecord],
                 started_monotonic: float, started_wall: float,
                 finished_monotonic: float):
        self.records = records
        self.started_monotonic = started_monotonic
        self.started_wall = started_wall
        self.finished_monotonic = finished_monotonic

    @property
    def wall_s(self) -> float:
        return self.finished_monotonic - self.started_monotonic

    def wall_of(self, monotonic_t: float) -> float:
        """Convert a run-clock timestamp to wall time (for joining
        against supervisor trajectories, which stamp time.time())."""
        return self.started_wall + (monotonic_t
                                    - self.started_monotonic)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records:
            out[r.status] = out.get(r.status, 0) + 1
        return out

    def latencies(self, basis: str = "scheduled",
                  predicate: Optional[Callable[[RequestRecord], bool]]
                  = None) -> List[float]:
        out = []
        for r in self.records:
            if predicate is not None and not predicate(r):
                continue
            lat = (r.latency_from_scheduled_s if basis == "scheduled"
                   else r.latency_from_sent_s)
            if lat is not None:
                out.append(lat)
        return sorted(out)

    def percentile(self, p: float, basis: str = "scheduled",
                   predicate=None) -> float:
        lat = self.latencies(basis, predicate)
        if not lat:
            return 0.0
        return lat[min(int(p / 100.0 * len(lat)), len(lat) - 1)]

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(json.dumps({
                "started_wall": self.started_wall,
                "started_monotonic": self.started_monotonic,
                "finished_monotonic": self.finished_monotonic,
            }) + "\n")
            for r in self.records:
                f.write(json.dumps(r.to_dict()) + "\n")


def _classify_error_result(text: str) -> str:
    """Map a server error-result string onto a terminal status: the
    serve path writes ``shed: ...`` for admission drops, ``poison:
    quarantined ...`` for quarantines, and ``ShedError: ...`` for
    engine-level generative sheds."""
    low = (text or "").lower()
    if "shed" in low:
        return "shed"
    if "quarantin" in low:
        return "quarantined"
    return "error"


class LoadGenerator:
    """Arrival-schedule-driven request injection.

    * ``broker_factory`` — zero-arg callable returning a broker
      connection (one per internal thread: RESP sockets are not
      thread-safe).  Pass ``lambda: broker`` for an embedded broker.
    * ``http_url`` — base URL of the HTTP fast path (required when the
      schedule contains ``http``/``generate`` requests).
    * ``senders`` — sender-pool size.  Redis sends are non-blocking
      (enqueue only), so a small pool keeps up; HTTP/generate hold a
      sender per in-flight request.  ``senders=1`` deliberately
      recreates a coordinated (blocking) client — the configuration
      the coordinated-omission test uses to show what the scheduled
      basis catches and the sent basis hides.
    * ``events`` — ``[(offset_s, callable)]`` merged into the dispatch
      timeline: chaos windows, broker outages, replica kills fire in
      deterministic order relative to the traffic around them.
    """

    def __init__(self, schedule: Sequence[ScheduledRequest], *,
                 broker_factory: Optional[Callable[[], Any]] = None,
                 http_url: Optional[str] = None,
                 payloads: Optional[PayloadFactory] = None,
                 result_timeout_s: float = 30.0,
                 senders: int = 16,
                 send_retry_s: float = 5.0,
                 poll_interval_s: float = 0.02,
                 http_retries: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.schedule = sorted(schedule, key=lambda s: s.offset_s)
        self.broker_factory = broker_factory
        self.http_url = http_url
        self.payloads = payloads or PayloadFactory()
        self.result_timeout_s = float(result_timeout_s)
        self.senders = max(int(senders), 1)
        self.send_retry_s = float(send_retry_s)
        self.poll_interval_s = float(poll_interval_s)
        self.http_retries = int(http_retries)
        self._clock = clock
        self._send_q: "_queue.Queue" = _queue.Queue()
        self._outstanding: Dict[str, RequestRecord] = {}   # uri -> rec
        self._outstanding_lock = threading.Lock()
        self._stop = threading.Event()
        from analytics_zoo_torch.observability import get_registry
        reg = get_registry()
        self._m_sched = reg.histogram(
            "loadgen_latency_from_scheduled_seconds",
            "request latency measured from the SCHEDULED fire time "
            "(coordinated-omission-safe; the SLO basis)")
        self._m_sent = reg.histogram(
            "loadgen_latency_from_sent_seconds",
            "request latency measured from the actual send (the "
            "closed-loop number, recorded for the CO gap)")
        self._m_requests = reg.counter(
            "loadgen_requests_total",
            "loadgen requests by terminal status",
            labels=("status",))

    # ------------------------------------------------------------- lifecycle
    def run(self, events: Sequence[Tuple[float, Callable[[], None]]]
            = ()) -> LoadgenRun:
        """Fire the whole schedule; block until every record is
        terminal (or its per-request timeout passes).  Returns the
        structured run log."""
        records = [RequestRecord(spec=s) for s in self.schedule]
        started_wall = time.time()
        t0 = self._clock()
        for rec in records:
            rec.scheduled = t0 + rec.spec.offset_s
        # merge request dispatches and scenario events into ONE
        # ordered timeline (events sort before requests at equal
        # offsets so an outage window opens before the traffic
        # scheduled inside it)
        timeline: List[Tuple[float, int, Any]] = \
            [(off, 0, fn) for off, fn in events] + \
            [(rec.spec.offset_s, 1, rec) for rec in records]
        timeline.sort(key=lambda x: (x[0], x[1]))

        sender_threads = [
            threading.Thread(target=self._sender_loop, daemon=True,
                             name=f"loadgen-sender-{i}")
            for i in range(self.senders)]
        for t in sender_threads:
            t.start()
        poller = None
        if any(s.transport == "redis" for s in self.schedule):
            poller = threading.Thread(target=self._poller_loop,
                                      daemon=True,
                                      name="loadgen-poller")
            poller.start()

        try:
            for off, _prio, item in timeline:
                due = t0 + off
                while True:
                    delay = due - self._clock()
                    if delay <= 0:
                        break
                    time.sleep(min(delay, 0.05))
                if callable(item):
                    try:
                        item()
                    except Exception:   # noqa: BLE001 — an event hook
                        log.exception("scenario event hook failed")
                else:
                    self._send_q.put(item)
            # drain: wait out every record's own timeout window
            deadline = t0 + (self.schedule[-1].offset_s
                             if self.schedule else 0.0) \
                + self.result_timeout_s + 5.0
            while self._clock() < deadline:
                if all(r.terminal for r in records):
                    break
                time.sleep(0.05)
            # anything still pending is LOST: the system consumed the
            # request (or never did) and no terminal outcome arrived
            for r in records:
                if not r.terminal:
                    self._finish(r, "lost",
                                 error="no result before the loadgen "
                                       "drain deadline")
        finally:
            self._stop.set()
            for _ in sender_threads:
                self._send_q.put(None)
        return LoadgenRun(records, t0, started_wall, self._clock())

    # ---------------------------------------------------------------- common
    def _finish(self, rec: RequestRecord, status: str,
                error: str = "") -> None:
        if rec.terminal:
            return
        rec.done = self._clock() if rec.done is None else rec.done
        rec.status = status
        rec.error = error
        self._m_requests.labels(status).inc()
        lat = rec.latency_from_scheduled_s
        if lat is not None:
            self._m_sched.observe(lat, exemplar=rec.trace_id)
        lat = rec.latency_from_sent_s
        if lat is not None:
            self._m_sent.observe(lat, exemplar=rec.trace_id)

    # --------------------------------------------------------------- senders
    def _sender_loop(self) -> None:
        tl = threading.local()
        while True:
            rec = self._send_q.get()
            if rec is None:
                return
            try:
                if rec.spec.transport == "redis":
                    self._send_redis(tl, rec)
                elif rec.spec.transport == "generate":
                    self._send_generate(rec)
                else:
                    self._send_http(rec)
            except Exception as e:   # noqa: BLE001 — log, never die
                log.exception("sender failed for %s", rec.spec.uri)
                self._finish(rec, "error",
                             f"{type(e).__name__}: {e}")

    def _send_redis(self, tl, rec: RequestRecord) -> None:
        """Enqueue onto the stream with a bounded retry/reconnect
        budget (a broker outage mid-scenario must not crash the
        sender: the retry time is charged to the scheduled-basis
        latency, which is the honest accounting)."""
        fields = self.payloads.redis_fields(rec.spec)
        deadline = self._clock() + self.send_retry_s
        delay = 0.05
        while True:
            try:
                conn = getattr(tl, "conn", None)
                if conn is None:
                    conn = tl.conn = self.broker_factory()
                conn.xadd("serving_stream", fields)
                rec.sent = self._clock()
                break
            except (OSError, RuntimeError) as e:
                try:
                    if getattr(tl, "conn", None) is not None:
                        tl.conn.close()
                except Exception:   # noqa: BLE001 — already broken
                    pass
                tl.conn = None
                if self._clock() >= deadline:
                    self._finish(rec, "send_failed",
                                 f"{type(e).__name__}: {e}")
                    return
                time.sleep(delay)
                delay = min(delay * 2.0, 0.5)
        with self._outstanding_lock:
            self._outstanding[rec.spec.uri] = rec

    def _http_client(self):
        from analytics_zoo_torch.serving.client import ServingHttpClient
        return ServingHttpClient(self.http_url,
                                 retries=self.http_retries,
                                 timeout_s=self.result_timeout_s)

    def _send_http(self, rec: RequestRecord) -> None:
        from analytics_zoo_torch.serving.client import ServingHttpError
        from urllib import request as urlrequest
        client = self._http_client()
        body = self.payloads.http_body(rec.spec)
        req = urlrequest.Request(
            f"{client.base_url}/predict/{rec.spec.endpoint}",
            data=body, headers={
                "Content-Type": "application/json",
                # Request object is built once: every retry re-sends
                # the byte-identical traceparent
                TRACE_HEADER: TraceContext.new(
                    rec.spec.request_id).to_wire(),
            })
        rec.sent = self._clock()
        try:
            ts: Dict[str, float] = {}
            doc = client._open_with_retries(
                req, self.result_timeout_s, self.http_retries,
                consume=lambda r: json.loads(r.read().decode()),
                ts=ts)
            # prefer the client's own monotonic stamps (satellite:
            # measured at the socket, not around the retry ladder)
            if "sent_monotonic" in ts:
                rec.sent = ts["sent_monotonic"]
            rec.first_byte = ts.get("first_byte_monotonic")
            rec.done = ts.get("received_monotonic", self._clock())
            if doc.get("error"):
                self._finish(rec,
                             _classify_error_result(doc["error"]),
                             doc["error"])
            else:
                self._finish(rec, "ok")
        except ServingHttpError as e:
            rec.done = self._clock()
            self._finish(rec, _classify_error_result(str(e)), str(e))
        except Exception as e:   # noqa: BLE001 — connection-class
            rec.done = self._clock()
            self._finish(rec, "error", f"{type(e).__name__}: {e}")

    def _send_generate(self, rec: RequestRecord) -> None:
        from analytics_zoo_torch.serving.client import ServingHttpError
        client = self._http_client()
        arr = self.payloads.array(rec.spec)

        def on_token(_i, _tok):
            now = self._clock()
            if rec.first_byte is None:
                rec.first_byte = now
            rec.tokens += 1

        rec.sent = self._clock()
        try:
            doc = client.generate(
                rec.spec.endpoint, arr,
                max_tokens=rec.spec.max_tokens, uri=rec.spec.uri,
                request_id=rec.spec.request_id, on_token=on_token,
                timeout_s=self.result_timeout_s,
                retries=self.http_retries)
            rec.done = self._clock()
            rec.tokens = len(doc.get("tokens", ())) or rec.tokens
            self._finish(rec, "ok")
        except ServingHttpError as e:
            rec.done = self._clock()
            self._finish(rec, _classify_error_result(str(e)), str(e))
        except Exception as e:   # noqa: BLE001 — connection-class
            rec.done = self._clock()
            self._finish(rec, "error", f"{type(e).__name__}: {e}")

    # ---------------------------------------------------------------- poller
    def _poller_loop(self) -> None:
        """ONE thread resolves every outstanding redis request: scan
        the result hashes round-robin on a single connection.  Senders
        never wait on results — this is what keeps the redis path
        open-loop at any outstanding depth."""
        conn = None
        # the in-body empty+stopped check below is the real exit
        # condition, and it reads _outstanding under its lock — a
        # `while ... or self._outstanding` header would re-read it
        # unlocked for no extra information
        while True:
            with self._outstanding_lock:
                uris = list(self._outstanding)
            if not uris:
                if self._stop.is_set():
                    return
                time.sleep(self.poll_interval_s)
                continue
            for uri in uris:
                with self._outstanding_lock:
                    rec = self._outstanding.get(uri)
                if rec is None:
                    continue
                if rec.terminal:        # timed out by the drain pass
                    with self._outstanding_lock:
                        self._outstanding.pop(uri, None)
                    continue
                try:
                    if conn is None:
                        conn = self.broker_factory()
                    fields = conn.hgetall("result:" + uri)
                except (OSError, RuntimeError):
                    try:
                        if conn is not None:
                            conn.close()
                    except Exception:   # noqa: BLE001
                        pass
                    conn = None
                    time.sleep(0.1)
                    break               # restart the scan
                if fields:
                    raw = fields.get("value", fields.get(b"value"))
                    if isinstance(raw, bytes):
                        raw = raw.decode()
                    rec.done = self._clock()
                    try:
                        doc = json.loads(raw) if raw else None
                    except (TypeError, json.JSONDecodeError):
                        doc = None
                    if isinstance(doc, dict) and doc.get("error"):
                        self._finish(
                            rec, _classify_error_result(doc["error"]),
                            doc["error"])
                    else:
                        self._finish(rec, "ok")
                    with self._outstanding_lock:
                        self._outstanding.pop(uri, None)
                elif self._clock() - rec.scheduled \
                        > self.result_timeout_s:
                    self._finish(rec, "lost",
                                 "no result within "
                                 f"{self.result_timeout_s:.1f}s of "
                                 "the scheduled time")
                    with self._outstanding_lock:
                        self._outstanding.pop(uri, None)
            time.sleep(self.poll_interval_s)
