"""Request-scoped distributed tracing — per-request causal timelines
for the serving plane (Dapper-style tail forensics).

The metrics and spans instrument *aggregates* (histograms, spans,
cluster federation) and a load test's verdict gates on p99 — but when
the verdict says "p99 blew the bound", nothing can say WHICH requests
were slow or WHERE inside the replica their time went.  This module is
that missing layer:

* :class:`TraceContext` — a ``trace_id`` + parent span id stamped by
  the client and propagated end-to-end: HTTP carries it in a
  ``traceparent``-style header (:data:`TRACE_HEADER`), Redis stream
  records carry it in a ``trace`` field (:data:`TRACE_FIELD`), and the
  ``request_id`` correlation becomes one field of the context.
  Both transports carry the SAME wire string (:meth:`TraceContext
  .to_wire`), so propagation round-trips byte-identically — including
  send retries (the loadgen re-XADDs the same field dict) and PEL
  reclaim (XAUTOCLAIM hands the original fields back unchanged).
* :class:`RequestTimeline` — fixed lifecycle *stations* recorded on
  every request's path: ``enqueue``, ``transport_receive``,
  ``decode``, ``batch_queue_enter``, ``batch_compose`` (with batch id
  + fill ratio + co-rider count), ``dispatch``, ``device_done``,
  ``result_write`` / ``respond`` — plus per-iteration events
  (``prefill``, each ``decode_step``, ``retire`` cause) on the
  generative path.  Stations are offsets from the timeline's first
  mark, so the per-station segment breakdown sums to the measured
  latency by construction.
* :class:`RequestLog` — a bounded per-replica ring of finished
  timelines behind a tail-based sampler: errors, sheds and quarantines
  are ALWAYS kept, so are the slowest-K of each window; the healthy
  fast majority is down-sampled deterministically (every Nth).  The
  ring is served as ``/requests.json`` by the metrics server and
  flushed to the launcher's run dir (``requests.json``) so
  ``obs_report --requests RUN_DIR`` merges replicas into a
  slowest-request waterfall.

Config knobs (all under ``observability.``, read at singleton
creation): ``reqtrace`` (default on), ``reqtrace_ring`` (ring
capacity), ``reqtrace_slowest_k`` / ``reqtrace_window_s`` /
``reqtrace_sample_every`` (tail-sampler shape).
"""

from __future__ import annotations

import json
import re
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

#: the traceparent-style HTTP header both HTTP clients send and the
#: serving HTTP transport reads (W3C shape: version-traceid-spanid-flags)
TRACE_HEADER = "X-Zoo-Traceparent"
#: the Redis stream record field carrying the same wire string
TRACE_FIELD = "trace"

#: the fixed station vocabulary (docs/observability.md documents each);
#: generative requests additionally record prefill/decode_step/retire
STATIONS = ("enqueue", "transport_receive", "decode",
            "batch_queue_enter", "batch_compose", "dispatch",
            "device_done", "result_write", "respond",
            "prefill", "decode_step", "retire")

_WIRE_RE = re.compile(
    r"^(?P<ver>[0-9a-f]{2})-(?P<trace>[0-9a-f]{32})"
    r"-(?P<span>[0-9a-f]{16})-(?P<flags>[0-9a-f]{2})$")
_HEX32_RE = re.compile(r"^[0-9a-f]{32}$")


@dataclass(frozen=True)
class TraceContext:
    """One request's identity on the wire: ``trace_id`` (32 lowercase
    hex) + the stamping side's span id (16 hex).  ``request_id`` is
    the correlation key — carried alongside (records/bodies
    already have a ``request_id`` field), not inside the wire string,
    so the wire format stays a pure ``traceparent``."""

    trace_id: str
    span_id: str = "0" * 16
    request_id: Optional[str] = None

    @classmethod
    def new(cls, request_id: Optional[str] = None) -> "TraceContext":
        """Stamp a fresh context.  A uuid4-hex ``request_id`` (what
        the client/loadgen auto-generate) IS the trace id — one
        identifier correlates the loadgen record, the stream record,
        the timeline and the verdict's citation; anything else gets a
        fresh trace id with the request_id carried as a field."""
        if request_id and _HEX32_RE.match(request_id):
            tid = request_id
        else:
            tid = uuid.uuid4().hex
        return cls(trace_id=tid, span_id=uuid.uuid4().hex[:16],
                   request_id=request_id)

    def to_wire(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_wire(cls, value,
                  request_id: Optional[str] = None
                  ) -> Optional["TraceContext"]:
        """Parse a wire string (header value or Redis field; bytes
        accepted).  Malformed values return None — a request with a
        broken trace must still be served, just untraced."""
        if isinstance(value, bytes):
            try:
                value = value.decode()
            except UnicodeDecodeError:
                return None
        if not isinstance(value, str):
            return None
        m = _WIRE_RE.match(value.strip())
        if not m:
            return None
        return cls(trace_id=m.group("trace"), span_id=m.group("span"),
                   request_id=request_id)


@dataclass
class RequestTimeline:
    """One request's station timeline.  Station times are offsets (s)
    from the first mark; ``wall0`` anchors the timeline on the wall
    clock so the offline merge can align timelines recorded by
    different replicas of one run."""

    trace_id: str
    request_id: Optional[str] = None
    endpoint: str = ""
    transport: str = ""
    outcome: str = "pending"
    wall0: float = 0.0
    t0: float = 0.0
    stations: List[Dict[str, Any]] = field(default_factory=list)

    def mark(self, station: str, t: Optional[float] = None,
             **attrs) -> None:
        now = time.perf_counter() if t is None else t
        if not self.stations:
            self.t0 = now
            self.wall0 = time.time() - max(0.0, time.perf_counter()
                                           - now)
        entry: Dict[str, Any] = {"station": station,
                                 "t": max(0.0, now - self.t0)}
        if attrs:
            entry.update(attrs)
        self.stations.append(entry)

    @property
    def latency_s(self) -> float:
        if not self.stations:
            return 0.0
        return max(s["t"] for s in self.stations)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "request_id": self.request_id,
            "endpoint": self.endpoint,
            "transport": self.transport,
            "outcome": self.outcome,
            "wall0": self.wall0,
            "latency_s": self.latency_s,
            "stations": list(self.stations),
        }


def _trace_id_of(trace) -> Optional[str]:
    """Accept a TraceContext, a timeline, or a bare trace_id string at
    every marking call site — instrumentation must never type-check
    its caller."""
    if trace is None:
        return None
    if isinstance(trace, str):
        return trace or None
    return getattr(trace, "trace_id", None)


class RequestLog:
    """Bounded per-replica timeline store with tail-based sampling.

    Active timelines live in a capped dict (a leak of never-finished
    requests must not grow without bound — the oldest active entry is
    evicted once the cap is hit); finished timelines pass the tail
    sampler into a ring.  All methods are thread-safe and cheap enough
    for the request hot path; when ``enabled`` is False every call is
    a no-op (the bench's ``reqtrace=off`` leg measures exactly this).
    """

    def __init__(self, capacity: int = 2048, slowest_k: int = 8,
                 window_s: float = 10.0, sample_every: int = 10,
                 enabled: bool = True):
        self.enabled = bool(enabled)
        self.capacity = max(1, int(capacity))
        self.slowest_k = max(1, int(slowest_k))
        self.window_s = float(window_s)
        self.sample_every = max(1, int(sample_every))
        self._lock = threading.Lock()
        self._active: Dict[str, RequestTimeline] = {}
        self._active_order: deque = deque()
        self._ring: deque = deque(maxlen=self.capacity)
        self._ok_seen = 0          # deterministic every-Nth sampling
        self._window_start = time.perf_counter()
        self._window_slowest: List[float] = []   # sorted ascending
        self.kept = 0
        self.dropped = 0

    # ------------------------------------------------------------ marking
    def begin(self, trace, *, transport: str = "",
              endpoint: str = "", station: Optional[str] = None,
              t: Optional[float] = None, **attrs
              ) -> Optional[RequestTimeline]:
        """Get-or-create the timeline for ``trace`` (idempotent per
        trace_id: the same request seen again — e.g. a PEL reclaim on
        the replica that originally read it — extends one timeline)."""
        tid = _trace_id_of(trace)
        if not self.enabled or not tid:
            return None
        with self._lock:
            tl = self._active.get(tid)
            if tl is None:
                tl = RequestTimeline(
                    trace_id=tid,
                    request_id=getattr(trace, "request_id", None))
                self._active[tid] = tl
                self._active_order.append(tid)
                # cap the active set: evict oldest-begun (they finish
                # as outcome=pending into the ring's sampler)
                while len(self._active) > self.capacity:
                    old = self._active_order.popleft()
                    lost = self._active.pop(old, None)
                    if lost is not None:
                        lost.outcome = "evicted"
                        self._keep_locked(lost)
            if transport:
                tl.transport = transport
            if endpoint:
                tl.endpoint = endpoint
        if station:
            tl.mark(station, t=t, **attrs)
        return tl

    def mark(self, trace, station: str, t: Optional[float] = None,
             **attrs) -> None:
        tid = _trace_id_of(trace)
        if not self.enabled or not tid:
            return
        with self._lock:
            tl = self._active.get(tid)
        if tl is not None:
            tl.mark(station, t=t, **attrs)

    def finish(self, trace, outcome: str,
               station: Optional[str] = None,
               t: Optional[float] = None, **attrs) -> None:
        """Close a timeline and run it through the tail sampler:
        non-ok outcomes (error / shed / quarantined / timeout) are
        always kept, so is anything among the slowest-K of the current
        window; the healthy remainder keeps every
        ``sample_every``-th."""
        tid = _trace_id_of(trace)
        if not self.enabled or not tid:
            return
        with self._lock:
            tl = self._active.pop(tid, None)
            if tl is None:
                return
            try:
                self._active_order.remove(tid)
            except ValueError:
                pass
        if station:
            tl.mark(station, t=t, **attrs)
        tl.outcome = outcome
        with self._lock:
            if self._sample_locked(tl):
                self._keep_locked(tl)
            else:
                self.dropped += 1

    # ------------------------------------------------------------ sampler
    def _sample_locked(self, tl: RequestTimeline) -> bool:
        if tl.outcome != "ok":
            return True
        now = time.perf_counter()
        if now - self._window_start > self.window_s:
            self._window_start = now
            self._window_slowest = []
        lat = tl.latency_s
        slow = self._window_slowest
        if len(slow) < self.slowest_k or lat >= slow[0]:
            # insert keeping ascending order, trim to K
            lo, hi = 0, len(slow)
            while lo < hi:
                mid = (lo + hi) // 2
                if slow[mid] < lat:
                    lo = mid + 1
                else:
                    hi = mid
            slow.insert(lo, lat)
            del slow[:-self.slowest_k]
            return True
        self._ok_seen += 1
        return self._ok_seen % self.sample_every == 0

    def _keep_locked(self, tl: RequestTimeline) -> None:
        self._ring.append(tl)
        self.kept += 1

    # ----------------------------------------------------------- querying
    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view (the ``/requests.json`` payload): the kept
        ring plus keep/drop accounting, newest last."""
        with self._lock:
            ring = [tl.to_dict() for tl in self._ring]
            active = len(self._active)
        return {"kind": "zoo_request_timelines",
                "kept": self.kept, "dropped": self.dropped,
                "active": active, "capacity": self.capacity,
                "timelines": ring}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f)
        return path

    def clear(self) -> None:
        with self._lock:
            self._active.clear()
            self._active_order.clear()
            self._ring.clear()
            self._ok_seen = 0
            self.kept = self.dropped = 0
            self._window_slowest = []
            self._window_start = time.perf_counter()


# ------------------------------------------------------------- singleton
_log: Optional[RequestLog] = None
_log_lock = threading.Lock()


def get_request_log() -> RequestLog:
    """Process-wide request log; shape read from config at creation
    (``observability.reqtrace*``).  ``observability.reqtrace`` off
    gives a disabled log whose every call is a cheap no-op."""
    global _log
    if _log is None:
        with _log_lock:
            if _log is None:
                from analytics_zoo_torch.common.config import get_config
                cfg = get_config()
                _log = RequestLog(
                    capacity=int(cfg.get(
                        "observability.reqtrace_ring", 2048)),
                    slowest_k=int(cfg.get(
                        "observability.reqtrace_slowest_k", 8)),
                    window_s=float(cfg.get(
                        "observability.reqtrace_window_s", 10.0)),
                    sample_every=int(cfg.get(
                        "observability.reqtrace_sample_every", 10)),
                    enabled=bool(cfg.get(
                        "observability.reqtrace", True)))
    return _log


def reset_request_log() -> None:
    """Drop the singleton (tests; also how a config flip takes
    effect)."""
    global _log
    with _log_lock:
        _log = None


# -------------------------------------------------------- offline merge
def merge_timeline_dicts(docs: List[Dict[str, Any]]
                         ) -> List[Dict[str, Any]]:
    """Merge timeline dicts from several replicas' ``requests.json``
    documents into one list, joining partial timelines that share a
    trace_id (e.g. the client process recorded ``enqueue`` while the
    replica recorded the serve stations).  Station offsets are
    re-anchored on the earliest ``wall0`` of the group, so cross-
    process segments (same host — the launcher's replicas) stay
    meaningful.  Pure dict-in/dict-out: the aggregator and obs_report
    call this without importing the package."""
    by_tid: Dict[str, List[Dict[str, Any]]] = {}
    order: List[str] = []
    for doc in docs:
        for tl in (doc.get("timelines") or []):
            tid = tl.get("trace_id")
            if not tid:
                continue
            if tid not in by_tid:
                by_tid[tid] = []
                order.append(tid)
            by_tid[tid].append(tl)
    merged: List[Dict[str, Any]] = []
    for tid in order:
        parts = by_tid[tid]
        if len(parts) == 1:
            merged.append(dict(parts[0]))
            continue
        anchor = min(float(p.get("wall0", 0.0)) for p in parts)
        stations: List[Dict[str, Any]] = []
        for p in parts:
            shift = float(p.get("wall0", 0.0)) - anchor
            for s in (p.get("stations") or []):
                ns = dict(s)
                ns["t"] = float(s.get("t", 0.0)) + shift
                stations.append(ns)
        stations.sort(key=lambda s: s["t"])
        # the serve-side part owns the outcome; "pending" never wins
        outcome = "pending"
        for p in parts:
            if p.get("outcome") not in (None, "pending"):
                outcome = p["outcome"]
        out = dict(parts[0])
        out["outcome"] = outcome
        out["endpoint"] = next((p.get("endpoint") for p in parts
                                if p.get("endpoint")), "")
        out["transport"] = next((p.get("transport") for p in parts
                                 if p.get("transport")), "")
        out["wall0"] = anchor
        out["stations"] = stations
        out["latency_s"] = (max(s["t"] for s in stations)
                            if stations else 0.0)
        merged.append(out)
    return merged
