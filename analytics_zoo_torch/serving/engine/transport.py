"""HTTP/JSON fast-path transport.

The Redis stream is the bulk path: durable, exactly-once, replayable —
and a round trip costs an enqueue poll plus a result poll.  This
transport is the low-latency path for interactive callers: one POST
carries one record straight into the SAME engine queue the Redis loop
feeds, rides a continuously-batched device predict, and the response
returns on the same connection — no broker hop at all.  It keeps
working during a broker outage (the breaker only guards broker IO),
which is exactly when an orchestrator probing the fleet needs a live
predict path.

Contract (stdlib-only, JSON over ``ThreadingHTTPServer``):

* ``POST /predict/<endpoint>`` — body ``{"data": <nested list>,
  "dtype": "float32"?, "uri": str?, "request_id": str?}`` or
  ``{"npy_b64": <base64 .npy bytes>, ...}``.  200 →
  ``{"value": [[class, prob], ...], "request_id": ..., "endpoint":
  ...}``; 404 unknown endpoint, 400 undecodable payload, 500 predict
  error, 504 deadline.  (A stopped engine restarts on submit, so
  there is deliberately no "engine down" status.)
* ``POST /generate/<endpoint>`` — generative endpoints only: body as
  above (``data`` = the int token sequence) plus optional
  ``max_tokens``.  The response STREAMS (chunked transfer): one JSON
  line per token, ``{"token": t, "index": i}``, the moment the decode
  scheduler emits it, then a final line ``{"done": true, "tokens":
  [...], "request_id": ..., "endpoint": ...}`` (or ``{"error": ...}``
  if decode failed mid-stream).  Pre-stream failures use the predict
  status contract (400/404/504; 400 also for a non-generative
  endpoint).
* ``GET /endpoints`` — the registry listing (name → buckets, top_n,
  weight, records served; generative endpoints add slots/max_seq_len).

Each handler thread blocks on its own request's completion — HTTP
concurrency is the transport's in-flight window, the batcher decides
the device batching.
"""

from __future__ import annotations

import base64
import io
import itertools
import json
import logging
import socket
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from analytics_zoo_torch.observability.reqtrace import (
    TRACE_HEADER, TraceContext, get_request_log)
from analytics_zoo_torch.resilience.chaos import (
    SITE_SERVING_HTTP, InjectedFault, active_chaos)
from analytics_zoo_torch.serving.engine.batcher import (Request,
                                                      ShedError)
from analytics_zoo_torch.serving.engine.core import DEFAULT_ENDPOINT

log = logging.getLogger("analytics_zoo_torch.serving.engine")


def decode_payload(body: bytes, default_dtype: str = "float32"):
    """JSON body → (ndarray, uri, request_id, doc).  Raises ValueError
    on anything undecodable (the handler answers 400)."""
    try:
        doc = json.loads(body or b"{}")
    except json.JSONDecodeError as e:
        raise ValueError(f"bad JSON: {e}") from e
    if not isinstance(doc, dict):
        raise ValueError("payload must be a JSON object")
    uri = str(doc.get("uri") or "")
    rid = doc.get("request_id") or uuid.uuid4().hex
    if "npy_b64" in doc:
        raw = base64.b64decode(doc["npy_b64"])
        arr = np.load(io.BytesIO(raw), allow_pickle=False)
    elif "data" in doc:
        arr = np.asarray(doc["data"], dtype=np.dtype(
            doc.get("dtype") or default_dtype))
    else:
        raise ValueError("payload needs 'data' or 'npy_b64'")
    return arr, uri, str(rid), doc


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # noqa: A003 — stdlib API
        log.debug("http transport: " + fmt, *args)

    def _respond(self, code: int, doc: dict) -> None:
        body = json.dumps(doc).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:   # noqa: N802 — stdlib API
        path = self.path.split("?", 1)[0]
        engine = self.server.engine
        if path in ("/endpoints", "/"):
            out = {}
            for ep in engine.registry:
                entry = {
                    "buckets": list(ep.buckets),
                    "top_n": ep.top_n,
                    "weight": ep.weight,
                    "records_total": ep.records_total,
                }
                if ep.generative:
                    entry.update(generative=True,
                                 slots=ep.pool.capacity,
                                 enc_len=ep.pool.enc_len,
                                 max_seq_len=ep.max_seq_len)
                out[ep.name] = entry
            self._respond(200, {"endpoints": out})
        else:
            self._respond(404, {"error": f"no route {path!r}"})

    def do_POST(self) -> None:   # noqa: N802 — stdlib API
        path = self.path.split("?", 1)[0]
        transport = self.server.transport
        # chaos site ``serving.http``: transport-layer faults, fired
        # BEFORE the request is even read.  A raising kind drops the
        # connection with no HTTP response (the network-disconnect
        # class the client's retry ladder must absorb); ``slow``
        # already slept inside trip — the straggling-proxy class.
        try:
            transport._trip_chaos()
        except InjectedFault:
            transport._m_requests.labels("chaos_dropped").inc()
            self.close_connection = True
            try:
                self.connection.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            return
        for route in ("/predict", "/generate"):
            if path == route or path.startswith(route + "/"):
                break
        else:
            self._respond(404, {"error": f"no route {path!r}"})
            return
        endpoint = path[len(route):].strip("/") or DEFAULT_ENDPOINT
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        trace_header = self.headers.get(TRACE_HEADER)
        if route == "/generate":
            transport.handle_generate(endpoint, body, self,
                                      trace_header=trace_header)
            return
        code, doc = transport.handle_predict(
            endpoint, body, trace_header=trace_header)
        self._respond(code, doc)

    # --------------------------------------------------- chunked streaming
    def start_stream(self, code: int = 200) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

    def stream_line(self, doc: dict) -> None:
        data = json.dumps(doc).encode() + b"\n"
        self.wfile.write(f"{len(data):X}\r\n".encode() + data
                         + b"\r\n")
        self.wfile.flush()

    def end_stream(self) -> None:
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()


class HttpTransport:
    """The fast-path listener over one :class:`ServingEngine`."""

    def __init__(self, engine, port: int = 0,
                 host: str = "127.0.0.1",
                 timeout_s: float = 30.0):
        from analytics_zoo_torch.observability import (
            get_registry, get_tracer)
        self.engine = engine
        self._host = host
        self._requested_port = int(port)
        self.timeout_s = float(timeout_s)
        self.port: Optional[int] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # chaos-site step counter (``serving.http``): POSTs arrive on
        # handler threads — itertools.count.__next__ is GIL-atomic.
        # Steps reset per installed plan (the serving.redis
        # convention), so ``at_step=0, times=k`` always means "the
        # next k POSTs" no matter how much traffic ran before a
        # scenario armed its plan.
        self._chaos_seq = itertools.count()
        self._chaos_plan = None
        self._tracer = get_tracer()
        reg = get_registry()
        self._m_requests = reg.counter(
            "serving_http_requests_total",
            "HTTP fast-path requests by response class",
            labels=("status",))
        self._m_latency = reg.histogram(
            "serving_request_latency_seconds",
            "stream-arrival to result-write latency per record")

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "HttpTransport":
        if self._httpd is not None:
            return self
        self._httpd = ThreadingHTTPServer(
            (self._host, self._requested_port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.engine = self.engine
        self._httpd.transport = self
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"zoo-serving-http:{self.port}")
        self._thread.start()
        log.info("serving HTTP fast path listening on %s:%d/predict",
                 self._host, self.port)
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        self.port = None

    @property
    def url(self) -> Optional[str]:
        return (f"http://{self._host}:{self.port}"
                if self.port else None)

    def _trip_chaos(self) -> None:
        """Fire the ``serving.http`` site for one POST.  Step counts
        attempted POSTs since the CURRENT plan was installed (each new
        plan sees steps 0, 1, 2, … — mirroring
        ``BreakerClient._trip_chaos``)."""
        plan = active_chaos()
        if plan is None:
            self._chaos_plan = None
            return
        if plan is not self._chaos_plan:
            self._chaos_plan = plan
            self._chaos_seq = itertools.count()
        plan.trip(SITE_SERVING_HTTP, next(self._chaos_seq))

    # --------------------------------------------------------------- serve
    @staticmethod
    def _trace_begin(trace_header, rid: str, endpoint: str,
                     t0: float):
        """Build this request's TraceContext (the client's via
        :data:`TRACE_HEADER`, else a server-stamped one) and open its
        timeline with the HTTP arrival stations.  None when tracing is
        off or the header is malformed AND no context can be minted."""
        reqlog = get_request_log()
        if not reqlog.enabled:
            return None
        ctx = (TraceContext.from_wire(trace_header, request_id=rid)
               if trace_header else TraceContext.new(rid))
        if ctx is not None:
            reqlog.begin(ctx, transport="http", endpoint=endpoint,
                         station="transport_receive", t=t0)
            reqlog.mark(ctx, "decode")
        return ctx

    @staticmethod
    def _outcome_of(error) -> str:
        if error is None:
            return "ok"
        if isinstance(error, ShedError):
            return "shed"
        if isinstance(error, TimeoutError):
            return "timeout"
        return "error"

    def handle_predict(self, endpoint: str, body: bytes,
                       trace_header: Optional[str] = None):
        """One fast-path request → (http status, response doc).
        Separated from the handler class so tests can drive the full
        path without a socket (``trace_header`` stands in for the
        :data:`TRACE_HEADER` value ``do_POST`` forwards)."""
        import time
        t0 = time.perf_counter()
        try:
            arr, uri, rid, _doc = decode_payload(body)
        except ValueError as e:
            self._m_requests.labels("bad_request").inc()
            return 400, {"error": str(e)}
        ctx = self._trace_begin(trace_header, rid, endpoint, t0)
        reqlog = get_request_log()
        if self.engine.registry.get(endpoint) is None:
            self._m_requests.labels("unknown_endpoint").inc()
            reqlog.finish(ctx, "error", station="respond")
            return 404, {
                "error": f"unknown endpoint {endpoint!r}",
                "endpoints": self.engine.endpoints()}
        req = Request(endpoint=endpoint, uri=uri, data=arr,
                      request_id=rid, trace=ctx)
        with self._tracer.span("serving_http_predict",
                               endpoint=endpoint, request_id=rid):
            self.engine.submit_wait([req], timeout_s=self.timeout_s)
        if req.error is not None:
            timed_out = isinstance(req.error, TimeoutError)
            self._m_requests.labels(
                "timeout" if timed_out else "error").inc()
            reqlog.finish(ctx, self._outcome_of(req.error),
                          station="respond")
            return (504 if timed_out else 500), {
                "error": f"{type(req.error).__name__}: {req.error}",
                "request_id": rid, "endpoint": endpoint}
        self._m_latency.observe(
            time.perf_counter() - t0,
            exemplar=ctx.trace_id if ctx else None)
        self._m_requests.labels("ok").inc()
        reqlog.finish(ctx, "ok", station="respond")
        out = {"value": req.result, "request_id": rid,
               "endpoint": endpoint}
        if ctx is not None:
            out["trace_id"] = ctx.trace_id
        return 200, out

    def handle_generate(self, endpoint: str, body: bytes,
                        handler,
                        trace_header: Optional[str] = None) -> None:
        """One streaming generate request: validate, submit to the
        decode scheduler, and relay each emitted token onto the
        connection as a chunked JSON line the moment it arrives —
        inter-token latency on the wire tracks the device decode
        step, not the sequence.  ``handler`` is the live request
        handler (chunked writes need the socket)."""
        import queue as _queue
        import time
        t0 = time.perf_counter()
        try:
            arr, uri, rid, doc = decode_payload(body,
                                                default_dtype="int32")
        except ValueError as e:
            self._m_requests.labels("bad_request").inc()
            handler._respond(400, {"error": str(e)})
            return
        ctx = self._trace_begin(trace_header, rid, endpoint, t0)
        reqlog = get_request_log()
        ep = self.engine.registry.get(endpoint)
        if ep is None:
            self._m_requests.labels("unknown_endpoint").inc()
            reqlog.finish(ctx, "error", station="respond")
            handler._respond(404, {
                "error": f"unknown endpoint {endpoint!r}",
                "endpoints": self.engine.endpoints()})
            return
        if not ep.generative:
            self._m_requests.labels("bad_request").inc()
            reqlog.finish(ctx, "error", station="respond")
            handler._respond(400, {
                "error": f"endpoint {endpoint!r} is not generative; "
                         f"POST /predict/{endpoint} instead"})
            return
        try:
            max_tokens = int(doc["max_tokens"]) \
                if doc.get("max_tokens") else None
        except (TypeError, ValueError):
            self._m_requests.labels("bad_request").inc()
            reqlog.finish(ctx, "error", station="respond")
            handler._respond(400, {"error": "bad max_tokens"})
            return
        emitted: _queue.Queue = _queue.Queue()
        req = Request(endpoint=endpoint, uri=uri,
                      data=np.asarray(arr, np.int32).reshape(-1),
                      request_id=rid, max_tokens=max_tokens,
                      trace=ctx,
                      on_token=lambda i, t: emitted.put((i, t)))
        with self._tracer.span("serving_http_generate",
                               endpoint=endpoint, request_id=rid):
            self.engine.submit([req])
            # INACTIVITY deadline, reset on every token: a healthy
            # stream still emitting must never be killed for total
            # duration — only a stall of timeout_s with no tokens is
            # a timeout (and a pre-stream stall still gets a clean
            # 504 status line)
            deadline = time.monotonic() + self.timeout_s
            streaming = False
            try:
                while True:
                    try:
                        i, tok = emitted.get(timeout=0.05)
                    except _queue.Empty:
                        if req.done:
                            break
                        if time.monotonic() >= deadline:
                            req.fail(TimeoutError(
                                f"no tokens within "
                                f"{self.timeout_s:.1f}s"))
                            break
                        continue
                    deadline = time.monotonic() + self.timeout_s
                    if not streaming:
                        handler.start_stream()
                        streaming = True
                    handler.stream_line({"token": tok, "index": i})
                # drain stragglers emitted between the last get and
                # completion so the final token count matches
                while True:
                    try:
                        i, tok = emitted.get_nowait()
                    except _queue.Empty:
                        break
                    if streaming:
                        handler.stream_line({"token": tok,
                                             "index": i})
                if req.error is not None:
                    timed_out = isinstance(req.error, TimeoutError)
                    self._m_requests.labels(
                        "timeout" if timed_out else "error").inc()
                    reqlog.finish(ctx, self._outcome_of(req.error),
                                  station="respond")
                    err = {"error": f"{type(req.error).__name__}: "
                                    f"{req.error}",
                           "request_id": rid, "endpoint": endpoint}
                    if streaming:
                        handler.stream_line(err)
                        handler.end_stream()
                    else:
                        handler._respond(504 if timed_out else 500,
                                         err)
                    return
                if not streaming:
                    handler.start_stream()
                done_line = {"done": True,
                             "tokens": req.result,
                             "request_id": rid,
                             "endpoint": endpoint}
                if ctx is not None:
                    done_line["trace_id"] = ctx.trace_id
                handler.stream_line(done_line)
                handler.end_stream()
                self._m_latency.observe(
                    time.perf_counter() - t0,
                    exemplar=ctx.trace_id if ctx else None)
                self._m_requests.labels("ok").inc()
                reqlog.finish(ctx, "ok", station="respond")
            except (BrokenPipeError, ConnectionError, OSError):
                # the client hung up mid-stream: mark the request done
                # so the scheduler's abandoned-sweep retires its slot
                # instead of decoding tokens nobody reads — a burst of
                # disconnects must not pin the pool full of dead
                # sequences until max_seq_len
                if not req.done:
                    req.fail(ConnectionError(
                        "generate client disconnected mid-stream"))
                log.debug("generate stream client disconnect "
                          "(endpoint %s, request %s)", endpoint, rid)
                self._m_requests.labels("client_gone").inc()
                reqlog.finish(ctx, "error", station="respond",
                              cause="client_gone")
