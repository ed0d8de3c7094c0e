"""Serving client API.

Reference: pyzoo/zoo/serving/client.py — ``InputQueue.enqueue_image``
(:58, base64 → XADD) and ``OutputQueue.query``/``dequeue`` (:127).
"""

from __future__ import annotations

import base64
import io
import json
import time
import uuid
from typing import Any, Dict, Optional

import numpy as np

from analytics_zoo_torch.observability.reqtrace import (
    TRACE_FIELD, TRACE_HEADER, TraceContext, get_request_log)
from analytics_zoo_torch.serving.redis_client import connect
from analytics_zoo_torch.serving.server import INPUT_STREAM, RESULT_PREFIX


def _stamp_trace(rid: str, trace=None,
                 transport: str = "redis") -> Optional[TraceContext]:
    """The client half of request tracing: resolve the context this
    send carries (an explicit :class:`TraceContext`, a wire string, or
    a freshly stamped one when tracing is on) and record its
    ``enqueue`` station.  None when tracing is off and no explicit
    trace was given — the request is served untraced."""
    if isinstance(trace, TraceContext):
        ctx = trace
    elif isinstance(trace, str) and trace:
        ctx = TraceContext.from_wire(trace, request_id=rid)
    else:
        reqlog = get_request_log()
        ctx = TraceContext.new(rid) if reqlog.enabled else None
    if ctx is not None:
        get_request_log().begin(ctx, transport=transport,
                                station="enqueue")
    return ctx


class InputQueue:
    def __init__(self, redis_url: Optional[str] = None, broker=None):
        self.broker = broker if broker is not None else connect(redis_url)

    @staticmethod
    def _request_id(request_id: Optional[str]) -> str:
        # the client half of cross-process tracing: the id rides the
        # stream record, threads through the server's decode/batch/
        # predict spans, and is echoed next to the result
        return request_id if request_id else uuid.uuid4().hex

    def enqueue_image(self, uri: str, image,
                      request_id: Optional[str] = None,
                      endpoint: Optional[str] = None,
                      trace=None) -> str:
        """image: ndarray (HWC uint8) or path or raw JPEG bytes.
        Returns the record's ``request_id`` (generated when not
        given) — correlate it against the server's spans and the
        ``request_id`` field echoed beside the result.  ``endpoint``
        routes the record to a registered model on a multi-model
        worker (absent = the worker's default model).  ``trace`` (a
        :class:`TraceContext` or wire string) propagates an existing
        trace; absent, one is stamped automatically while tracing is
        on."""
        if isinstance(image, str):
            with open(image, "rb") as f:
                raw = f.read()
        elif isinstance(image, (bytes, bytearray)):
            raw = bytes(image)
        else:
            import cv2
            ok, enc = cv2.imencode(".jpg", np.asarray(image))
            if not ok:
                raise ValueError("cannot encode image")
            raw = enc.tobytes()
        rid = self._request_id(request_id)
        fields = {"uri": uri, "image": base64.b64encode(raw),
                  "request_id": rid}
        if endpoint:
            fields["endpoint"] = endpoint
        ctx = _stamp_trace(rid, trace)
        if ctx is not None:
            fields[TRACE_FIELD] = ctx.to_wire()
        self.broker.xadd(INPUT_STREAM, fields)
        return rid

    def enqueue(self, uri: str, data: np.ndarray,
                request_id: Optional[str] = None,
                endpoint: Optional[str] = None,
                max_tokens: Optional[int] = None,
                trace=None) -> str:
        """Arbitrary ndarray input (npy-serialized); returns the
        record's ``request_id``.  ``endpoint`` routes to a registered
        model on a multi-model worker; ``max_tokens`` caps the
        sequence a *generative* endpoint decodes for this record
        (ignored by stateless endpoints); ``trace`` propagates an
        existing :class:`TraceContext` (absent, one is stamped while
        tracing is on — its wire string rides the record's ``trace``
        field)."""
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(data), allow_pickle=False)
        rid = self._request_id(request_id)
        fields = {"uri": uri, "data": base64.b64encode(buf.getvalue()),
                  "request_id": rid}
        if endpoint:
            fields["endpoint"] = endpoint
        if max_tokens:
            fields["max_tokens"] = str(int(max_tokens))
        ctx = _stamp_trace(rid, trace)
        if ctx is not None:
            fields[TRACE_FIELD] = ctx.to_wire()
        self.broker.xadd(INPUT_STREAM, fields)
        return rid


class OutputQueue:
    def __init__(self, redis_url: Optional[str] = None, broker=None):
        self.redis_url = redis_url
        self.broker = broker if broker is not None else connect(redis_url)

    def _reconnect(self) -> None:
        """Replace a dead socket (url-constructed queues only; an
        injected broker has nothing to reconnect).  A failed reconnect
        is left for the next poll to count — the retry budget, not
        this helper, decides when to give up."""
        if self.redis_url is None:
            return
        try:
            self.broker.close()
        except Exception:   # noqa: BLE001 — already broken
            pass
        try:
            self.broker = connect(self.redis_url)
        except (OSError, RuntimeError):
            pass

    def query(self, uri: str, timeout_s: float = 0.0,
              retries: int = 8):
        """Result for one uri (list of [class, prob]), or None."""
        meta = self.query_meta(uri, timeout_s, retries=retries)
        return meta["value"] if meta else None

    def query_meta(self, uri: str, timeout_s: float = 0.0,
                   retries: int = 8) -> Optional[Dict[str, Any]]:
        """Result plus correlation metadata: ``{"value": ...,
        "request_id": str | None}`` — the id the server echoed from
        the matching enqueue.

        Polling backs off exponentially (20 ms → 250 ms cap) instead
        of hammering a fixed 20 ms, and a transient broker error no
        longer raises straight through: up to ``retries`` consecutive
        connection failures are absorbed with the same bounded
        exponential backoff + jitter the server's result-write path
        uses (reconnecting between attempts), after which the last
        error is re-raised.  A positive ``timeout_s`` is the per-call
        deadline and wins over the retry ladder: when it expires
        mid-retry the call returns ``None`` cleanly, exactly like an
        absent result.  ``timeout_s=0`` (the default) polls for the
        result without blocking but has NO deadline, so broker-blip
        retries may still block up to a few seconds — callers that
        need fail-fast on a dead broker pass ``retries=1``."""
        import random
        deadline = time.monotonic() + timeout_s
        poll_delay, retry_delay, failures = 0.02, 0.05, 0
        while True:
            try:
                fields = self.broker.hgetall(RESULT_PREFIX + uri)
            except OSError:
                # connection-class trouble only: a redis COMMAND error
                # (RuntimeError) is an application bug and re-raises
                # immediately — retrying cannot fix it
                failures += 1
                if failures >= max(int(retries), 1):
                    raise
                if timeout_s > 0 and time.monotonic() >= deadline:
                    return None
                self._reconnect()
                time.sleep(retry_delay * (0.5 + random.random()))
                retry_delay = min(retry_delay * 2.0, 2.0)
                continue
            failures, retry_delay = 0, 0.05
            if fields:
                def dec(v):
                    return v.decode() if isinstance(v, bytes) else v
                rid = fields.get("request_id")
                # received_monotonic: stamped INSIDE the client the
                # moment the result hash was read, so an open-loop
                # load generator can compute latency from its own
                # scheduled time without wrapping (and re-timing) the
                # poll/retry ladder
                return {"value": json.loads(dec(fields.get("value"))),
                        "request_id": dec(rid) if rid else None,
                        "received_monotonic": time.monotonic()}
            if time.monotonic() >= deadline:
                return None
            time.sleep(poll_delay)
            poll_delay = min(poll_delay * 1.5, 0.25)

    def dequeue(self, uris) -> Dict[str, Any]:
        """Fetch-and-delete results for many uris (client.py dequeue)."""
        out = {}
        for uri in uris:
            res = self.query(uri)
            if res is not None:
                out[uri] = res
                self.broker.delete(RESULT_PREFIX + uri)
        return out


# ------------------------------------------------------ HTTP fast path
class ServingHttpClient:
    """Client for the serving engine's HTTP/JSON fast path
    (``params.http_port``): one POST per record, the response returns
    on the same connection — no broker round trip.

    Same bounded retry/backoff contract as ``OutputQueue.query_meta``:
    connection-class trouble (socket errors — the server is gone or
    mid-restart) is absorbed up to ``retries`` consecutive failures
    with exponential backoff + jitter, then the last error re-raises;
    an HTTP *status* error means the server answered — an application
    outcome, not an outage — and raises :class:`ServingHttpError`
    immediately, retrying cannot fix it."""

    def __init__(self, base_url: str, retries: int = 8,
                 timeout_s: float = 30.0):
        self.base_url = base_url.rstrip("/")
        if "://" not in self.base_url:
            self.base_url = "http://" + self.base_url
        self.retries = int(retries)
        self.timeout_s = float(timeout_s)

    def _open_with_retries(self, req, timeout_s: float, retries: int,
                           consume=None, ts=None):
        """The ONE retry ladder both calls share: connection-class
        failures (socket errors — the server is gone or mid-restart)
        are absorbed up to ``retries`` consecutive attempts with
        exponential backoff + jitter, then the last error re-raises;
        an HTTP *status* error means the server answered — an
        application outcome, not an outage — and raises
        :class:`ServingHttpError` immediately.

        With ``consume`` (a ``response -> value`` callable) the WHOLE
        exchange retries — a connection dying mid-body-read re-POSTs
        the idempotent request.  Without it the open response is
        returned and only *establishing* it retried (the streaming
        caller: tokens already delivered must not replay).

        ``ts`` (a dict) receives monotonic timestamps stamped AT the
        socket, not around the ladder: ``sent_monotonic`` (the start
        of the attempt that ultimately landed — overwritten per
        retry), ``first_byte_monotonic`` (response headers arrived),
        ``received_monotonic`` (body consumed; only with
        ``consume``).  Open-loop load generators read these instead
        of re-timing the whole call, which would fold backoff sleeps
        into the server-facing number."""
        import random
        from urllib import error as urlerror
        from urllib import request as urlrequest
        delay, failures = 0.05, 0
        while True:
            try:
                if ts is not None:
                    ts["sent_monotonic"] = time.monotonic()
                r = urlrequest.urlopen(req, timeout=timeout_s)
                if ts is not None:
                    ts["first_byte_monotonic"] = time.monotonic()
                if consume is None:
                    return r
                with r:
                    out = consume(r)
                if ts is not None:
                    ts["received_monotonic"] = time.monotonic()
                return out
            except urlerror.HTTPError as e:
                try:
                    doc = json.loads(e.read().decode())
                except Exception:   # noqa: BLE001
                    doc = {}
                finally:
                    e.close()
                raise ServingHttpError(
                    e.code, doc.get("error") or str(e), doc) from None
            except (urlerror.URLError, OSError):
                failures += 1
                if failures >= max(int(retries), 1):
                    raise
                time.sleep(delay * (0.5 + random.random()))
                delay = min(delay * 2.0, 2.0)

    def predict_http(self, endpoint: str, payload, *,
                     uri: str = "", request_id: Optional[str] = None,
                     timeout_s: Optional[float] = None,
                     retries: Optional[int] = None,
                     trace=None) -> Dict[str, Any]:
        """Predict one record: ``payload`` is an ndarray (or nested
        list).  Returns the response doc ``{"value": [[class, prob],
        ...], "request_id": ..., "endpoint": ...}``.  ``trace``
        propagates an existing :class:`TraceContext` in the
        traceparent header; absent, one is stamped while tracing is
        on (the same wire string re-sent on every retry)."""
        from urllib import request as urlrequest
        if timeout_s is None:
            timeout_s = self.timeout_s
        if retries is None:
            retries = self.retries
        rid = request_id or uuid.uuid4().hex
        body = json.dumps({
            "data": np.asarray(payload).tolist(),
            "dtype": str(np.asarray(payload).dtype),
            "uri": uri,
            "request_id": rid,
        }).encode()
        headers = {"Content-Type": "application/json"}
        ctx = _stamp_trace(rid, trace, transport="http")
        if ctx is not None:
            headers[TRACE_HEADER] = ctx.to_wire()
        req = urlrequest.Request(
            f"{self.base_url}/predict/{endpoint}", data=body,
            headers=headers)
        # the whole exchange retries: the request was idempotent
        ts: Dict[str, float] = {}
        doc = self._open_with_retries(
            req, timeout_s, retries,
            consume=lambda r: json.loads(r.read().decode()), ts=ts)
        if isinstance(doc, dict):
            # socket-level monotonic stamps for open-loop measurement
            doc.setdefault("client_ts", ts)
        return doc

    def generate(self, endpoint: str, token_ids, *,
                 max_tokens: Optional[int] = None,
                 on_token=None, uri: str = "",
                 request_id: Optional[str] = None,
                 timeout_s: Optional[float] = None,
                 retries: Optional[int] = None,
                 trace=None) -> Dict[str, Any]:
        """Streaming generate against a generative endpoint
        (``POST /generate/<endpoint>``, chunked per-token responses):
        ``token_ids`` is the int input sequence (padded to the
        endpoint's ``enc_len``).  Each token is surfaced through
        ``on_token(index, token)`` the moment its chunk arrives;
        returns the final doc ``{"tokens": [...], "request_id": ...,
        "endpoint": ...}``.

        Retry contract matches :meth:`predict_http` (they share one
        ladder): connection-class failures *establishing* the stream
        are absorbed up to ``retries`` attempts with exponential
        backoff + jitter (the request was not admitted yet — retrying
        is safe); an HTTP status error raises
        :class:`ServingHttpError` immediately.  A connection dropped
        MID-stream re-raises without retry: tokens were already
        delivered, and replaying the sequence is the caller's call,
        not the client's."""
        from urllib import request as urlrequest
        if timeout_s is None:
            timeout_s = self.timeout_s
        if retries is None:
            retries = self.retries
        rid = request_id or uuid.uuid4().hex
        payload: Dict[str, Any] = {
            "data": np.asarray(token_ids, np.int64).tolist(),
            "dtype": "int32",
            "uri": uri,
            "request_id": rid,
        }
        if max_tokens:
            payload["max_tokens"] = int(max_tokens)
        headers = {"Content-Type": "application/json"}
        ctx = _stamp_trace(rid, trace, transport="http")
        if ctx is not None:
            headers[TRACE_HEADER] = ctx.to_wire()
        req = urlrequest.Request(
            f"{self.base_url}/generate/{endpoint}",
            data=json.dumps(payload).encode(),
            headers=headers)
        # only ESTABLISHING the stream retries; once chunks flow the
        # relay below runs exactly once
        ts: Dict[str, float] = {}
        r = self._open_with_retries(req, timeout_s, retries, ts=ts)
        # relay chunks (urllib undoes the chunked framing; each line
        # is one JSON event)
        with r:
            tokens = []
            for raw in r:
                line = raw.strip()
                if not line:
                    continue
                doc = json.loads(line.decode())
                if "token" in doc:
                    tokens.append(doc["token"])
                    if on_token is not None:
                        on_token(doc.get("index", len(tokens) - 1),
                                 doc["token"])
                elif doc.get("error"):
                    raise ServingHttpError(200, doc["error"], doc)
                elif doc.get("done"):
                    doc.setdefault("tokens", tokens)
                    ts["received_monotonic"] = time.monotonic()
                    doc.setdefault("client_ts", ts)
                    return doc
            # stream ended without a final line: the server died
            # mid-generation
            raise ServingHttpError(
                200, "generate stream ended without a final "
                     "'done' event", {"tokens": tokens})

    def endpoints(self) -> Dict[str, Any]:
        """The worker's registered endpoints (``GET /endpoints``)."""
        from urllib import request as urlrequest
        with urlrequest.urlopen(f"{self.base_url}/endpoints",
                                timeout=self.timeout_s) as r:
            return json.loads(r.read().decode())["endpoints"]


class ServingHttpError(RuntimeError):
    """The fast path answered with an HTTP error status."""

    def __init__(self, status: int, message: str, doc: Dict):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.doc = doc


def predict_http(base_url: str, endpoint: str, payload,
                 **kwargs) -> Dict[str, Any]:
    """One-shot convenience over :class:`ServingHttpClient`."""
    return ServingHttpClient(base_url).predict_http(
        endpoint, payload, **kwargs)
