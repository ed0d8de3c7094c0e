"""Scrape endpoint: a stdlib ``http.server`` serving the registry in
Prometheus text exposition plus JSON snapshot and Chrome-trace views.

Routes:
    /metrics          Prometheus text exposition 0.0.4 (scrape target);
                      ``?exemplars=1`` appends OpenMetrics-style
                      exemplars (bucket → representative trace_id)
    /metrics.json     registry snapshot as JSON
    /requests.json    the request log's kept timelines (tail-sampled
                      per-request station waterfalls, newest last)
    /tsdb.json        the embedded time-series store's recent samples
                      (``?selector=name{label="v"}``, ``?start=``/
                      ``?end=`` unix seconds filter the answer) — the
                      live query face of ``observability/tsdb.py``
    /metrics/cluster  federated CLUSTER view (host 0 of a multi-host
                      run, when a ClusterAggregator is attached):
                      counters summed across hosts, histograms merged,
                      gauges as per-host vectors, plus the
                      cluster_* skew/straggler gauges
    /metrics/cluster.json  same view as JSON, including the full
                      straggler/collective report under "cluster"
    /trace            Chrome-trace JSON of the span tracer (Perfetto)
    /healthz          liveness ("ok") — or a READINESS probe when the
                      owner installed a ``health_check``: 200 JSON when
                      healthy, 503 JSON naming the reason when not
                      (serving wires its queue-depth / error-rate
                      thresholds in here)

Port 0 binds an ephemeral port (``server.port`` has the real one) —
what tests and multi-worker hosts use to avoid collisions.

Bind host: ``host=None`` resolves ``observability.bind_host`` from the
config (default ``0.0.0.0``).  The endpoint is UNAUTHENTICATED — on a
shared network set ``observability.bind_host 127.0.0.1`` (or a
scrape-only interface) and front it with your scrape proxy.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import unquote as _unquote

from analytics_zoo_torch.observability.metrics import (
    MetricsRegistry, get_registry)
from analytics_zoo_torch.observability.tracing import Tracer, get_tracer

log = logging.getLogger("analytics_zoo_torch.observability")

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    server_version = "zoo-torch-metrics/1.0"

    def _respond(self, body: bytes, content_type: str,
                 status: int = 200) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        path, _, query = self.path.partition("?")
        try:
            if path in ("/metrics", "/"):
                exemplars = "exemplars=1" in query.split("&")
                body = self.server.registry.prometheus_text(
                    exemplars=exemplars).encode()
                self._respond(body, PROM_CONTENT_TYPE)
            elif path == "/metrics.json":
                body = json.dumps(self.server.registry.snapshot(),
                                  indent=2).encode()
                self._respond(body, "application/json")
            elif path == "/requests.json":
                from analytics_zoo_torch.observability.reqtrace import (
                    get_request_log)
                body = json.dumps(
                    get_request_log().snapshot()).encode()
                self._respond(body, "application/json")
            elif path == "/tsdb.json":
                from analytics_zoo_torch.observability import tsdb
                writer = tsdb.get_active_tsdb()
                if writer is None:
                    self._respond(
                        b"no tsdb writer active (init_worker_"
                        b"observability starts one inside a run dir)",
                        "text/plain", 404)
                else:
                    params = {}
                    for part in query.split("&"):
                        k, _, v = part.partition("=")
                        if v:
                            params[k] = _unquote(v)
                    store = tsdb.SeriesStore.from_writer(writer)
                    t0, t1 = store.time_range()
                    start = float(params.get("start") or t0 or 0.0)
                    end = float(params.get("end") or t1 or 0.0)
                    sel = params.get("selector")
                    doc = {"start": start, "end": end,
                           "samples": len(store.samples)}
                    if sel:
                        doc["series"] = store.query(sel, start, end)
                    else:
                        # no selector: index answer — the keys
                        # present, not every point
                        doc["counter_keys"] = store.counter_keys("")
                        doc["gauge_keys"] = store.gauge_keys("")
                    body = json.dumps(doc).encode()
                    self._respond(body, "application/json")
            elif path in ("/metrics/cluster", "/metrics/cluster.json"):
                agg = getattr(self.server, "aggregator", None)
                if agg is None:
                    self._respond(
                        b"no cluster aggregator attached (this is a "
                        b"worker endpoint; scrape host 0)",
                        "text/plain", 404)
                elif path.endswith(".json"):
                    body = json.dumps(agg.cluster_snapshot(),
                                      indent=2).encode()
                    self._respond(body, "application/json")
                else:
                    body = agg.prometheus_text().encode()
                    self._respond(body, PROM_CONTENT_TYPE)
            elif path == "/trace":
                body = json.dumps(
                    self.server.tracer.chrome_trace()).encode()
                self._respond(body, "application/json")
            elif path == "/healthz":
                check = getattr(self.server, "health_check", None)
                if check is None:
                    self._respond(b"ok", "text/plain")
                else:
                    try:
                        reason = check()
                    except Exception:
                        log.exception("health check raised")
                        reason = {"reason": "health check raised"}
                    if reason:
                        body = json.dumps(
                            {"ready": False, **reason}).encode()
                        self._respond(body, "application/json", 503)
                    else:
                        self._respond(b'{"ready": true}',
                                      "application/json")
            else:
                self._respond(b"not found", "text/plain", 404)
        except Exception:  # a scrape must never kill the server thread
            log.exception("metrics request failed: %s", self.path)
            try:
                self._respond(b"internal error", "text/plain", 500)
            except Exception:
                pass

    def log_message(self, fmt, *args):  # scrapes are periodic; stay quiet
        log.debug("metrics http: " + fmt, *args)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class MetricsServer:
    """Owns the HTTP listener + its serve thread.  ``start`` is
    idempotent; ``stop`` releases the port."""

    def __init__(self, port: int = 0, host: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 health_check=None, aggregator=None):
        if host is None:
            host = default_bind_host()
        self._requested = (host, int(port))
        self.registry = registry if registry is not None \
            else get_registry()
        self.tracer = tracer if tracer is not None else get_tracer()
        # readiness probe: a callable returning None (healthy) or a
        # JSON-able dict naming the reason (-> 503 on /healthz)
        self.health_check = health_check
        # host-0 federation point: a ClusterAggregator serving the
        # /metrics/cluster routes (workers leave this None)
        self.aggregator = aggregator
        self._httpd: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        self._httpd = _Server(self._requested, _Handler)
        self._httpd.registry = self.registry
        self._httpd.tracer = self.tracer
        self._httpd.health_check = self.health_check
        self._httpd.aggregator = self.aggregator
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"zoo-metrics-http:{self.port}")
        self._thread.start()
        log.info("metrics endpoint listening on :%d/metrics", self.port)
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._httpd = None
        self._thread = None


def default_bind_host() -> str:
    """The configured bind interface (``observability.bind_host``);
    falls back to all interfaces to preserve the historical default."""
    try:
        from analytics_zoo_torch.common.config import get_config
        return str(get_config().get("observability.bind_host",
                                    "0.0.0.0") or "0.0.0.0")
    except Exception:
        return "0.0.0.0"


def start_metrics_server(port: int = 0, host: Optional[str] = None,
                         registry: Optional[MetricsRegistry] = None,
                         tracer: Optional[Tracer] = None,
                         health_check=None,
                         aggregator=None) -> MetricsServer:
    """Build + start in one call; returns the server (``.port`` holds
    the bound port when ``port=0``)."""
    return MetricsServer(port=port, host=host, registry=registry,
                         tracer=tracer, health_check=health_check,
                         aggregator=aggregator).start()
