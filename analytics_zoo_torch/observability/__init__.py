"""Observability for the serving slice: metrics registry, span tracing,
request tracing, the flight recorder, device telemetry, and a scrape
endpoint (port of the JAX package's ``observability/``).

One process-wide :class:`MetricsRegistry` that serving and inference
instrument into; a :class:`Tracer` whose ``span("name")`` blocks export
as Chrome-trace JSON (Perfetto); :func:`sample_device_telemetry` pulling
the CUDA allocator's counters into gauges; and :class:`MetricsServer`
exposing it all over HTTP ``/metrics`` (Prometheus text exposition)
without any third-party dependency.  The compile half of the
diagnostics (``diagnostics.py``) and the worker half of the cluster
aggregator (``aggregator.py``: the run-dir slot a fleet worker writes)
are ported; the rest of the reference's observability (MFU, watchdog,
the aggregator's merge half, TSDB, SLO,
drift, incident forensics, collectives accounting) is not ported yet
(ROADMAP.md, queue 1).

Quick use::

    from analytics_zoo_torch.observability import (
        get_registry, span, start_metrics_server)

    reqs = get_registry().counter("my_requests_total", "requests")
    with span("handle", route="/predict"):
        reqs.inc()
    start_metrics_server(port=9090)   # scrape :9090/metrics
"""

from analytics_zoo_torch.observability.metrics import (
    DEFAULT_BUCKETS,
    EPOCH_BUCKETS,
    MetricsRegistry,
    get_registry,
    reset_registry,
)
from analytics_zoo_torch.observability.tracing import (
    Tracer,
    get_tracer,
    reset_tracer,
    span,
)
from analytics_zoo_torch.observability.telemetry import (
    TelemetrySampler,
    sample_device_telemetry,
)
from analytics_zoo_torch.observability.exporter import (
    MetricsServer,
    start_metrics_server,
)
from analytics_zoo_torch.observability.reqtrace import (
    TRACE_FIELD,
    TRACE_HEADER,
    RequestLog,
    RequestTimeline,
    TraceContext,
    get_request_log,
    merge_timeline_dicts,
    reset_request_log,
)
from analytics_zoo_torch.observability.flightrec import (
    EVENT_KINDS,
    FlightRecorder,
    flush_active_flightrec,
    get_active_flightrec,
    init_flightrec,
    record_event,
    reset_flightrec,
)
from analytics_zoo_torch.observability.aggregator import (
    flush_worker_observability,
    init_worker_observability,
    reset_worker_observability,
)
from analytics_zoo_torch.observability.diagnostics import (
    CompileMonitor,
    get_compile_monitor,
    reset_compile_monitor,
    step_attribution_histogram,
)

__all__ = [
    "flush_worker_observability",
    "init_worker_observability",
    "reset_worker_observability",
    "CompileMonitor",
    "get_compile_monitor",
    "reset_compile_monitor",
    "step_attribution_histogram",
    "DEFAULT_BUCKETS",
    "EPOCH_BUCKETS",
    "MetricsRegistry",
    "get_registry",
    "reset_registry",
    "Tracer",
    "get_tracer",
    "reset_tracer",
    "span",
    "TelemetrySampler",
    "sample_device_telemetry",
    "MetricsServer",
    "start_metrics_server",
    "TRACE_FIELD",
    "TRACE_HEADER",
    "RequestLog",
    "RequestTimeline",
    "TraceContext",
    "get_request_log",
    "merge_timeline_dicts",
    "reset_request_log",
    "EVENT_KINDS",
    "FlightRecorder",
    "flush_active_flightrec",
    "get_active_flightrec",
    "init_flightrec",
    "record_event",
    "reset_flightrec",
]
