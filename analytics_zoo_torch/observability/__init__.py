"""Observability for the serving slice: metrics registry, span tracing,
request tracing, the flight recorder, device telemetry, and a scrape
endpoint (port of the JAX package's ``observability/``).

One process-wide :class:`MetricsRegistry` that serving and inference
instrument into; a :class:`Tracer` whose ``span("name")`` blocks export
as Chrome-trace JSON (Perfetto); :func:`sample_device_telemetry` pulling
the CUDA allocator's counters into gauges; and :class:`MetricsServer`
exposing it all over HTTP ``/metrics`` (Prometheus text exposition)
without any third-party dependency.  Beside them: the compile half of
the diagnostics (``diagnostics.py``), the training-health watchdog
(``watchdog.py``), the cluster aggregator (``aggregator.py``: the
run-dir slot a fleet worker writes, and the merge of a run dir's slots),
the embedded time-series store (``tsdb.py``), SLO burn rates
(``slo.py``), drift detection (``drift.py``) and incident forensics
(``incident.py``), and the collectives accounting (``collectives.py``).
Not ported yet (ROADMAP.md, queue 1): MFU.

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
from analytics_zoo_torch.observability.collectives import (
    estimate_train_step_collectives,
    record_step_collectives,
)
from analytics_zoo_torch.observability.aggregator import (
    ClusterAggregator,
    WorkerSource,
    flush_worker_observability,
    init_worker_observability,
    merge_requests,
    merge_snapshots,
    merge_traces,
    reset_worker_observability,
    straggler_report,
)
from analytics_zoo_torch.observability.watchdog import (
    TrainingHalted,
    TrainingWatchdog,
    get_active_watchdog,
    set_active_watchdog,
)
from analytics_zoo_torch.observability.tsdb import (
    SeriesStore,
    TsdbSampler,
    TsdbWriter,
    flush_active_tsdb,
    get_active_tsdb,
    init_tsdb,
    reset_tsdb,
)
from analytics_zoo_torch.observability.slo import (
    BurnWindow,
    SloEngine,
    SloObjective,
    SloStatus,
    evaluate_timeline,
    load_slo_yaml,
    parse_slo_specs,
)
from analytics_zoo_torch.observability.drift import (
    DriftDetector,
    DriftWatch,
    drift_report,
)
from analytics_zoo_torch.observability.incident import (
    diagnose,
    render_incident,
    write_incident,
)
from analytics_zoo_torch.observability.diagnostics import (
    CompileMonitor,
    get_compile_monitor,
    reset_compile_monitor,
    step_attribution_histogram,
)

__all__ = [
    "ClusterAggregator",
    "WorkerSource",
    "flush_worker_observability",
    "init_worker_observability",
    "merge_requests",
    "merge_snapshots",
    "merge_traces",
    "reset_worker_observability",
    "straggler_report",
    "TrainingHalted",
    "TrainingWatchdog",
    "get_active_watchdog",
    "set_active_watchdog",
    "SeriesStore",
    "TsdbSampler",
    "TsdbWriter",
    "flush_active_tsdb",
    "get_active_tsdb",
    "init_tsdb",
    "reset_tsdb",
    "BurnWindow",
    "SloEngine",
    "SloObjective",
    "SloStatus",
    "evaluate_timeline",
    "load_slo_yaml",
    "parse_slo_specs",
    "DriftDetector",
    "DriftWatch",
    "drift_report",
    "diagnose",
    "render_incident",
    "write_incident",
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
    "estimate_train_step_collectives",
    "record_step_collectives",
]
