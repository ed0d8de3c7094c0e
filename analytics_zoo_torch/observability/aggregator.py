"""Cluster observability, the worker half (port of the JAX package's
``observability/aggregator.py``, its run-dir constants and
``init_worker_observability`` / ``flush_worker_observability`` /
``reset_worker_observability``).

The launcher (``parallel/launcher.py``) gives every worker
``<run_dir>/host-<k>/`` plus a metrics port and a shared clock anchor;
each worker drops ``meta.json``, ``metrics.jsonl`` and ``trace.json``
there in the reference's layout, so a fleet's artifacts merge with the
reference's offline tools.  Not ported yet (ROADMAP.md, queue 1 item 6):
the merge half — ``ClusterAggregator`` and host 0's ``/metrics/cluster``
attach, ``merge_snapshots``/``merge_traces``/``merge_requests`` and
``straggler_report`` — and the worker's TSDB sampler, which comes with
``observability/tsdb.py``.

IMPORT DISCIPLINE: module level is stdlib-only, as in the reference;
the registry, tracer and recorder are imported inside the functions.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from typing import Dict, Optional

log = logging.getLogger("analytics_zoo_torch.observability")

CLUSTER_FILE = "cluster.json"      # written by the launcher
META_FILE = "meta.json"            # written by each worker
METRICS_FILE = "metrics.jsonl"     # registry snapshots, append-only
TRACE_FILE = "trace.json"          # Chrome trace per worker
REQUESTS_FILE = "requests.json"    # request-timeline log per worker

# env contract injected by the launcher (parallel/launcher.py)
ENV_RUN_DIR = "ZOO_TPU_RUN_DIR"
ENV_METRICS_DIR = "ZOO_TPU_METRICS_DIR"
ENV_METRICS_PORT = "ZOO_TPU_METRICS_PORT"
ENV_CLOCK_ANCHOR = "ZOO_TPU_CLOCK_ANCHOR"
ENV_PROCESS_ID = "ZOO_TPU_PROCESS_ID"


def host_dir_name(process_index: int) -> str:
    return f"host-{int(process_index)}"


# bring-up state is check-then-act shared between the caller's thread,
# atexit, and tests' reset — the lock makes init idempotence and
# init-vs-reset ordering atomic
_worker_state: Dict = {}
_worker_lock = threading.Lock()


def init_worker_observability(run_dir: Optional[str] = None,
                              process_index: Optional[int] = None,
                              metrics_port: Optional[int] = None,
                              start_server: bool = True,
                              register_atexit: bool = True
                              ) -> Optional[str]:
    """Worker half of the plane, driven by the launcher's env contract.

    Reads ``ZOO_TPU_RUN_DIR`` / ``ZOO_TPU_PROCESS_ID`` /
    ``ZOO_TPU_METRICS_PORT`` / ``ZOO_TPU_CLOCK_ANCHOR`` (explicit args
    override), then:

    1. stamps the immutable ``host``/``process_index`` const labels on
       the process registry,
    2. creates ``<run_dir>/host-<k>/`` and writes ``meta.json``,
    3. starts a ``MetricsServer`` on the injected port,
    4. starts the flight recorder in the slot (``events.jsonl``, and a
       ``blackbox.json`` on any death it can see),
    5. registers an atexit flush (final ``metrics.jsonl`` snapshot +
       ``trace.json``) so offline aggregation works even for workers
       that die between scrapes.

    Idempotent; returns the worker dir (None when no run dir is
    configured)."""
    with _worker_lock:
        if _worker_state.get("dir"):
            return _worker_state["dir"]
        run_dir = run_dir if run_dir is not None \
            else os.environ.get(ENV_RUN_DIR)
        if not run_dir:
            return None
        if process_index is None:
            process_index = int(os.environ.get(ENV_PROCESS_ID, "0"))
        if metrics_port is None:
            raw = os.environ.get(ENV_METRICS_PORT)
            metrics_port = int(raw) if raw else 0
        anchor = float(os.environ.get(ENV_CLOCK_ANCHOR, time.time()))
        hostname = socket.gethostname()
        name = f"{hostname}/{process_index}"

        wdir = os.environ.get(ENV_METRICS_DIR) or \
            os.path.join(run_dir, host_dir_name(process_index))
        os.makedirs(wdir, exist_ok=True)

        from analytics_zoo_torch.observability.metrics import get_registry
        registry = get_registry()
        registry.set_const_labels(host=hostname,
                                  process_index=str(process_index))

        server = None
        if start_server:
            try:
                from analytics_zoo_torch.observability.exporter import \
                    MetricsServer
                server = MetricsServer(port=metrics_port).start()
                metrics_port = server.port
            except Exception:   # noqa: BLE001 — observability never blocks
                log.exception("worker metrics server failed to start")
                server = None

        meta = {
            "name": name,
            "hostname": hostname,
            "process_index": int(process_index),
            "pid": os.getpid(),
            "metrics_port": metrics_port,
            "clock_anchor": anchor,
            "started_unix": time.time(),
        }
        with open(os.path.join(wdir, META_FILE), "w") as f:
            json.dump(meta, f, indent=2)

        try:
            from analytics_zoo_torch.observability import \
                flightrec as _flightrec
            _flightrec.init_flightrec(
                wdir, process_index=int(process_index),
                clock_anchor=anchor)
        except Exception:   # noqa: BLE001
            log.exception("worker flight-recorder bring-up failed")

        _worker_state.update({"dir": wdir, "meta": meta,
                              "server": server, "run_dir": run_dir})
    if register_atexit:
        import atexit
        atexit.register(flush_worker_observability)
    log.info("cluster observability worker %s -> %s (port %s)",
             name, wdir, metrics_port)
    return wdir


def flush_worker_observability() -> Optional[str]:
    """Append a registry snapshot line and (re)write the Chrome trace and
    the request log into this worker's run-dir slot, and dump the
    recorder's blackbox.  Safe to call repeatedly (epoch boundaries,
    atexit); no-op before :func:`init_worker_observability`."""
    wdir = _worker_state.get("dir")
    if not wdir:
        return None
    try:
        from analytics_zoo_torch.observability.metrics import get_registry
        get_registry().write_jsonl(os.path.join(wdir, METRICS_FILE))
    except Exception:   # noqa: BLE001
        log.exception("worker metrics flush failed")
    try:
        from analytics_zoo_torch.observability.tracing import get_tracer
        get_tracer().export_chrome_trace(os.path.join(wdir, TRACE_FILE))
    except Exception:   # noqa: BLE001
        log.exception("worker trace flush failed")
    try:
        from analytics_zoo_torch.observability.reqtrace import \
            get_request_log
        get_request_log().export(os.path.join(wdir, REQUESTS_FILE))
    except Exception:   # noqa: BLE001
        log.exception("worker request-log flush failed")
    try:
        from analytics_zoo_torch.observability import \
            flightrec as _flightrec
        _flightrec.flush_active_flightrec(
            "flush",
            registry_snapshot=_flightrec._default_registry_snapshot(),
            request_snapshot=_flightrec._default_request_snapshot())
    except Exception:   # noqa: BLE001
        log.exception("worker blackbox flush failed")
    return wdir


def reset_worker_observability() -> None:
    """Drop worker bring-up state (test helper); stops the server and
    the recorder."""
    with _worker_lock:
        server = _worker_state.get("server")
        if server is not None:
            try:
                server.stop()
            except Exception:   # noqa: BLE001
                pass
        _worker_state.clear()
    try:
        from analytics_zoo_torch.observability.flightrec import \
            reset_flightrec
        reset_flightrec()
    except Exception:   # noqa: BLE001
        pass
