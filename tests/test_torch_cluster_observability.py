"""PyTorch port, the cluster aggregator's merge half
(``observability/aggregator.py``) against the JAX package's, and the
exporter's ``/metrics/cluster`` and ``/tsdb.json`` routes.

- A 4-host run dir (``host-<k>/`` slots with ``meta.json``,
  ``metrics.jsonl``, ``trace.json`` and ``requests.json``, host 2 the
  straggler) is written once by each package's registries, tracers and
  request logs; each package's ``ClusterAggregator`` (offline),
  ``merge_snapshots``, ``straggler_report``, ``snapshot_prometheus_text``,
  ``merge_traces`` and ``merge_requests`` over it give byte-equal
  documents after sorting keys, the merged files on disk included.
- The series-key parser round-trips the registry's escapes alike.
- Host 0's endpoint serves the federated view (``/metrics/cluster`` and
  ``.json``), a worker's 404s, and ``/tsdb.json`` answers from the
  active TSDB writer.
- ``init_worker_observability`` inside a run dir attaches the aggregator
  on host 0 and starts the TSDB sampler in the slot;
  ``flush_worker_observability`` leaves a fresh sample there."""

import importlib
import json
import os
import urllib.error
import urllib.request

import pytest

from analytics_zoo_tpu.observability import aggregator as jagg
from analytics_zoo_torch.observability import aggregator as tagg
from analytics_zoo_torch.observability.exporter import MetricsServer
from analytics_zoo_torch.observability.metrics import MetricsRegistry

PKGS = {"jax": "analytics_zoo_tpu", "torch": "analytics_zoo_torch"}
STEP_S = {0: 0.01, 1: 0.01, 2: 0.03, 3: 0.01}


def _mod(pkg, name):
    return importlib.import_module(f"{PKGS[pkg]}.observability.{name}")


def _registry(pkg, host, pid, steps=20):
    reg = _mod(pkg, "metrics").MetricsRegistry()
    reg.set_const_labels(host=host, process_index=str(pid))
    c = reg.counter("train_steps_total", "steps", labels=("path",))
    h = reg.histogram("train_step_latency_seconds", "lat",
                      labels=("path",))
    b = reg.histogram("train_barrier_wait_seconds", "barrier")
    barrier = 0.0 if pid == 2 else 0.02
    for _ in range(steps):
        c.labels("per_step").inc()
        h.labels("per_step").observe(STEP_S[pid])
        b.observe(barrier)
    reg.gauge("train_prefetch_queue_depth", "depth").set(pid)
    return reg


def _run_dir(pkg, root):
    """Four host slots written by ``pkg``'s registries, tracers and
    request logs, in the worker half's layout."""
    run_dir = str(root)
    tracing, reqtrace = _mod(pkg, "tracing"), _mod(pkg, "reqtrace")
    for pid in range(4):
        wdir = os.path.join(run_dir, f"host-{pid}")
        os.makedirs(wdir)
        with open(os.path.join(wdir, "meta.json"), "w") as f:
            json.dump({"name": f"h{pid}/{pid}", "hostname": f"h{pid}",
                       "process_index": pid, "pid": 100 + pid,
                       "metrics_port": 0, "clock_anchor": 1000.0,
                       "started_unix": 1000.0 + pid}, f)
        _registry(pkg, f"h{pid}", pid).write_jsonl(
            os.path.join(wdir, "metrics.jsonl"))
        tracer = tracing.Tracer()
        with tracer.span("step", host=pid):
            pass
        doc = tracer.chrome_trace()
        # fixed times, so the two packages' traces are the same bytes
        doc["otherData"]["wall_time_origin"] = 1000.0 + 0.5 * pid
        for e in doc["traceEvents"]:
            if "ts" in e:
                e["ts"] = 10.0 * (pid + 1)
            if "dur" in e:
                e["dur"] = 5.0
            e.pop("tid", None)
        with open(os.path.join(wdir, "trace.json"), "w") as f:
            json.dump(doc, f)
        log = reqtrace.RequestLog(capacity=16, sample_every=1)
        for r in range(3):
            # a hex request id is the trace id: shared across the hosts
            trace = reqtrace.TraceContext.new(request_id=f"{r:032x}")
            log.begin(trace, transport="redis", t=1.0)
            log.mark(trace, "decode", t=1.0 + 0.001 * pid)
            log.finish(trace, "ok", t=1.01 + 0.002 * pid)
        snap = log.snapshot()
        for tl in snap.get("timelines", []):
            tl["wall0"] = 2000.0 + pid
        with open(os.path.join(wdir, "requests.json"), "w") as f:
            json.dump(snap, f)
    return run_dir


def _canon(doc):
    return json.dumps(doc, sort_keys=True)


@pytest.mark.parametrize("producer", ["jax", "torch"])
def test_both_packages_merge_a_run_dir_the_same(tmp_path, producer):
    run_dir = _run_dir(producer, tmp_path / "run")
    out = {}
    for name, agg in (("jax", jagg), ("torch", tagg)):
        ca = agg.ClusterAggregator.from_run_dir(run_dir, offline=True)
        host_snaps, merged = ca.cluster_view()
        assert len(host_snaps) == 4
        traces = agg.merge_traces(
            run_dir, os.path.join(run_dir, f"trace-{name}.json"))
        reqs = agg.merge_requests(
            run_dir, os.path.join(run_dir, f"requests-{name}.json"))
        out[name] = {
            "merged": _canon(merged),
            "snapshots": _canon(agg.merge_snapshots(host_snaps)),
            "straggler": _canon(agg.straggler_report(host_snaps)),
            "text": agg.snapshot_prometheus_text(
                agg.merge_snapshots(host_snaps)),
            "live_text": ca.prometheus_text(),
            "gauges": _canon(agg.cluster_gauges(
                agg.straggler_report(host_snaps))),
            "traces": _canon(traces),
            "requests": _canon(reqs),
            "trace_file": _canon(json.load(open(os.path.join(
                run_dir, f"trace-{name}.json")))),
            "requests_file": _canon(json.load(open(os.path.join(
                run_dir, f"requests-{name}.json")))),
        }
    for key in out["jax"]:
        assert out["torch"][key] == out["jax"][key], key
    merged = json.loads(out["torch"]["merged"])
    assert merged["cluster"]["straggler"] == "h2/2"
    assert merged["counters"]['train_steps_total{path="per_step"}'] == 80.0
    reqs = json.loads(out["torch"]["requests"])
    assert reqs["hosts_merged"] == 4 and len(reqs["timelines"]) == 3
    traces = json.loads(out["torch"]["traces"])
    assert traces["otherData"]["hosts_merged"] == 4
    assert traces["otherData"]["producer"] == \
        "analytics_zoo_tpu.observability.aggregator"


def test_series_keys_round_trip_alike():
    for pairs in ((("k", 'a"b\\c\nd'), ("z", "plain")), ()):
        keys = [m.format_series_key("m", pairs) for m in (jagg, tagg)]
        assert keys[1] == keys[0]
        assert tagg.parse_series_key(keys[0]) == \
            jagg.parse_series_key(keys[0])
    assert tagg.with_label('m{a="1"}', "host", "h/0") == \
        jagg.with_label('m{a="1"}', "host", "h/0")


def test_the_cluster_routes_on_host_zero():
    r0 = _registry("torch", "w0", 0)
    r1 = _registry("torch", "w1", 2)
    s1 = MetricsServer(port=0, host="127.0.0.1", registry=r1).start()
    s0 = None
    try:
        agg = tagg.ClusterAggregator([
            tagg.WorkerSource("w0/0", fetch=r0.snapshot),
            tagg.WorkerSource("w1/1", url=f"http://127.0.0.1:{s1.port}"),
        ])
        s0 = MetricsServer(port=0, host="127.0.0.1", registry=r0,
                           aggregator=agg).start()
        base = f"http://127.0.0.1:{s0.port}"
        text = urllib.request.urlopen(base + "/metrics/cluster",
                                      timeout=5).read().decode()
        assert 'train_steps_total{path="per_step"} 40' in text
        assert 'cluster_is_straggler{host="w1/1"} 1' in text
        doc = json.loads(urllib.request.urlopen(
            base + "/metrics/cluster.json", timeout=5).read().decode())
        assert doc["cluster"]["straggler"] == "w1/1"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(
                f"http://127.0.0.1:{s1.port}/metrics/cluster", timeout=5)
        assert err.value.code == 404
    finally:
        s1.stop()
        if s0 is not None:
            s0.stop()


def test_tsdb_json_route(tmp_path):
    from analytics_zoo_torch.observability import tsdb
    reg = MetricsRegistry()
    reg.counter("demo_requests_total", "r").inc(5)
    srv = MetricsServer(port=0, host="127.0.0.1", registry=reg).start()
    try:
        base = f"http://127.0.0.1:{srv.port}/tsdb.json"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base, timeout=5)
        assert err.value.code == 404
        tsdb.init_tsdb(str(tmp_path / "tsdb"), interval_s=3600.0,
                       registry=reg)
        tsdb.flush_active_tsdb()
        index = json.loads(urllib.request.urlopen(
            base, timeout=5).read().decode())
        assert "demo_requests_total" in index["counter_keys"]
        sel = json.loads(urllib.request.urlopen(
            base + "?selector=demo_requests_total", timeout=5)
            .read().decode())
        assert sel["series"] and sel["samples"] >= 1
    finally:
        tsdb.reset_tsdb()
        srv.stop()


def test_worker_bring_up_attaches_the_aggregator_and_the_tsdb(
        tmp_path, monkeypatch):
    from analytics_zoo_torch.observability import tsdb
    from analytics_zoo_torch.observability.metrics import reset_registry
    run_dir = str(tmp_path / "run")
    monkeypatch.setenv("ZOO_TPU_RUN_DIR", run_dir)
    monkeypatch.setenv("ZOO_TPU_PROCESS_ID", "0")
    monkeypatch.delenv("ZOO_TPU_METRICS_DIR", raising=False)
    reset_registry()
    try:
        wdir = tagg.init_worker_observability(register_atexit=False)
        assert wdir == os.path.join(run_dir, "host-0")
        server = tagg._worker_state["server"]
        assert isinstance(server.aggregator, tagg.ClusterAggregator)
        assert tsdb.get_active_tsdb() is not None
        tagg.flush_worker_observability()
        for name in ("meta.json", "metrics.jsonl", "trace.json",
                     "requests.json"):
            assert os.path.exists(os.path.join(wdir, name)), name
        assert tsdb.read_samples(os.path.join(wdir, tsdb.TSDB_DIRNAME))
        doc = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics/cluster.json",
            timeout=5).read().decode())
        assert doc["cluster"]["expected_hosts"] == 1
    finally:
        tagg.reset_worker_observability()
        reset_registry()
