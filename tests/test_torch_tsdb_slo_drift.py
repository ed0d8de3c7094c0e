"""PyTorch port, the embedded TSDB, the SLO burn-rate engine and the drift
detectors (``observability/tsdb.py``, ``slo.py``, ``drift.py``) against
the JAX package's, on the same inputs.

- TSDB: each package writes segments from the same snapshots at the same
  injected times; the files are byte-identical, each package reads the
  other's (a torn tail and a corrupt line included, each costing one
  sample), and a writer of either package seals the other's torn line.
- SLO: ``SloEngine`` burn rates, budgets and alerts and
  ``evaluate_timeline`` agree EXACTLY (``==`` on every float) on the same
  stored series, for the repo's ``slo.yaml`` and the reference's burn
  fixtures; the YAML parser gives the same specs.
- Drift: ``drift_report`` and ``DriftDetector`` scores within 1e-12 (the
  same float64 arithmetic in the same order: in practice equal).
- The stdlib-only contract: each of ``tsdb``, ``slo``, ``drift``,
  ``incident`` and ``aggregator`` imports in a fresh interpreter without
  pulling torch or numpy in."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from analytics_zoo_tpu.observability import drift as jdrift
from analytics_zoo_tpu.observability import slo as jslo
from analytics_zoo_tpu.observability import tsdb as jtsdb
from analytics_zoo_tpu.observability.metrics import (
    MetricsRegistry as JRegistry)

from analytics_zoo_torch.observability import drift as tdrift
from analytics_zoo_torch.observability import slo as tslo
from analytics_zoo_torch.observability import tsdb as ttsdb
from analytics_zoo_torch.observability.metrics import MetricsRegistry

REPO = pathlib.Path(__file__).resolve().parents[1]
SLO_YAML = str(REPO / "slo.yaml")
DRIFT_ATOL = 1e-12
PKGS = {"jax": (jtsdb, jslo, jdrift, JRegistry),
        "torch": (ttsdb, tslo, tdrift, MetricsRegistry)}


def _snapshots():
    """A registry's snapshots over 30 ticks: counters, a labelled
    counter, gauges and a histogram, with one counter reset."""
    out = []
    total = bad = 0
    for i in range(30):
        total += 100
        bad += 7 if 10 <= i < 14 else 0
        req = total if i != 20 else 3.0     # a process restart
        out.append((1000.0 + 5.0 * i, {
            "counters": {"serving_records_total": float(req),
                         'serving_errors_total{endpoint="a"}': float(bad)},
            "gauges": {"serving_queue_depth": float(i % 5),
                       "serving_breaker_state": 2.0 if i == 12 else 0.0},
            "histograms": {"serving_request_latency_seconds": {
                "count": 10 * (i + 1), "sum": 0.3 * (i + 1),
                "le": [0.05, 0.1, 0.5], "cum": [4 * (i + 1), 8 * (i + 1),
                                                10 * (i + 1)],
                "p50": 0.05, "p95": 0.1, "p99": 0.5}}}))
    return out


def _write(mod, d, **kw):
    w = mod.TsdbWriter(str(d), **kw)
    for now, snap in _snapshots():
        w.append(json.loads(json.dumps(snap)), now=now)
    w.close()


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


# ------------------------------------------------------------------- tsdb
@pytest.mark.parametrize("roll", [False, True])
def test_segments_are_byte_identical(tmp_path, roll):
    kw = dict(segment_max_bytes=1500, retention_bytes=6000,
              retention_age_s=1e9) if roll else {}
    _write(jtsdb, tmp_path / "jax", **kw)
    _write(ttsdb, tmp_path / "torch", **kw)
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "torch")
    assert got == want
    if roll:
        assert len(got) > 1       # the roll and the ring really ran


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_each_package_reads_the_others_segments_torn_tail_included(
        tmp_path, writer, reader):
    d = tmp_path / "tsdb"
    _write(PKGS[writer][0], d)
    want = PKGS[writer][0].read_samples(str(d))
    assert PKGS[reader][0].read_samples(str(d)) == want
    seg = sorted(p for p in d.iterdir() if p.name.startswith("seg-"))[-1]
    with open(seg, "a") as f:           # a SIGKILL mid-append
        f.write('{"t": 9999.0, "c": {"serving_rec')
    for name in ("jax", "torch"):
        assert PKGS[name][0].read_samples(str(d)) == want
    # the reader's own writer seals the writer's torn line
    w = PKGS[reader][0].TsdbWriter(str(d))
    w.append({"counters": {"serving_records_total": 1.0}}, now=9000.0)
    w.close()
    after = [PKGS[n][0].read_samples(str(d)) for n in ("jax", "torch")]
    assert after[0] == after[1]
    assert [s["t"] for s in after[0]] == [s["t"] for s in want] + [9000.0]


def test_a_corrupt_line_costs_itself_in_both(tmp_path):
    d = tmp_path / "tsdb"
    d.mkdir()
    (d / "seg-0000000001000-0001.jsonl").write_text(
        json.dumps({"tsdb_schema": 1, "created": 1.0}) + "\n"
        + json.dumps({"t": 1.0, "full": True, "c": {"c_total": 5.0},
                      "g": {}}) + "\n"
        + "NOT JSON AT ALL\n"
        + json.dumps({"t": 2.0, "c": {"c_total": 3.0}, "g": {}}) + "\n")
    got = [[s["counters"]["c_total"] for s in m.read_samples(str(d))]
           for m in (jtsdb, ttsdb)]
    assert got == [[5.0, 8.0], [5.0, 8.0]]


def test_series_store_queries_agree(tmp_path):
    _write(ttsdb, tmp_path / "tsdb")
    samples = ttsdb.read_samples(str(tmp_path / "tsdb"))
    stores = [m.SeriesStore(json.loads(json.dumps(samples)))
              for m in (jtsdb, ttsdb)]
    for sel in ("serving_records_total", "serving_errors_total",
                'serving_errors_total{endpoint="a"}',
                "serving_request_latency_seconds_count"):
        for t0, t1 in ((1000.0, 1145.0), (1040.0, 1110.0)):
            assert stores[1].increase(sel, t0, t1) == \
                stores[0].increase(sel, t0, t1)
        assert stores[1].query(sel, 1000.0, 1200.0) == \
            stores[0].query(sel, 1000.0, 1200.0)
    assert stores[1].gauge_points("serving_breaker_state") == \
        stores[0].gauge_points("serving_breaker_state")
    assert stores[1].counter_keys("") == stores[0].counter_keys("")


def test_the_sampler_scrapes_a_registry_into_the_same_format(tmp_path):
    out = {}
    for name, (tsdb, _s, _d, reg_cls) in PKGS.items():
        reg = reg_cls()
        reg.counter("demo_requests_total", "r").inc(3)
        reg.gauge("demo_depth", "d").set(4.0)
        w = tsdb.TsdbWriter(str(tmp_path / name))
        sampler = tsdb.TsdbSampler(w, interval_s=60.0, registry=reg)
        sampler.sample_once(now=50.0)
        reg.counter("demo_requests_total", "r").inc(2)
        sampler.sample_once(now=60.0)
        w.close()
        out[name] = [(s["t"], s["counters"].get("demo_requests_total"),
                      s["gauges"].get("demo_depth"))
                     for s in tsdb.read_samples(str(tmp_path / name))]
    assert out["torch"] == out["jax"] == [(50.0, 3.0, 4.0),
                                          (60.0, 5.0, 4.0)]


# -------------------------------------------------------------------- slo
def _linear_samples(*, step_s=60.0, steps=360, total_per_step=1000,
                    bad_fn=lambda t: 0):
    samples, total, bad = [], 0, 0
    for i in range(steps + 1):
        t = i * step_s
        samples.append({"t": t,
                        "counters": {"demo_requests_total": float(total),
                                     "demo_errors_total": float(bad)},
                        "gauges": {}})
        total += total_per_step
        bad += bad_fn(t)
    return samples


def _burn_fixtures(slo):
    """The reference's burn-math fixtures: (objectives, samples, now)."""
    def obj(**kw):
        kw.setdefault("name", "avail")
        kw.setdefault("objective", "error_rate")
        kw.setdefault("total", "demo_requests_total")
        kw.setdefault("bad", "demo_errors_total")
        return slo.SloObjective(**kw)
    exact = [slo.BurnWindow("page", 1.5, 3600.0, 300.0),
             slo.BurnWindow("warn", 1.25, 21600.0, 1800.0)]
    return [
        ([obj(target=0.5, window_s=21600.0, windows=exact)],
         _linear_samples(bad_fn=lambda t: 750), 21600.0),
        ([obj(target=0.5, window_s=21600.0, windows=exact)],
         _linear_samples(bad_fn=lambda t: 749), 21600.0),
        ([obj(target=0.5, window_s=600.0, recovery_hold_s=20.0,
              windows=[slo.BurnWindow("page", 2.0, 60.0, 10.0),
                       slo.BurnWindow("warn", 1.0, 120.0, 30.0)])],
         _linear_samples(step_s=5.0, steps=120, total_per_step=100,
                         bad_fn=lambda t: 100 if 200.0 <= t < 280.0
                         else 0), None),
    ]


def _statuses(rows):
    return [[st.to_dict() for st in row] for row in rows]


def test_burn_rates_and_timelines_agree_exactly():
    jfx, tfx = _burn_fixtures(jslo), _burn_fixtures(tslo)
    for (jobjs, samples, now), (tobjs, _s, _n) in zip(jfx, tfx):
        jstore = jtsdb.SeriesStore(json.loads(json.dumps(samples)))
        tstore = ttsdb.SeriesStore(json.loads(json.dumps(samples)))
        if now is not None:
            want = [s.to_dict() for s in
                    jslo.SloEngine(jobjs).evaluate(jstore, now=now)]
            got = [s.to_dict() for s in
                   tslo.SloEngine(tobjs).evaluate(tstore, now=now)]
            assert got == want
        assert _statuses(tslo.evaluate_timeline(tstore, tobjs)) == \
            _statuses(jslo.evaluate_timeline(jstore, jobjs))


def test_the_repos_slo_yaml_over_a_stored_run(tmp_path):
    _write(ttsdb, tmp_path / "tsdb")
    samples = ttsdb.read_samples(str(tmp_path / "tsdb"))
    jobjs = [o.scaled(0.005) for o in jslo.load_slo_yaml(SLO_YAML)]
    tobjs = [o.scaled(0.005) for o in tslo.load_slo_yaml(SLO_YAML)]
    assert [o.name for o in tobjs] == [o.name for o in jobjs]
    assert len(tobjs) >= 2
    jstore = jtsdb.SeriesStore(json.loads(json.dumps(samples)))
    tstore = ttsdb.SeriesStore(json.loads(json.dumps(samples)))
    _t0, t1 = tstore.time_range()
    assert [s.to_dict() for s in tslo.SloEngine(tobjs).evaluate(
        tstore, now=t1)] == \
        [s.to_dict() for s in jslo.SloEngine(jobjs).evaluate(
            jstore, now=t1)]
    assert _statuses(tslo.evaluate_timeline(tstore, tobjs)) == \
        _statuses(jslo.evaluate_timeline(jstore, jobjs))


def test_yaml_specs_parse_the_same():
    text = pathlib.Path(SLO_YAML).read_text()
    specs = [m.parse_slo_specs(m._parse_yaml_subset(text))
             for m in (jslo, tslo)]
    assert [repr(o) for o in specs[1]] == [repr(o) for o in specs[0]]
    # a bare list; malformed entries skipped alike
    doc = [{"name": "a", "objective": "error_rate", "total": "t",
            "bad": "b"}, "junk", {"objective": "no name"}]
    assert [repr(o) for o in tslo.parse_slo_specs(doc)] == \
        [repr(o) for o in jslo.parse_slo_specs(doc)]
    # an unknown objective kind is refused at evaluation, with the same
    # exception and message
    msgs = []
    for tsdb, slo in ((jtsdb, jslo), (ttsdb, tslo)):
        objs = slo.parse_slo_specs([{"name": "x", "objective": "nope"}])
        with pytest.raises(ValueError) as e:
            slo.SloEngine(objs).evaluate(
                tsdb.SeriesStore(_linear_samples(steps=2)), now=120.0)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0] and "nope" in msgs[0]


def test_the_engine_publishes_the_same_gauges():
    out = []
    for name, (tsdb, slo, _d, reg_cls) in PKGS.items():
        reg = reg_cls()
        objs = _burn_fixtures(slo)[0][0]
        store = tsdb.SeriesStore(_linear_samples(bad_fn=lambda t: 750))
        slo.SloEngine(objs, registry=reg).evaluate(store, now=21600.0)
        out.append({k: v for k, v in reg.snapshot()["gauges"].items()
                    if k.startswith("slo_")})
    assert out[0] and out[1] == out[0]


# ------------------------------------------------------------------ drift
def _drift_samples():
    samples = [{"t": float(t), "counters": {},
                "gauges": {"queue_depth": 5.0 + (t % 2), "calm": 1.0,
                           "wave": [0.0, 10.0, 0.0, 10.0][t % 4]}}
               for t in range(40)]
    samples.append({"t": 40.0, "counters": {},
                    "gauges": {"queue_depth": 500.0, "calm": 1.0,
                               "wave": 10.0}})
    return samples


def _close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    elif isinstance(want, float):
        assert abs(got - want) <= DRIFT_ATOL, (got, want)
    else:
        assert got == want


def test_drift_report_agrees():
    for kw in ({}, {"season": 4}, {"min_points": 4, "alpha": 0.2}):
        want = jdrift.drift_report(jtsdb.SeriesStore(_drift_samples()),
                                   ["queue_depth", "calm", "wave"], **kw)
        got = tdrift.drift_report(ttsdb.SeriesStore(_drift_samples()),
                                  ["queue_depth", "calm", "wave"], **kw)
        _close(got, want)
    assert got[0]["series"] == "queue_depth" and got[0]["drifting"]


def test_detector_scores_and_watch_gauges_agree():
    values = [0.0, 10.0, 0.0, 10.0] * 8 + [10.0, 55.0, -3.0]
    for kw in ({"min_points": 4}, {"min_points": 4, "season": 4}):
        dets = [m.DriftDetector(**kw) for m in (jdrift, tdrift)]
        _close([dets[1].observe(v) for v in values],
               [dets[0].observe(v) for v in values])
    gauges = []
    for name, (tsdb, _s, drift, reg_cls) in PKGS.items():
        reg = reg_cls()
        watch = drift.DriftWatch(["queue_depth", "wave"], registry=reg)
        watch.observe_store(tsdb.SeriesStore(_drift_samples()))
        gauges.append(reg.snapshot()["gauges"])
    _close(gauges[1], gauges[0])


def test_model_hook_and_the_watchdog_hook():
    from analytics_zoo_torch.observability.watchdog import (
        TrainingWatchdog, set_active_watchdog)
    store = ttsdb.SeriesStore([{"t": float(t), "counters": {},
                                "gauges": {"g": float(t % 3)}}
                               for t in range(20)])
    assert tdrift.DriftWatch(
        ["g"], model_hook=lambda key, recent: 7.5).observe_store(
            store)["g"] == 7.5
    reg = MetricsRegistry()
    wd = TrainingWatchdog(policy="warn", registry=reg)
    prev = set_active_watchdog(wd)
    try:
        tdrift.DriftWatch(["queue_depth"]).observe_store(
            ttsdb.SeriesStore(_drift_samples()))
    finally:
        set_active_watchdog(prev)
    assert reg.snapshot()["counters"][
        'watchdog_events_total{kind="drift"}'] == 1.0


# ---------------------------------------------------- stdlib-only modules
@pytest.mark.parametrize("module", ["tsdb", "slo", "drift", "incident",
                                    "aggregator"])
def test_stdlib_only_at_module_level(module):
    code = (f"import sys\n"
            f"import analytics_zoo_torch.observability.{module}\n"
            f"bad = sorted(m for m in ('torch', 'numpy', 'jax') "
            f"if m in sys.modules)\n"
            f"print('LOADED', bad)\n"
            f"sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
