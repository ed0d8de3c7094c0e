"""PyTorch port, the serving fleet: ``serving/supervisor.py`` (spawn,
restart under the budget, degrade, drain, the autoscaler),
``serving/loadgen/`` (scenarios, the open-loop generator, the verdict
and the capacity report) and ``serving/quick_start.py``, on the CPU.

- The autoscaler's mechanics under a fake clock with stub replicas (the
  reference's ``tests/test_serving_autoscaler.py``): sustained pressure
  scales up to the ceiling and idle drains to the floor one retirement
  at a time, each retired stub exiting 0; one noisy poll never scales;
  an ``error_rate`` 503 holds scale-up; a blind fleet never scales;
  equal bounds turn autoscaling off; a budget exhausted mid scale-up
  ends the fleet structured.  The supervisor of stub replicas never
  initialises CUDA (``torch.cuda`` refuses its lazy init in that child).
- The scenario schedules are the reference's for the same seed (same
  offsets, kinds, endpoints and phases); the payloads are the same
  bytes; the verdict and the capacity
  report of one ``LoadgenRun`` are the same in both packages, and each
  package reads the other's JSONL log and report.
- One real fleet storm, as ``tests/test_loadgen_fleet.py`` runs it: a
  2→4-replica supervised fleet of the port's ``ClusterServing`` over a
  numpy stand-in model (inline ``python -c`` children) on a TCP
  ``BrokerServer``, stormed by ``flash_burst_with_outage`` with a real
  broker outage and a pinned poison record, passes the verdict; the
  same storm's shape against a fleet with the breaker disabled fails it
  on exactly-once.
- ``quick_start.main(["--smoke"])`` on the CPU."""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

from analytics_zoo_tpu.serving import loadgen as jlg
from analytics_zoo_tpu.serving.loadgen import verdict as jverdict

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.observability import get_registry
from analytics_zoo_torch.resilience.policy import DegradedTraining
from analytics_zoo_torch.serving import loadgen as tlg
from analytics_zoo_torch.serving.loadgen import verdict as tverdict
from analytics_zoo_torch.serving.redis_client import BrokerServer, connect
from analytics_zoo_torch.serving.supervisor import ServingSupervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_cpu():
    from analytics_zoo_torch.resilience.chaos import clear_chaos
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    clear_chaos()
    yield
    clear_chaos()
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _child_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return env


# ------------------------------------------------- autoscaler mechanics
_DRAIN_STUB = ("import os, signal, sys, time\n"
               "signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))\n"
               "rf = os.environ.get('STUB_READY_FILE')\n"
               "if rf:\n"
               "    open(rf, 'w').write('1')\n"
               "time.sleep(120)\n")


def _stub_factory(ready_dir):
    def factory(index, incarnation):
        return [sys.executable, "-c", _DRAIN_STUB], {
            "STUB_READY_FILE": os.path.join(
                ready_dir, f"ready-{index}-{incarnation}")}
    return factory


def _stubs_ready(sup):
    for r in sup._replicas:
        if r.proc is None or r.proc.poll() is not None or r.retiring:
            continue
        if not os.path.exists(os.path.join(
                sup._stub_ready_dir, f"ready-{r.index}-{r.incarnation - 1}")):
            return False
    return True


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _scripted(signals, clock, **kw):
    """A supervisor whose signals are a script the test flips; the test
    drives ``_tick()`` under a fake clock."""
    defaults = dict(
        replicas=1, min_replicas=1, max_replicas=3,
        scale_up_queue_depth=10, scale_up_sustain_s=0.2,
        scale_down_idle_s=0.2, scale_cooldown_s=0.1,
        autoscale_interval_s=0.02, health_interval_s=3600.0,
        startup_grace_s=3600.0, backoff_base_s=0.05, drain_timeout_s=10.0)
    defaults.update(kw)
    ready_dir = tempfile.mkdtemp(prefix="zoo-stub-ready-")
    sup = ServingSupervisor(_stub_factory(ready_dir), clock=clock,
                            **defaults)
    sup._stub_ready_dir = ready_dir
    sup._collect_signals = lambda: dict(signals)
    sup._error_rate_hold = lambda: bool(signals.get("error_rate_hold"))
    sup._scale_down_allowed = lambda: bool(
        signals.get("scale_down_allowed", True))
    for r in sup._replicas:
        sup._spawn(r)
    return sup


def _tick_until(sup, clock, cond, dt=0.05, max_ticks=200, settle_s=0.0):
    for _ in range(max_ticks):
        if cond():
            return True
        sup._tick()
        clock.advance(dt)
        if settle_s:
            time.sleep(settle_s)
    return cond()


def _wait_for(cond, timeout_s=20.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def test_scales_up_on_sustained_pressure_and_down_on_idle():
    clock = FakeClock()
    signals = {"queue": 100.0, "fill": 1.0, "p50_ms": 0.0,
               "saw_metrics": True}
    sup = _scripted(signals, clock)
    try:
        assert _tick_until(sup, clock, lambda: sup._fleet_size() == 3)
        for _ in range(20):           # the ceiling holds
            sup._tick()
            clock.advance(0.05)
        assert sup._fleet_size() == 3 and len(sup._replicas) == 3
        assert _wait_for(lambda: _stubs_ready(sup))
        signals.update(queue=0.0, fill=0.0)
        assert _tick_until(sup, clock, lambda: sup._fleet_size() == 1)
        assert _tick_until(
            sup, clock, lambda: sum(r.done for r in sup._replicas) == 2,
            settle_s=0.02)
        retired = [r for r in sup._replicas if r.done]
        assert [r.last_exit for r in retired] == [0, 0]
        assert sup.restarts_total == 0
        assert [s for _t, s, _r in sup.replica_trajectory] == \
            [1, 2, 3, 2, 1]
        assert get_registry().gauge("serving_fleet_replicas", "").value == 1
        assert [e["direction"] for e in sup.scale_events] == \
            ["up", "up", "down", "down"]
    finally:
        sup.drain_fleet()


def test_noise_error_rate_and_blindness_never_scale():
    clock = FakeClock()
    signals = {"queue": 0.0, "fill": 0.0, "p50_ms": 0.0,
               "saw_metrics": True}
    sup = _scripted(signals, clock, scale_up_sustain_s=5.0,
                    scale_down_idle_s=3600.0)
    try:
        signals["queue"] = 100.0      # one spike, then calm
        sup._tick()
        clock.advance(0.05)
        signals["queue"] = 0.0
        for _ in range(40):
            sup._tick()
            clock.advance(0.5)
        assert sup._fleet_size() == 1 and sup.scale_events == []
    finally:
        sup.drain_fleet()
    clock = FakeClock()
    signals = {"queue": 100.0, "fill": 1.0, "p50_ms": 0.0,
               "saw_metrics": True, "error_rate_hold": True}
    sup = _scripted(signals, clock)
    try:
        for _ in range(30):
            sup._tick()
            clock.advance(0.1)
        assert sup._fleet_size() == 1     # held by the 503 error_rate
        signals["error_rate_hold"] = False
        assert _tick_until(sup, clock, lambda: sup._fleet_size() >= 2)
        signals.update(saw_metrics=False, queue=0.0)
        n = sup._fleet_size()
        for _ in range(30):               # blind: no decision
            sup._tick()
            clock.advance(0.1)
        assert sup._fleet_size() == n
    finally:
        sup.drain_fleet()
    assert ServingSupervisor(_stub_factory("/tmp"),
                             replicas=2).autoscale is False
    with pytest.raises(ValueError):
        ServingSupervisor(_stub_factory("/tmp"), min_replicas=3,
                          max_replicas=1)


def test_degrade_mid_scale_up_stays_structured(tmp_path):
    clock = FakeClock()
    signals = {"queue": 50.0, "fill": 1.0, "p50_ms": 0.0,
               "saw_metrics": True}
    sup = _scripted(signals, clock, max_replicas=2, retry_times=1,
                    retry_window_s=60.0, run_dir=str(tmp_path))
    try:
        assert _tick_until(sup, clock, lambda: sup._fleet_size() == 2,
                           settle_s=0.01)
        grown = sup._replicas[1]
        grown.proc.kill()
        grown.proc.wait()
        assert _tick_until(sup, clock, lambda: grown.proc is not None
                           and grown.proc.poll() is None, settle_s=0.01)
        assert sup.restarts_total == 1
        grown.proc.kill()
        grown.proc.wait()
        with pytest.raises(DegradedTraining) as ei:
            _tick_until(sup, clock, lambda: False, max_ticks=50,
                        settle_s=0.01)
        rec = ei.value.result
        assert rec["replica"] == 1 and rec["status"] == "degraded"
        assert sup.summary()["degraded"] == [1]
        assert sup._fleet_size() == 1
        on_disk = json.load(open(tmp_path / "degraded.json"))
        assert on_disk == rec
        persisted = json.load(open(tmp_path / "supervisor.json"))
        assert [e["direction"] for e in persisted["scale_events"]] == ["up"]
    finally:
        sup.drain_fleet()


_NO_CUDA_CHILD = r"""
import os, sys, tempfile, torch
calls = []
def refuse(*a, **k):
    calls.append(1)
    raise RuntimeError("the supervisor initialised CUDA")
torch.cuda._lazy_init = refuse
torch.cuda.init = refuse
from analytics_zoo_torch.serving.supervisor import ServingSupervisor
stub = "import signal, sys, time\n" \
       "signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))\n" \
       "time.sleep(60)\n"
run_dir = tempfile.mkdtemp()
sup = ServingSupervisor(lambda i, n: ([sys.executable, "-c", stub], {}),
                        replicas=1, min_replicas=1, max_replicas=2,
                        health_interval_s=0.05, startup_grace_s=60.0,
                        autoscale_interval_s=0.05, run_dir=run_dir)
t = sup.run_background()
import time; time.sleep(1.5)
sup.stop()
t.join(30)
assert not t.is_alive()
assert not calls and not torch.cuda.is_initialized()
print("CODES", sup.summary()["exit_codes"])
"""


def test_the_supervisor_opens_no_cuda_context():
    proc = subprocess.run([sys.executable, "-c", _NO_CUDA_CHILD],
                          capture_output=True, text=True, timeout=120,
                          env=_child_env())
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "CODES {0: 0}" in proc.stdout


# ------------------------------------------------------------ scenarios
SCENARIO_ARGS = {
    "diurnal": dict(base_rate=5.0, peak_rate=20.0, period_s=12.0),
    "flash_burst_with_outage": dict(base_rate=20.0, burst_mult=10.0,
                                    burst_s=20.0, poison=0),
    "poison_flood_drain": {},
}


@pytest.mark.parametrize("name", sorted(SCENARIO_ARGS))
@pytest.mark.parametrize("seed", [0, 7])
def test_schedules_are_the_references(name, seed):
    kw = dict(SCENARIO_ARGS[name], seed=seed)
    js, ts = jlg.SCENARIOS[name](**kw), tlg.SCENARIOS[name](**kw)
    for compress in (1.0, 0.5):
        jsched, tsched = js.schedule(compress), ts.schedule(compress)
        key = lambda r: (r.offset_s, r.kind, r.endpoint,  # noqa: E731
                         r.transport, r.max_tokens, r.phase)
        assert [key(r) for r in tsched] == [key(r) for r in jsched]
        assert ts.duration_s(compress) == js.duration_s(compress)
    assert [(e.at_s, e.kind, e.duration_s) for e in ts.events] == \
        [(e.at_s, e.kind, e.duration_s) for e in js.events]
    assert ts.slo.to_dict() == js.slo.to_dict()
    for ph in ts.phases:
        assert ts.phase_window(ph.name) == js.phase_window(ph.name)


@pytest.mark.parametrize("kind,transport", [
    ("ok", "redis"), ("poison", "redis"), ("malformed", "redis"),
    ("ok", "http"), ("ok", "generate")])
def test_payloads_are_the_references(kind, transport):
    tp = tlg.PayloadFactory(shape=(8,), seed=3)
    jp = jlg.PayloadFactory(shape=(8,), seed=3)
    for i in range(3):
        rid = f"{i:032x}"
        spec = tlg.ScheduledRequest(offset_s=0.0, kind=kind,
                                    transport=transport, request_id=rid)
        jspec = jlg.ScheduledRequest(offset_s=0.0, kind=kind,
                                     transport=transport, request_id=rid)
        if kind != "malformed":
            np.testing.assert_array_equal(tp.array(spec), jp.array(jspec))
        tf, jf = tp.redis_fields(spec), jp.redis_fields(jspec)
        # the trace context carries a fresh span id in each call
        tf.pop("trace"), jf.pop("trace")
        assert tf == jf
        if transport == "http":
            assert tp.http_body(spec) == jp.http_body(jspec)


# -------------------------------------------------------------- verdict
def _mk_run(lg, rows, started=100.0):
    records = []
    for i, (off, kind, status, lat) in enumerate(rows):
        spec = lg.ScheduledRequest(offset_s=off, kind=kind,
                                   request_id=f"{i:032x}")
        rec = lg.RequestRecord(spec=spec, scheduled=started + off,
                               status=status)
        if lat is not None:
            rec.sent = started + off
            rec.done = started + off + lat
        records.append(rec)
    return lg.LoadgenRun(records, started, 1000.0, started + 60.0)


ROWS = ([(i * 0.2, "ok", "ok", 0.05) for i in range(10)]
        + [(2.0 + i * 0.05, "ok", "ok", 0.05 + 0.001 * i)
           for i in range(40)]
        + [(4.0, "ok", "shed", 0.3), (4.1, "ok", "lost", None),
           (4.2, "poison", "quarantined", 0.5),
           (4.3, "malformed", "error", 0.05)])


def _verdict_doc(lg, verdict):
    run = _mk_run(lg, ROWS)
    wall0 = run.started_wall
    fleet = {"trajectory": [(wall0, 2, "initial"),
                            (wall0 + 2.5, 3, "scale_up"),
                            (wall0 + 8.0, 2, "scale_down")],
             "restarts_total": 1}
    dl = [{"reason": "shed", "request_id": "x", "cause": "deadline",
           "age_ms": "250", "deadline_ms": "200"},
          {"reason": "poison", "request_id": "p", "deliveries": "2"}]
    v = verdict.evaluate(run, verdict.SloSpec(scale_up_lag_s=3.0,
                                              poison_max_attempts=2),
                         fleet=fleet, dead_letters=dl, pending=0,
                         burst_start_offset_s=2.0)
    cap = verdict.capacity_report(run, target_p99_ms=200.0,
                                  trajectory=fleet["trajectory"],
                                  windows=4)
    doc = verdict.report_document("probe", v, slo=verdict.SloSpec(),
                                  extra={"capacity_windows_4": cap})
    # the rest is each process's own registry snapshot
    doc.pop("metrics")
    return run, v, doc


def test_verdict_and_capacity_report_are_the_references():
    _, jv, jdoc = _verdict_doc(jlg, jverdict)
    _, tv, tdoc = _verdict_doc(tlg, tverdict)
    assert json.dumps(tdoc, sort_keys=True) == \
        json.dumps(jdoc, sort_keys=True)
    assert tv.render() == jv.render()
    assert not tv.check("exactly_once").passed      # the lost request
    assert tv.check("scale_up_lag").passed


def test_each_package_reads_the_others_artifacts(tmp_path):
    for writer, reader in ((tlg, jlg), (jlg, tlg)):
        run = _mk_run(writer, ROWS)
        path = str(tmp_path / f"{writer.__name__}.jsonl")
        run.to_jsonl(path)
        lines = [json.loads(x) for x in open(path).read().splitlines()]
        # the log reads back into the other package's records
        rebuilt = _mk_run(reader, ROWS)
        assert [r.to_dict() for r in rebuilt.records] == lines[1:]
    # the report JSON of one package is the other's, byte for byte
    docs = []
    for lg, verdict in ((jlg, jverdict), (tlg, tverdict)):
        _, _, doc = _verdict_doc(lg, verdict)
        out = str(tmp_path / f"report-{lg.__name__}.json")
        verdict.write_report(out, doc)
        docs.append(open(out).read())
    assert docs[1] == docs[0]


# ---------------------------------------------------- the fleet storm
_REPLICA = r"""
import argparse, os, signal, sys, time
signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
import numpy as np
p = argparse.ArgumentParser()
p.add_argument("--redis-url", required=True)
p.add_argument("--consumer-name", required=True)
p.add_argument("--predict-delay", type=float, default=0.0)
p.add_argument("--breaker-failures", type=int, default=None)
args = p.parse_args()


class PoisonSensitiveModel:
    # a numpy stand-in whose predict DIES on the poison payload
    def predict(self, x, batch_size=None):
        x = np.asarray(x, dtype=np.float32)
        if np.any(np.abs(x) > 1e8):
            os._exit(11)
        if args.predict_delay > 0:
            time.sleep(args.predict_delay)
        return np.tile(np.arange(4, dtype=np.float32), (len(x), 1))


from analytics_zoo_torch import init_zoo_context
init_zoo_context(device="cpu")
from analytics_zoo_torch.serving.server import ClusterServing, ServingConfig
cfg = ServingConfig(redis_url=args.redis_url, batch_size=4,
                    consumer_group="serve",
                    consumer_name=args.consumer_name,
                    poison_max_attempts=2, reclaim_min_idle_ms=4000,
                    breaker_failures=args.breaker_failures,
                    breaker_cooldown_s=0.3, metrics_port=0,
                    metrics_host="127.0.0.1")
serving = ClusterServing(PoisonSensitiveModel(), cfg)
serving.install_signal_handlers()
serving.run(poll_ms=50)
"""


def _factory(url, predict_delay=0.15, breaker_failures=None):
    def factory(index, incarnation):
        cmd = [sys.executable, "-c", _REPLICA, "--redis-url", url,
               "--consumer-name", f"replica-{index}",
               "--predict-delay", str(predict_delay)]
        if breaker_failures is not None:
            cmd += ["--breaker-failures", str(breaker_failures)]
        return cmd, {"PYTHONPATH": REPO}
    return factory


class _OutageHook:
    """A real broker outage: the TCP listener stops and comes back on
    the same port over the same state."""

    def __init__(self, srv):
        self.srv, self.port, self.windows = srv, srv.port, []

    def __call__(self, event, edge):
        if edge == "start":
            self.windows.append(time.monotonic())
            self.srv.stop()
        else:
            self.srv = BrokerServer(broker=self.srv.broker,
                                    host="127.0.0.1", port=self.port)


def _settle_pel(broker, timeout_s=25.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if tlg.pending_count(broker, group="serve") == 0:
            return 0
        time.sleep(0.2)
    return tlg.pending_count(broker, group="serve")


def test_the_storm_passes_a_correct_fleet(tmp_path):
    srv = BrokerServer()
    outage = _OutageHook(srv)
    sup = t = None
    try:
        sup = ServingSupervisor(
            _factory(srv.url), replicas=2, min_replicas=2, max_replicas=4,
            scale_up_queue_depth=10, scale_up_sustain_s=0.5,
            scale_down_idle_s=6.0, scale_cooldown_s=1.0,
            autoscale_interval_s=0.2, health_interval_s=0.5,
            retry_times=8, retry_window_s=120.0, backoff_base_s=0.2,
            backoff_max_s=1.0, run_dir=str(tmp_path), drain_timeout_s=30.0)
        t = sup.run_background()
        assert sup.wait_ready(timeout_s=60.0)
        scenario = tlg.SCENARIOS["flash_burst_with_outage"](
            base_rate=6.0, burst_mult=10.0, warmup_s=2.5, burst_s=4.0,
            drain_s=4.0, outage_after_s=1.2, outage_s=1.0, poison=1,
            slo=tlg.SloSpec(p99_from_scheduled_ms=20000.0,
                            scale_up_lag_s=8.0, poison_max_attempts=2))
        run = tlg.run_scenario(
            scenario, compress=1.0, hooks={"broker_outage": outage},
            broker_factory=lambda: connect(f"127.0.0.1:{outage.port}"),
            result_timeout_s=45.0, send_retry_s=8.0)
        pending = _settle_pel(srv.broker)
        burst_start, _ = scenario.phase_window("burst")
        verdict = tlg.evaluate(
            run, scenario.slo, fleet=tlg.fleet_snapshot(sup),
            dead_letters=tlg.read_dead_letters(srv.broker),
            pending=pending, burst_start_offset_s=burst_start)
        assert verdict.passed, "\n" + verdict.render()
        for name in ("exactly_once", "scale_up_lag", "quarantine_exact"):
            assert not verdict.check(name).skipped, name
        poisons = tlg.read_dead_letters(srv.broker, reason="poison")
        assert len(poisons) == 1 and poisons[0]["deliveries"] == "2"
        assert sup.restarts_total >= 1
        assert len(outage.windows) == 1
        assert max(s for _t, s, _r in sup.replica_trajectory) >= 3
        cap = verdict.capacity
        assert cap and cap["rps_per_replica_at_slo"] is not None
        # the JAX package's verdict over the same log and broker agrees
        import dataclasses
        jrun = jlg.LoadgenRun(
            [jlg.RequestRecord(
                spec=jlg.ScheduledRequest(**dataclasses.asdict(r.spec)),
                **{k: getattr(r, k) for k in
                   ("scheduled", "sent", "first_byte", "done", "status",
                    "error", "tokens")})
             for r in run.records],
            run.started_monotonic, run.started_wall,
            run.finished_monotonic)
        jv = jlg.evaluate(
            jrun, jverdict.SloSpec(**scenario.slo.to_dict()),
            fleet=tlg.fleet_snapshot(sup),
            dead_letters=tlg.read_dead_letters(srv.broker),
            pending=pending, burst_start_offset_s=burst_start)
        assert jv.render() == verdict.render()
    finally:
        if sup is not None:
            sup.stop()
        if t is not None:
            t.join(timeout=60)
            assert not t.is_alive()
        outage.srv.stop()
    codes = sup.summary()["exit_codes"]
    assert all(c == 0 for c in codes.values() if c is not None), codes


def test_the_storm_fails_a_fleet_without_breakers(tmp_path):
    srv = BrokerServer()
    outage = _OutageHook(srv)
    sup = t = None
    try:
        sup = ServingSupervisor(
            _factory(srv.url, predict_delay=0.02, breaker_failures=0),
            replicas=2, health_interval_s=0.5, retry_times=3,
            retry_window_s=60.0, backoff_base_s=0.2, backoff_max_s=1.0,
            run_dir=str(tmp_path), drain_timeout_s=15.0)
        t = sup.run_background()
        assert sup.wait_ready(timeout_s=60.0)
        scenario = tlg.Scenario(
            "broken_fleet_probe",
            phases=[tlg.Phase("warmup", 1.5, 8.0, heavy_tail=0.0),
                    tlg.Phase("post_outage", 2.5, 8.0, heavy_tail=0.0)],
            events=[tlg.ScenarioEvent(at_s=1.5, kind="broker_outage",
                                      duration_s=0.8)],
            slo=tlg.SloSpec(p99_from_scheduled_ms=20000.0))
        run = tlg.run_scenario(
            scenario, compress=1.0, hooks={"broker_outage": outage},
            broker_factory=lambda: connect(f"127.0.0.1:{outage.port}"),
            result_timeout_s=8.0, send_retry_s=5.0)
        verdict = tlg.evaluate(
            run, scenario.slo,
            dead_letters=tlg.read_dead_letters(srv.broker),
            pending=tlg.pending_count(srv.broker, group="serve"))
        assert not verdict.passed
        assert not verdict.check("exactly_once").passed
        counts = run.counts()
        assert counts.get("ok", 0) > 0 and counts.get("lost", 0) > 0
    finally:
        if sup is not None:
            sup.stop()
        if t is not None:
            t.join(timeout=40)
            assert not t.is_alive()
        outage.srv.stop()


# ----------------------------------------------------------- quick start
def test_quick_start_smoke_on_the_cpu():
    from analytics_zoo_torch.serving import quick_start
    result = quick_start.main(["--smoke"])
    assert isinstance(result, list) and len(result) == 3
    assert tctx.get_zoo_context().device.type == "cpu"
