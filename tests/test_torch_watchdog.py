"""PyTorch port, the training-health watchdog (``observability/watchdog.py``)
against the JAX package's, on the CPU: the reference's own cases
(``tests/test_diagnostics.py``'s ``TestWatchdog`` and
``TestEstimatorWatchdog``) on both packages, side by side.

- The detectors (plateau, its re-arming, divergence, stall on a fake
  clock, the non-finite flag, the policy check) raise the same issues
  and the same counters in both packages.
- ``checkpoint_and_halt`` through the ``Estimator``: the halt snapshot
  lands in ``<model_dir>/halt/``, loads into a fresh ``Estimator`` that
  resumes under ``warn``.  The halt iteration, on data with one NaN
  target row (so the poisoned step is not the first): the port's is the
  first sync point at or after the poisoned step, the health check that
  follows it (on the CPU a step's flag is ready when the step returns).
  The reference's varies from run to run: its flag arrives through an
  asynchronous host callback, and it halted one step later inside this
  test process (iteration 6 for the poisoned step 4) than in a fresh
  interpreter (5, in each of four runs).  So the reference is held to
  the window from that health check to the epoch's end, where its loop
  reads the loss.
- ``warn`` keeps training; ``LocalEstimator`` halts.
- The finite flag through a CAPTURED step: the step program runs under
  the engine's stand-in graph backend (``test_torch_compile_engine``),
  the flag is an output of its replays, and it reaches the watchdog
  with no host read inside the step."""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import config as jconfig
from analytics_zoo_tpu.common.triggers import MaxIteration as JMaxIteration
from analytics_zoo_tpu.feature.feature_set import FeatureSet as JFeatureSet
from analytics_zoo_tpu.observability import watchdog as jwd
from analytics_zoo_tpu.observability.metrics import (
    MetricsRegistry as JRegistry)
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from analytics_zoo_tpu.pipeline.estimator import (
    Estimator as JEstimator, LocalEstimator as JLocalEstimator)

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.common.triggers import MaxIteration
from analytics_zoo_torch.compile import engine as eng
from analytics_zoo_torch.feature import FeatureSet
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.observability import get_registry
from analytics_zoo_torch.observability import watchdog as twd
from analytics_zoo_torch.observability.metrics import MetricsRegistry
from analytics_zoo_torch.parallel.trainer import DistributedTrainer
from analytics_zoo_torch.pipeline.api.keras import Sequential, objectives
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.api.keras.layers import Dense
from analytics_zoo_torch.pipeline.api.keras.optimizers import SGD
from analytics_zoo_torch.pipeline.estimator import (
    Estimator, LocalEstimator)

from test_torch_compile_engine import StandInGraphs

PACKAGES = {"jax": (jwd, JRegistry), "torch": (twd, MetricsRegistry)}


@pytest.fixture(autouse=True)
def _port_cpu():
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    yield
    tctx.reset_zoo_context()
    tconfig.reset_config()
    jconfig.reset_config()


def _counters(reg):
    return {k: v for k, v in reg.snapshot()["counters"].items()
            if k.startswith(("watchdog_events_total",
                             "train_nonfinite_total"))}


def _both(drive):
    """Run ``drive(module, registry)`` on each package's watchdog; the
    issues it returns and the counters it leaves must be the same."""
    out = {}
    for name, (mod, reg_cls) in PACKAGES.items():
        reg = reg_cls()
        out[name] = (drive(mod, reg), _counters(reg),
                     reg.snapshot()["gauges"].get("train_health_status"))
    assert out["torch"] == out["jax"]
    return out["torch"]


# ---------------------------------------------------------- the detectors
def test_plateau_detected_over_sliding_window():
    def drive(mod, reg):
        wd = mod.TrainingWatchdog(policy="warn", window=4, min_delta=1e-3,
                                  stall_timeout_s=0, registry=reg)
        wd.observe_loss(1.0)
        wd.observe_loss(0.5)
        for _ in range(4):
            wd.observe_loss(0.5)
        return wd.poll()
    issue, counters, _ = _both(drive)
    assert issue is None
    assert counters['watchdog_events_total{kind="plateau"}'] == 1.0


def test_plateau_rearms_once_per_window():
    def drive(mod, reg):
        wd = mod.TrainingWatchdog(policy="warn", window=3, min_delta=1e-3,
                                  registry=reg)
        wd.observe_loss(1.0)
        for _ in range(7):
            wd.observe_loss(1.0)
        return wd.poll()
    _, counters, _ = _both(drive)
    assert counters['watchdog_events_total{kind="plateau"}'] == 2.0


def test_divergence_fires_and_halts_under_policy():
    def drive(mod, reg):
        wd = mod.TrainingWatchdog(policy="checkpoint_and_halt", window=50,
                                  divergence=5.0, registry=reg)
        wd.observe_loss(1.0)
        wd.observe_loss(100.0)
        return wd.poll(), wd.halted()
    (issue, halted), _, status = _both(drive)
    assert issue["kind"] == "divergence" and halted and status == 2.0


def test_stall_flagged_with_fake_clock():
    def drive(mod, reg):
        t = [0.0]
        wd = mod.TrainingWatchdog(policy="warn", stall_timeout_s=30.0,
                                  clock=lambda: t[0], registry=reg)
        wd.beat()
        seen = []
        for now in (20.0, 55.0, 56.0):
            t[0] = now
            seen.append(wd.check_stall())
        wd.beat()
        t[0] = 100.0
        seen.append(wd.check_stall())
        return seen
    seen, counters, status = _both(drive)
    assert seen == [False, True, False, True]
    assert counters['watchdog_events_total{kind="stall"}'] == 2.0
    assert status >= 1


def test_nonfinite_flag_routes_to_active_watchdog():
    def drive(mod, reg):
        wd = mod.TrainingWatchdog(policy="checkpoint_and_halt",
                                  registry=reg)
        prev = mod.set_active_watchdog(wd)
        try:
            mod.record_step_finiteness(np.bool_(True))
            first = wd.poll()
            mod.record_step_finiteness(np.bool_(False))
            return first, wd.poll()
        finally:
            mod.set_active_watchdog(prev)
    (first, issue), counters, _ = _both(drive)
    assert first is None and issue["kind"] == "nonfinite"
    assert counters['train_nonfinite_total{source="step"}'] == 1.0


def test_drift_is_advisory_and_once_per_episode():
    def drive(mod, reg):
        wd = mod.TrainingWatchdog(policy="checkpoint_and_halt",
                                  registry=reg)
        for score in (0.5, 1.5, 2.0, 0.2, 1.1):
            wd.observe_drift("serving_queue_depth", score)
        return wd.poll()
    issue, counters, _ = _both(drive)
    assert issue is None       # drift never halts
    assert counters['watchdog_events_total{kind="drift"}'] == 2.0


def test_bad_policy_rejected():
    for mod, reg_cls in PACKAGES.values():
        with pytest.raises(ValueError, match="policy"):
            mod.TrainingWatchdog(policy="explode", registry=reg_cls())


def test_the_fold_is_the_references_flag():
    """``fold_finiteness_check`` is ``isfinite(loss + Σ sum(g))``: NaN and
    Inf anywhere in the loss or a gradient leaf clear it."""
    g = {"a": {"W": torch.ones(3, 2)}, "b": {"b": torch.zeros(4)}}
    assert bool(twd.fold_finiteness_check(torch.tensor(0.5), g))
    for bad in (float("nan"), float("inf"), -float("inf")):
        assert not bool(twd.fold_finiteness_check(torch.tensor(bad), g))
        g2 = {"a": {"W": torch.ones(3, 2)},
              "b": {"b": torch.tensor([0.0, bad, 0.0, 0.0])}}
        assert not bool(twd.fold_finiteness_check(torch.tensor(0.5), g2))


def test_step_flags_deliver_in_order_without_a_watchdog():
    reg = get_registry()
    key = 'train_nonfinite_total{source="step"}'
    before = reg.snapshot()["counters"].get(key, 0.0)
    flags = twd.StepFlags()
    for ok in (True, False, True, False):
        flags.push(torch.tensor(ok))
    flags.push(None)          # the check is off: nothing queued
    assert len(flags) == 0    # CPU flags are ready at once
    assert reg.snapshot()["counters"][key] == before + 2.0


# ------------------------------------------------- estimator integration
def _toy_models():
    JLayer.reset_name_counters()
    jm = JSequential()
    jm.add(JDense(1, input_shape=(8,)))
    jm.compile(optimizer="sgd", loss="mse")
    TLayer.reset_name_counters()
    tm = Sequential()
    tm.add(Dense(1, input_shape=(8,)))
    tm.compile(optimizer="sgd", loss="mse")
    import jax
    load_jax_variables(tm, jax.tree_util.tree_map(
        np.asarray, jm.get_variables()))
    return jm, tm


def _toy_data(n=512, nan_rows=()):
    rs = np.random.RandomState(0)
    x = rs.randn(n, 8).astype(np.float32)
    y = rs.randn(n, 1).astype(np.float32)
    y[list(nan_rows)] = np.nan
    return x, y


def _poisoned_step(x, y, batch_size):
    """The first step (0-based) whose shuffled batch holds a NaN."""
    for k, (_, by) in enumerate(FeatureSet.from_ndarrays(x, y)
                                .epoch_batches(0, batch_size, train=True)):
        if np.isnan(by).any():
            return k
    raise AssertionError("no poisoned batch")


def _set_policy(policy):
    jconfig.get_config().set("observability.watchdog_policy", policy)
    tconfig.get_config().set("observability.watchdog_policy", policy)


def test_checkpoint_and_halt_at_the_references_iteration(tmp_path):
    _set_policy("checkpoint_and_halt")
    x, y = _toy_data(nan_rows=[300])
    poisoned = _poisoned_step(x, y, 64)
    assert poisoned >= 2           # a step the loop has to reach
    halts = {}
    for name in ("jax", "torch"):
        jm, tm = _toy_models()
        d = tmp_path / name
        if name == "jax":
            est = JEstimator(jm, optim_method=jm.optim_method,
                             model_dir=str(d))
            err, fs, trig = jwd.TrainingHalted, JFeatureSet, JMaxIteration
        else:
            est = Estimator(tm, optim_method=tm.optim_method,
                            model_dir=str(d))
            err, fs, trig = twd.TrainingHalted, FeatureSet, MaxIteration
        with pytest.raises(err) as e:
            est.train(fs.from_ndarrays(x, y), "mse",
                      end_trigger=trig(200), batch_size=64)
        assert e.value.issue["kind"] == "nonfinite"
        halts[name] = est.train_state.iteration
        snaps = sorted(p.name for p in (d / "halt").iterdir())
        assert snaps == [f"snapshot.{halts[name]}.ckpt"]
        # never into model_dir itself
        assert not any(p.name.startswith("snapshot.") for p in d.iterdir())
    # the port: the health check right after the poisoned step; the
    # reference: its callback lands there or later, within the epoch
    assert halts["torch"] == poisoned + 1
    assert poisoned + 1 <= halts["jax"] <= 512 // 64
    snap = get_registry().snapshot()
    assert snap["counters"]['train_nonfinite_total{source="step"}'] >= 1
    assert snap["gauges"]["train_health_status"] == 2.0

    # the halt snapshot loads: a fresh Estimator on the halt directory
    # resumes from it under warn and trains on
    _set_policy("warn")
    before = get_registry().counter("checkpoint_restore_total", "").value
    _, tm2 = _toy_models()
    est2 = Estimator(tm2, optim_method=SGD(0.01),
                     model_dir=str(tmp_path / "torch" / "halt"))
    x2, y2 = _toy_data()
    est2.train(FeatureSet.from_ndarrays(x2, y2), "mse",
               end_trigger=MaxIteration(halts["torch"] + 8),
               batch_size=64)
    assert get_registry().counter("checkpoint_restore_total",
                                  "").value == before + 1
    assert est2.train_state.iteration == halts["torch"] + 8


def test_nan_with_warn_policy_keeps_training():
    x, y = _toy_data(n=256, nan_rows=range(64))
    _, tm = _toy_models()
    est = Estimator(tm, optim_method=tm.optim_method)
    est.train(FeatureSet.from_ndarrays(x, y), "mse",
              end_trigger=MaxIteration(25), batch_size=64)
    assert est.train_state.iteration == 25
    snap = get_registry().snapshot()
    assert snap["counters"]['train_nonfinite_total{source="step"}'] > 0


def test_local_estimator_halts_on_nan_where_the_reference_does():
    _set_policy("checkpoint_and_halt")
    x, y = _toy_data(n=256, nan_rows=[200])
    poisoned = _poisoned_step(x, y, 64)
    jm, tm = _toy_models()
    msgs = []
    for le, err in ((JLocalEstimator(jm, "mse", jm.optim_method),
                     jwd.TrainingHalted),
                    (LocalEstimator(tm, "mse", tm.optim_method),
                     twd.TrainingHalted)):
        with pytest.raises(err) as e:
            le.fit(x, y, batch_size=64, epochs=8)
        msgs.append(str(e.value).split(":")[0])
    assert msgs[0] == msgs[1] == \
        f"local training halted by watchdog at step {poisoned + 1}"
    # the model keeps its last synced variables: the initial ones here
    w0 = tm.get_variables()["params"][tm.layers[0].name]
    assert all(torch.isfinite(v).all() for v in w0.values())


# ---------------------------------------------- the flag through a graph
@pytest.fixture
def graphs():
    backend = StandInGraphs()
    prev = eng.set_graph_backend(backend)
    yield backend
    eng.set_graph_backend(prev)


def test_the_flag_leaves_a_captured_step_as_an_output(graphs):
    _, tm = _toy_models()
    tr = DistributedTrainer(tm, objectives.get("mse"), optim_method=SGD(0.1))
    params = tr.place_params(tm.get_variables()["params"])
    state = tr.place_params(tm.get_variables()["state"])
    opt_state = tr.init_opt_state(params)
    x, y = _toy_data(n=64)
    reg = MetricsRegistry()
    wd = twd.TrainingWatchdog(policy="checkpoint_and_halt", registry=reg)
    prev = twd.set_active_watchdog(wd)
    try:
        for k in range(3):
            params, opt_state, state, loss = tr.train_step_at(
                params, opt_state, state, tr.put_batch((x, y)), 0, k)
            assert wd.poll() is None
        bad = y.copy()
        bad[5] = np.nan
        tr.train_step_at(params, opt_state, state,
                         tr.put_batch((x, bad)), 0, 3)
        issue = wd.poll()
    finally:
        twd.set_active_watchdog(prev)
    # one program captured, then replayed for each of the 4 calls: the
    # flag is an output of the replays
    assert tr._train_step_at.aot_signatures == 1
    assert graphs.graphs[0].replays == 4
    assert issue is not None and issue["kind"] == "nonfinite"
    assert reg.snapshot()["counters"][
        'train_nonfinite_total{source="step"}'] == 1.0


def test_estimator_halts_on_the_captured_route(graphs, tmp_path):
    _set_policy("checkpoint_and_halt")
    x, y = _toy_data(nan_rows=[300])
    poisoned = _poisoned_step(x, y, 64)
    _, tm = _toy_models()
    est = Estimator(tm, optim_method=tm.optim_method,
                    model_dir=str(tmp_path))
    logged = len(eng.CAPTURE_LOG)
    with pytest.raises(twd.TrainingHalted):
        est.train(FeatureSet.from_ndarrays(x, y), "mse",
                  end_trigger=MaxIteration(200), batch_size=64)
    # the per-step program was captured (the steps were its replays)
    assert [e["fn"] for e in eng.CAPTURE_LOG[logged:]
            if e["fallback"] is None] == ["train_step_at"]
    assert est.train_state.iteration == poisoned + 1
    assert (tmp_path / "halt" / f"snapshot.{poisoned + 1}.ckpt").exists()


def test_check_finite_off_folds_nothing():
    tconfig.get_config().set("observability.check_finite", False)
    _, tm = _toy_models()
    tr = DistributedTrainer(tm, objectives.get("mse"), optim_method=SGD(0.1))
    params = tr.place_params(tm.get_variables()["params"])
    state = tr.place_params(tm.get_variables()["state"])
    out = tr._step_core(params, tr.init_opt_state(params), state,
                        tr.put_batch(_toy_data(n=8)), None)
    assert len(out) == 5 and out[-1] is None
