"""PyTorch port, the Estimator's three dispatch routes on the CPU against
the JAX package: per-step (an iteration-level checkpoint trigger, or
``train.steps_per_dispatch=1``), chunked (``train.hbm_cache_mb=0``, more
steps an epoch than a chunk holds, so the last chunk is short) and the
HBM epoch cache (the defaults).

- The epoch loss ``history`` reports follows the reference's rule on each
  route: the last step's loss per-step, the last chunk's mean chunked,
  the epoch's mean on the HBM route.  (The port reported the epoch's
  mean on every route: 1.79093957 against the reference's 0.22471884 on
  the per-step route of the first test.)
- The routes take the same steps: with dropout on, the three routes'
  parameters are bit-identical to one another.
- Without dropout (the packages draw other random numbers), each route's
  losses are within 1e-4 of the JAX package's on the same route, and one
  step's parameters within 1e-6.
- Recovery: a failed HBM placement trains chunked and ends where the
  chunked route ends; a failure inside an HBM epoch restores the latest
  snapshot and trains on chunked; an injected fault at step k leaves k
  committed steps and retries from the snapshot on every route."""

import logging

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import config as jconfig
from analytics_zoo_tpu.common.triggers import (
    MaxEpoch as JMaxEpoch, SeveralIteration as JSeveralIteration)
from analytics_zoo_tpu.feature.feature_set import FeatureSet as JFeatureSet
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from analytics_zoo_tpu.pipeline.api.keras.optimizers import SGD as JSGD
from analytics_zoo_tpu.pipeline.estimator import Estimator as JEstimator

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.common.triggers import (
    EveryEpoch, MaxEpoch, SeveralIteration)
from analytics_zoo_torch.feature import FeatureSet
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.observability import get_registry
from analytics_zoo_torch.parallel.trainer import DistributedTrainer
from analytics_zoo_torch.pipeline.api.keras import Sequential, objectives
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.api.keras.layers import Dense, Dropout
from analytics_zoo_torch.pipeline.api.keras.optimizers import SGD
from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
from analytics_zoo_torch.pipeline.estimator import Estimator
from analytics_zoo_torch.resilience.chaos import (
    ChaosPlan, FaultSpec, clear_chaos, install_chaos)

# the packages sum the same float32 products in other orders
LOSS_ATOL = 1e-4
PARAM_ATOL = 1e-6

ROUTES = {
    # name: (steps_per_dispatch, hbm_cache_mb, iteration-level checkpoint)
    "per_step": (16, 2048, True),
    "per_step_k1": (1, 2048, False),
    "chunked": (3, 0, False),
    "hbm": (16, 2048, False),
}


@pytest.fixture(autouse=True)
def _port_cpu():
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    yield
    clear_chaos()
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _data(n=64, d=4):
    rs = np.random.RandomState(0)
    x = rs.randn(n, d).astype(np.float32)
    y = (x @ rs.randn(d, 1) + 0.1 * rs.randn(n, 1)).astype(np.float32)
    return x, y


def _jax_model(d=4, hidden=None):
    JLayer.reset_name_counters()
    m = JSequential()
    if hidden:
        m.add(JDense(hidden, activation="relu", input_shape=(d,)))
        m.add(JDense(1))
    else:
        m.add(JDense(1, input_shape=(d,)))
    m.init()
    return m


def _port_model(jm, d=4, hidden=None, dropout=0.0):
    TLayer.reset_name_counters()
    m = Sequential()
    if hidden:
        m.add(Dense(hidden, activation="relu", input_shape=(d,)))
        if dropout:
            m.add(Dropout(dropout))
        m.add(Dense(1))
    else:
        m.add(Dense(1, input_shape=(d,)))
    m.init(torch.Generator().manual_seed(0))
    if jm is not None:
        load_jax_variables(m, jax.device_get(jm.get_variables()))
    return m


def _set(cfg, route):
    k, mb, _ = ROUTES[route]
    cfg.set("train.steps_per_dispatch", k)
    cfg.set("train.hbm_cache_mb", mb)


def _port_train(model, route, epochs=2, shuffle=False, batch=8,
                model_dir=None, data=None):
    _set(tconfig.get_config(), route)
    x, y = data if data is not None else _data()
    est = Estimator(model, optim_method=SGD(0.1), model_dir=model_dir)
    ckpt = SeveralIteration(4) if ROUTES[route][2] else EveryEpoch()
    est.train(FeatureSet.from_ndarrays(x, y, shuffle=shuffle), "mse",
              end_trigger=MaxEpoch(epochs), checkpoint_trigger=ckpt,
              batch_size=batch, rng=3)
    return est


def _jax_train(model, route, epochs=2, batch=8):
    _set(jconfig.get_config(), route)
    x, y = _data()
    est = JEstimator(model, optim_method=JSGD(learning_rate=0.1))
    kw = {"checkpoint_trigger": JSeveralIteration(4)} \
        if ROUTES[route][2] else {}
    est.train(JFeatureSet.from_ndarrays(x, y, shuffle=False), "mse",
              end_trigger=JMaxEpoch(epochs), batch_size=batch, **kw)
    return est


def _losses(est):
    return [h["loss"] for h in est.history]


def _params(variables):
    return [np.asarray(a) for a in tree_leaves(
        jax.device_get(variables["params"])
        if not isinstance(tree_leaves(variables["params"])[0], torch.Tensor)
        else {k: {n: t.numpy() for n, t in v.items()}
              for k, v in variables["params"].items()})]


@pytest.mark.parametrize("route", list(ROUTES))
def test_history_loss_follows_the_references_route(route):
    jm = _jax_model()
    pm = _port_model(jm)
    want = _losses(_jax_train(jm, route))
    got = _losses(_port_train(pm, route))
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0)


def test_the_route_rule_on_the_ports_own_steps():
    """Per route, the reported loss is the last step's, the last chunk's
    mean or the epoch's mean of the same eight step losses."""
    x, y = _data()
    pm = _port_model(None)
    tr = DistributedTrainer(pm, objectives.get("mse"),
                            optim_method=SGD(0.1))
    params = tr.place_params(pm.get_variables()["params"])
    opt_state = tr.init_opt_state(params)
    steps = []
    for b in range(8):
        sl = slice(8 * b, 8 * b + 8)
        params, opt_state, _, loss = tr.train_step_at(
            params, opt_state, {}, tr.put_batch((x[sl], y[sl])), 3, b)
        steps.append(float(loss))
    got = {r: _losses(_port_train(_port_model(None), r, epochs=1))[0]
           for r in ("per_step", "chunked", "hbm")}
    np.testing.assert_allclose(got["per_step"], steps[-1], rtol=1e-6)
    np.testing.assert_allclose(got["chunked"], np.mean(steps[6:]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["hbm"], np.mean(steps), rtol=1e-6)


def test_the_routes_take_bit_identical_steps_with_dropout_on():
    x, y = _data(n=80, d=6)
    ends = {}
    for route in ("per_step_k1", "chunked", "hbm"):
        pm = _port_model(None, d=6, hidden=8, dropout=0.3)
        est = _port_train(pm, route, epochs=3, shuffle=True, data=(x, y))
        assert est.train_state.iteration == 30
        ends[route] = [t.clone() for t in tree_leaves(
            est.variables["params"])]
    for route in ("chunked", "hbm"):
        for a, b in zip(ends[route], ends["per_step_k1"]):
            assert torch.equal(a, b), route


@pytest.mark.parametrize("route", ["per_step_k1", "chunked", "hbm"])
def test_each_route_tracks_the_jax_route(route):
    jm = _jax_model(hidden=8)
    pm = _port_model(jm, hidden=8)
    want = _jax_train(jm, route, epochs=3)
    got = _port_train(pm, route, epochs=3)
    np.testing.assert_allclose(_losses(got), _losses(want), atol=LOSS_ATOL,
                               rtol=0)
    # one step: the first batch, from the same weights
    jm1 = _jax_model(hidden=8)
    pm1 = _port_model(jm1, hidden=8)
    j1 = _jax_train(jm1, route, epochs=1, batch=64)
    p1 = _port_train(pm1, route, epochs=1, batch=64)
    for a, b in zip(_params(p1.variables), _params(j1.variables)):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0)


def _log_records(caplog):
    return [r.getMessage() for r in caplog.records]


def test_a_failed_hbm_placement_trains_chunked(monkeypatch, caplog):
    control = _port_train(_port_model(None, hidden=8), "chunked",
                          shuffle=True)

    def refuse(self, x, y):
        raise RuntimeError("out of memory")
    monkeypatch.setattr(DistributedTrainer, "put_epoch_source", refuse)
    with caplog.at_level(logging.INFO, "analytics_zoo_torch.estimator"):
        est = _port_train(_port_model(None, hidden=8), "hbm", shuffle=True)
    records = _log_records(caplog)
    assert any("falling back to chunked" in r for r in records)
    assert not any("HBM epoch cache active" in r for r in records)
    for a, b in zip(tree_leaves(est.variables["params"]),
                    tree_leaves(control.variables["params"])):
        assert torch.equal(a, b)


def test_a_failed_hbm_epoch_restores_the_snapshot_and_trains_chunked(
        monkeypatch, caplog, tmp_path):
    control = _port_train(_port_model(None, hidden=8), "hbm", epochs=3,
                          shuffle=True)
    real = DistributedTrainer.epoch_scan_fn
    calls = []

    def failing(self, num_batches, batch_size):
        fn = real(self, num_batches, batch_size)

        def epoch(*args, **kw):
            calls.append(num_batches)
            if len(calls) == 2:          # the second HBM epoch
                raise RuntimeError("out of memory")
            return fn(*args, **kw)
        return epoch
    monkeypatch.setattr(DistributedTrainer, "epoch_scan_fn", failing)
    with caplog.at_level(logging.WARNING, "analytics_zoo_torch.estimator"):
        est = _port_train(_port_model(None, hidden=8), "hbm", epochs=3,
                          shuffle=True, model_dir=str(tmp_path))
    assert any("restored checkpoint, falling back to chunked" in r
               for r in _log_records(caplog))
    assert est.train_state.iteration == 24
    assert [h["epoch"] for h in est.history] == [1, 2, 3]
    for a, b in zip(tree_leaves(est.variables["params"]),
                    tree_leaves(control.variables["params"])):
        assert torch.equal(a, b)


def test_a_failed_first_hbm_epoch_without_snapshot_rebuilds_from_entry(
        monkeypatch, caplog):
    control = _port_train(_port_model(None, hidden=8), "chunked",
                          shuffle=True)
    real = DistributedTrainer.epoch_scan_fn
    failed = []

    def failing(self, num_batches, batch_size):
        fn = real(self, num_batches, batch_size)

        def epoch(*args, on_step=None, **kw):
            if not failed:
                failed.append(1)
                # two steps run, then the device fails mid-epoch
                fn2 = real(self, 2, batch_size)
                fn2(*args, on_step=on_step, **kw)
                raise RuntimeError("out of memory")
            return fn(*args, on_step=on_step, **kw)
        return epoch
    monkeypatch.setattr(DistributedTrainer, "epoch_scan_fn", failing)
    with caplog.at_level(logging.WARNING, "analytics_zoo_torch.estimator"):
        est = _port_train(_port_model(None, hidden=8), "hbm", shuffle=True)
    assert any("before any step" in r for r in _log_records(caplog))
    assert est.train_state.iteration == 16
    for a, b in zip(tree_leaves(est.variables["params"]),
                    tree_leaves(control.variables["params"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("route", ["per_step_k1", "chunked", "hbm"])
def test_an_injected_fault_at_step_k_retries_from_the_snapshot(
        route, tmp_path):
    """A TransientFault before step 11 (the second epoch's fourth step):
    steps 8-10 were committed and are rolled back to the iteration-8
    snapshot, then the run ends where the run without the fault ends."""
    clean = _port_train(_port_model(None, hidden=8, dropout=0.3), route,
                        epochs=3, shuffle=True)
    retries = get_registry().counter("train_retry_total")
    before = retries.value
    install_chaos(ChaosPlan([FaultSpec("trainer.dispatch", at_step=11)]))
    est = _port_train(_port_model(None, hidden=8, dropout=0.3), route,
                      epochs=3, shuffle=True, model_dir=str(tmp_path))
    clear_chaos()
    assert retries.value == before + 1
    assert est.train_state.iteration == 24
    assert _losses(est) == _losses(clean)
    for a, b in zip(tree_leaves(est.variables["params"]),
                    tree_leaves(clean.variables["params"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("route", ["per_step_k1", "chunked", "hbm"])
def test_a_fault_without_a_model_dir_leaves_k_committed_steps(route):
    """No snapshot to restore: the fault raises, with exactly the five
    steps before it counted and applied."""
    from analytics_zoo_torch.resilience.chaos import TransientFault
    x, y = _data()
    _set(tconfig.get_config(), route)
    pm = _port_model(None, hidden=8)
    est = Estimator(pm, optim_method=SGD(0.1))
    install_chaos(ChaosPlan([FaultSpec("trainer.dispatch", at_step=5)]))
    with pytest.raises(TransientFault):
        est.train(FeatureSet.from_ndarrays(x, y, shuffle=False), "mse",
                  end_trigger=MaxEpoch(1), batch_size=8, rng=3)
    clear_chaos()
    assert est.train_state.iteration == 5
