"""PyTorch port, elastic recovery (``resilience/recovery.py`` and the
Estimator's REFORM_MESH/DEGRADE branches), the behaviour of the
reference's ``tests/test_elastic_recovery.py:88`` on real processes:

- three gloo ranks, each its own 32-row pipeline (batch 8), snapshot
  every 4 iterations; before step 6 rank 2 dies (exit 137) and ranks 0
  and 1 take a ``LostHost``; they re-form a two-rank group from a fresh
  store, restore snapshot 4 with its pipeline position and finish 2
  epochs; their params are bit-identical to a control run that resumes
  a copy of snapshot 4 on the same two-rank group and trains
  uninterrupted, and to each other;
- one process that loses its host and keeps itself re-forms a one-rank
  mesh and resumes bit-exact against its own control;
- no surviving device ends DEGRADED: ``DegradedTraining`` with the
  record, ``degraded.json``, and the queue point a later run resumes.

Each of the three is also held against the JAX package running the same
scenario (the same data, weights, fault and snapshot cadence, a
dropout-free model: the packages draw different dropout masks): the
ranks' resumed params within ``TOL`` of the reference's on its virtual
devices, the iteration, pipeline position and counters equal, and the
DEGRADE records alike field by field.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest

from analytics_zoo_tpu.common.triggers import MaxEpoch as JMaxEpoch
from analytics_zoo_tpu.common.triggers import MaxIteration as JMaxIteration
from analytics_zoo_tpu.common.triggers import (
    SeveralIteration as JSeveralIteration)
from analytics_zoo_tpu.data import DataPipeline as JDataPipeline
from analytics_zoo_tpu.data.source import as_source as jas_source
from analytics_zoo_tpu.observability import get_registry as jget_registry
from analytics_zoo_tpu.parallel.mesh import create_mesh as jcreate_mesh
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from analytics_zoo_tpu.pipeline.api.keras.optimizers import SGD as JSGD
from analytics_zoo_tpu.pipeline.estimator import Estimator as JEstimator
from analytics_zoo_tpu.resilience import ChaosPlan as JChaosPlan
from analytics_zoo_tpu.resilience import (
    DegradedTraining as JDegradedTraining)
from analytics_zoo_tpu.resilience import FaultSpec as JFaultSpec
from analytics_zoo_tpu.resilience import clear_chaos as jclear_chaos
from analytics_zoo_tpu.resilience import install_chaos as jinstall_chaos
from analytics_zoo_tpu.resilience.chaos import (
    SITE_TRAINER_DISPATCH as JSITE_TRAINER_DISPATCH)

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.common.triggers import (
    MaxEpoch, MaxIteration, SeveralIteration)
from analytics_zoo_torch.data import DataPipeline
from analytics_zoo_torch.observability import get_registry, reset_registry
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.pipeline.api.keras.optimizers import SGD
from analytics_zoo_torch.pipeline.estimator import Estimator
from analytics_zoo_torch.resilience import (
    ChaosPlan, DegradedTraining, FaultSpec, clear_chaos, install_chaos)
from analytics_zoo_torch.resilience.chaos import SITE_TRAINER_DISPATCH

from tests import torch_dist_workers as W


@pytest.fixture
def port_cpu(f32_policy):
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    reset_registry()
    clear_chaos()
    yield
    clear_chaos()
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()


# several SGD steps on both sides, summed over shards in another order
# (ROADMAP: multi-step results within 1e-4)
TOL = dict(rtol=1e-4, atol=1e-6)


def _pipe():
    x, y = W.elastic_problem(256)
    return DataPipeline(x, y, batch_size=32, seed=11, name="elastic")


def _jax_model():
    """The dropout-free elastic model in the JAX package, holding
    ``W.elastic_weights``."""
    JLayer.reset_name_counters()
    m = JSequential()
    m.add(JDense(16, activation="relu", input_shape=(8,)))
    m.add(JDense(1))
    v = m.init(jax.random.PRNGKey(0))
    m.set_variables({"params": dict(zip([l.name for l in m.layers],
                                        W.elastic_weights())),
                     "state": v["state"]})
    return m


def _hold_to_jax(port_params, jax_params):
    """Leaf by leaf, in layer order (the packages name layers alike but
    count them apart)."""
    jparams = jax.device_get(jax_params)
    assert len(port_params) == len(jparams)
    for (pn, pw), jn in zip(port_params.items(), jparams):
        for k, a in pw.items():
            np.testing.assert_allclose(a, jparams[jn][k], err_msg=f"{pn}.{k}",
                                       **TOL)


def _jcounter(name, *labels):
    c = jget_registry().counter(
        name, "", labels=("class",) if name == "train_failures_total"
        else (("action",) if name == "train_recovery_total" else ()))
    return c.labels(*labels) if labels else c


class _HostsPipeline(JDataPipeline):
    """The port ranks' global batches, for the JAX package: step ``s`` of
    an epoch is each live host's own batch ``s`` (its 32 rows, batch 8,
    seed 11: one sampler serves them all) in rank order.  The live hosts
    are the estimator's mesh's devices: 3, then the 2 survivors."""

    def __init__(self, live):
        x, y = W.elastic_problem()
        super().__init__(x[:32], y[:32], batch_size=8, seed=11,
                         name="elastic", shard_index=0, shard_count=1)
        self.hosts = [jas_source(x[h * 32:(h + 1) * 32],
                                 y[h * 32:(h + 1) * 32]) for h in range(3)]
        self.live = live

    @property
    def batch_size(self):
        return 8 * self.live()

    def iter_epoch(self, epoch, start_step=0):
        for step, sel, _ in self.sampler.iter_epoch(epoch, start_step):
            parts = [h.gather(sel) for h in self.hosts[:self.live()]]
            yield step, tuple(np.concatenate(p) for p in zip(*parts))


def _counter(name, *labels):
    c = get_registry().counter(
        name, "", labels=("class",) if name == "train_failures_total"
        else (("action",) if name == "train_recovery_total" else ()))
    return c.labels(*labels) if labels else c


def test_a_lost_rank_reforms_the_group_and_resumes_bit_exact(tmp_path):
    codes, outs = W.run_world("elastic", 3, tmp_path, timeout=150)
    assert codes == [0, 0, 137], codes
    run = [k for k in outs[0] if k.startswith("run_")]
    assert run
    for rank, o in enumerate(outs[:2]):
        assert int(o["iteration"]) == int(o["ctl_iteration"]) == 8
        assert tuple(o["position"]) == (2, 0)
        assert int(o["world"]) == 2 and int(o["new_rank"]) == rank
        assert not bool(o["degraded"])
        assert float(o["reformations"]) == 1
        for k in run:
            np.testing.assert_array_equal(o[k], o[k.replace("run_", "ctl_")],
                                          err_msg=k)
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
    assert outs[2] is None          # the lost rank wrote nothing


def test_one_process_reforms_on_itself_and_resumes_bit_exact(port_cpu,
                                                              tmp_path):
    d1 = str(tmp_path / "elastic")
    install_chaos(ChaosPlan([FaultSpec(
        site=SITE_TRAINER_DISPATCH, at_step=6, kind="lose_host",
        survivors=[0])]))
    est = Estimator(W.elastic_model(), optim_method=SGD(learning_rate=0.05),
                    model_dir=d1)
    pipe = _pipe()
    est.train(pipe, "mse", end_trigger=MaxEpoch(2),
              checkpoint_trigger=SeveralIteration(4))
    clear_chaos()
    assert est.train_state.iteration == 16
    assert (pipe.epoch, pipe.step) == (2, 0)
    assert _counter("train_failures_total", "lost_host").value == 1
    assert _counter("train_recovery_total", "reform_mesh").value == 1
    assert _counter("mesh_reformations_total").value == 1
    assert est._mesh.world_size == 1
    assert not os.path.exists(os.path.join(d1, "degraded.json"))
    d2 = str(tmp_path / "control")
    os.makedirs(d2)
    shutil.copy(os.path.join(d1, "snapshot.4.ckpt"), d2)
    ctl = Estimator(W.elastic_model(), optim_method=SGD(learning_rate=0.05),
                    model_dir=d2)
    ctl.train(_pipe(), "mse", end_trigger=MaxEpoch(2),
              checkpoint_trigger=SeveralIteration(4))
    for n, w in est.variables["params"].items():
        for k, a in w.items():
            np.testing.assert_array_equal(
                a.numpy(), ctl.variables["params"][n][k].numpy())


def test_no_viable_topology_degrades_with_structured_result(port_cpu,
                                                             tmp_path):
    d = str(tmp_path / "run")
    install_chaos(ChaosPlan([FaultSpec(
        site=SITE_TRAINER_DISPATCH, at_step=5, kind="lose_host",
        survivors=[])]))
    est = Estimator(W.elastic_model(), optim_method=SGD(learning_rate=0.05),
                    model_dir=d)
    with pytest.raises(DegradedTraining) as ei:
        est.train(_pipe(), "mse", end_trigger=MaxEpoch(2),
                  checkpoint_trigger=SeveralIteration(2))
    r = ei.value.result
    assert r["status"] == "degraded"
    assert r["failure_class"] == "lost_host"
    assert "no viable topology" in r["reason"]
    assert r["iteration"] == 5
    assert r["snapshot"].endswith("snapshot.4.ckpt")
    assert r["data_position"]["epoch"] == 0
    with open(os.path.join(d, "degraded.json")) as f:
        assert json.load(f) == r
    assert get_registry().counter("train_degraded_total", "").value == 1
    clear_chaos()
    resumed = Estimator(W.elastic_model(),
                        optim_method=SGD(learning_rate=0.05), model_dir=d)
    resumed.train(_pipe(), "mse", end_trigger=MaxIteration(6))
    assert resumed.train_state.iteration == 6


def test_past_the_reformation_budget_the_run_degrades(port_cpu, tmp_path):
    tconfig.get_config().set("train.max_mesh_reformations", 0)
    install_chaos(ChaosPlan([FaultSpec(
        site=SITE_TRAINER_DISPATCH, at_step=3, kind="lose_host",
        survivors=[0])]))
    est = Estimator(W.elastic_model(), optim_method=SGD(learning_rate=0.05),
                    model_dir=str(tmp_path))
    with pytest.raises(DegradedTraining) as ei:
        est.train(_pipe(), "mse", end_trigger=MaxEpoch(1),
                  checkpoint_trigger=SeveralIteration(2))
    assert "already re-formed" in ei.value.result["reason"]
    assert _counter("train_recovery_total", "degrade").value == 1


# ------------------------------------------------- against the JAX package
def test_the_reformed_ranks_match_the_jax_package(port_cpu, tmp_path):
    """The three-rank scenario without dropout, and the JAX package on 3
    virtual devices fed the same global batches, losing all but devices
    0 and 1 at the same step and re-forming on them."""
    codes, outs = W.run_world("elastic_plain", 3, tmp_path / "port",
                              timeout=150)
    assert codes == [0, 0, 137], codes
    devices = jax.devices()
    before = {k: _jcounter(*k).value for k in (
        ("train_failures_total", "lost_host"),
        ("train_recovery_total", "reform_mesh"),
        ("mesh_reformations_total",))}
    est = []
    pipe = _HostsPipeline(lambda: est[0]._mesh.devices.size)
    jinstall_chaos(JChaosPlan([JFaultSpec(
        site=JSITE_TRAINER_DISPATCH, at_step=6, kind="lose_host",
        survivors=[d.id for d in devices[:2]])]))
    try:
        est.append(JEstimator(_jax_model(),
                              optim_method=JSGD(learning_rate=0.05),
                              model_dir=str(tmp_path / "jax"),
                              mesh=jcreate_mesh({"data": 3},
                                                devices=devices[:3])))
        est[0].train(pipe, "mse", end_trigger=JMaxEpoch(2),
                     checkpoint_trigger=JSeveralIteration(4))
    finally:
        jclear_chaos()
    ref = est[0]
    assert ref._mesh.devices.size == 2
    for k, v in before.items():
        assert _jcounter(*k).value == v + 1, k
    names = [l.name for l in W.elastic_model(dropout=False).layers]
    for rank, o in enumerate(outs[:2]):
        assert int(o["iteration"]) == ref.train_state.iteration == 8
        assert tuple(o["position"]) == (pipe.epoch, pipe.step) == (2, 0)
        assert int(o["world"]) == 2 and int(o["new_rank"]) == rank
        assert float(o["reformations"]) == 1
        _hold_to_jax({n: {k: o[f"run_{n}_{k}"] for k in ("kernel", "bias")}
                      for n in names}, ref.variables["params"])
    assert outs[2] is None


def test_one_process_reform_matches_the_jax_package(port_cpu, tmp_path):
    """The one-process re-form without dropout against the reference's own
    scenario: 8 virtual devices, 4 survive at step 6."""
    install_chaos(ChaosPlan([FaultSpec(
        site=SITE_TRAINER_DISPATCH, at_step=6, kind="lose_host",
        survivors=[0])]))
    est = Estimator(W.elastic_model(dropout=False),
                    optim_method=SGD(learning_rate=0.05),
                    model_dir=str(tmp_path / "port"))
    pipe = _pipe()
    est.train(pipe, "mse", end_trigger=MaxEpoch(2),
              checkpoint_trigger=SeveralIteration(4))
    clear_chaos()
    devices = jax.devices()
    before = _jcounter("mesh_reformations_total").value
    jinstall_chaos(JChaosPlan([JFaultSpec(
        site=JSITE_TRAINER_DISPATCH, at_step=6, kind="lose_host",
        survivors=[d.id for d in devices[:4]])]))
    try:
        ref = JEstimator(_jax_model(), optim_method=JSGD(learning_rate=0.05),
                         model_dir=str(tmp_path / "jax"),
                         mesh=jcreate_mesh({"data": 8}, devices=devices))
        x, y = W.elastic_problem(256)
        jpipe = JDataPipeline(x, y, batch_size=32, seed=11, name="elastic")
        ref.train(jpipe, "mse", end_trigger=JMaxEpoch(2),
                  checkpoint_trigger=JSeveralIteration(4))
    finally:
        jclear_chaos()
    assert ref._mesh.devices.size == 4 and est._mesh.world_size == 1
    assert _jcounter("mesh_reformations_total").value == before + 1
    assert _counter("mesh_reformations_total").value == 1
    assert est.train_state.iteration == ref.train_state.iteration == 16
    assert (pipe.epoch, pipe.step) == (jpipe.epoch, jpipe.step) == (2, 0)
    _hold_to_jax({n: {k: a.numpy() for k, a in w.items()}
                  for n, w in est.variables["params"].items()},
                 ref.variables["params"])


def test_the_degrade_record_matches_the_jax_package(port_cpu, tmp_path):
    """No survivor at step 5, snapshots every 2: the two records field by
    field (paths by their snapshot's name), then each package's later run
    resumed from its queue point to iteration 6."""
    records, resumed = {}, {}
    for side in ("port", "jax"):
        d = str(tmp_path / side)
        if side == "port":
            install_chaos(ChaosPlan([FaultSpec(
                site=SITE_TRAINER_DISPATCH, at_step=5, kind="lose_host",
                survivors=[])]))
            est = Estimator(W.elastic_model(dropout=False),
                            optim_method=SGD(learning_rate=0.05),
                            model_dir=d)
            with pytest.raises(DegradedTraining) as ei:
                est.train(_pipe(), "mse", end_trigger=MaxEpoch(2),
                          checkpoint_trigger=SeveralIteration(2))
            clear_chaos()
            later = Estimator(W.elastic_model(dropout=False),
                              optim_method=SGD(learning_rate=0.05),
                              model_dir=d)
            later.train(_pipe(), "mse", end_trigger=MaxIteration(6))
            resumed[side] = {n: {k: a.numpy() for k, a in w.items()}
                             for n, w in later.variables["params"].items()}
        else:
            jinstall_chaos(JChaosPlan([JFaultSpec(
                site=JSITE_TRAINER_DISPATCH, at_step=5, kind="lose_host",
                survivors=[])]))
            x, y = W.elastic_problem(256)
            try:
                est = JEstimator(_jax_model(),
                                 optim_method=JSGD(learning_rate=0.05),
                                 model_dir=d)
                with pytest.raises(JDegradedTraining) as ei:
                    est.train(JDataPipeline(x, y, batch_size=32, seed=11,
                                            name="elastic"), "mse",
                              end_trigger=JMaxEpoch(2),
                              checkpoint_trigger=JSeveralIteration(2))
            finally:
                jclear_chaos()
            later = JEstimator(_jax_model(),
                               optim_method=JSGD(learning_rate=0.05),
                               model_dir=d)
            later.train(JDataPipeline(x, y, batch_size=32, seed=11,
                                      name="elastic"), "mse",
                        end_trigger=JMaxIteration(6))
            resumed[side] = later.variables["params"]
        assert later.train_state.iteration == 6
        r = dict(ei.value.result)
        with open(os.path.join(d, "degraded.json")) as f:
            assert json.load(f) == r
        assert r.pop("checkpoint_dir") == d
        r["snapshot"] = os.path.basename(r["snapshot"])
        del r["recorded_unix"]
        records[side] = r
    assert records["port"] == records["jax"]
    assert records["port"]["snapshot"] == "snapshot.4.ckpt"
    _hold_to_jax(resumed["port"], resumed["jax"])
