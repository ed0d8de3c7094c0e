"""PyTorch port, the data pipeline (``analytics_zoo_torch/data/``) against
the JAX package's ``data/`` on the same seeded numpy inputs:

- ``IndexSampler``'s permutations, indices and masks are equal, for
  shuffle, shards, ``drop`` and ``pad``;
- ``DataPipeline`` batches are equal byte for byte across workers,
  stages, transforms and epoch rollover, and so are the state dicts,
  which load into the other package (a fingerprint mismatch raises in
  both) and encode to flax's msgpack bytes;
- ``DeviceLoader`` batches equal the host stream, the position commits
  per batch handed out, and the ``data.batch`` fault site trips before
  the commit;
- the ``Estimator`` on a pipeline resumes a mid-epoch snapshot on the
  exact next batch (the resumed run bit-identical to the uninterrupted
  one, dropout on); without dropout its losses are within 1e-4 of the
  reference's and one step's parameters within 1e-6; a JAX snapshot with
  a ``data`` slot restores into the port; a snapshot without one
  restores the model only and says so;
- ``KerasNet.fit`` on a pipeline, and validation through a ``pad``
  pipeline, match the ``FeatureSet`` route."""

import logging
import shutil

import jax
import numpy as np
import pytest
import torch
from flax import serialization as fser

from analytics_zoo_tpu import data as jdata
from analytics_zoo_tpu.common.triggers import (
    MaxEpoch as JMaxEpoch, MaxIteration as JMaxIteration,
    SeveralIteration as JSeveralIteration)
from analytics_zoo_tpu.feature.common import Preprocessing as JPreprocessing
from analytics_zoo_tpu.feature.feature_set import FeatureSet as JFeatureSet
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from analytics_zoo_tpu.pipeline.api.keras.optimizers import SGD as JSGD
from analytics_zoo_tpu.pipeline.estimator import Estimator as JEstimator

from analytics_zoo_torch import data as tdata
from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.common.triggers import (
    MaxEpoch, MaxIteration, SeveralIteration)
from analytics_zoo_torch.feature import FeatureSet
from analytics_zoo_torch.feature.common import Preprocessing
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.observability import get_registry, reset_registry
from analytics_zoo_torch.pipeline.api.keras import Sequential
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.api.keras.layers import Dense, Dropout
from analytics_zoo_torch.pipeline.api.keras.metrics import MAE
from analytics_zoo_torch.pipeline.api.keras.optimizers import SGD
from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
from analytics_zoo_torch.pipeline.estimator import Estimator
from analytics_zoo_torch.pipeline.estimator.estimator import eval_batches
from analytics_zoo_torch.resilience.chaos import (
    ChaosPlan, FaultSpec, TransientFault, clear_chaos, install_chaos)
from analytics_zoo_torch.utils import msgpack_codec

# the packages sum the same float32 products in other orders
LOSS_ATOL = 1e-4
PARAM_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _port_cpu():
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    reset_registry()
    clear_chaos()
    yield
    clear_chaos()
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _xy(n=100, width=4, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, width).astype(np.float32)
    y = np.arange(n, dtype=np.int64).reshape(n, 1)
    return x, y


def _both(**kw):
    """The same pipeline in each package: (jax, port)."""
    x, y = _xy(kw.pop("n", 100))
    kw.setdefault("seed", 5)
    return (jdata.DataPipeline(x, y, **kw), tdata.DataPipeline(x, y, **kw))


def _assert_same_tree(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for p, q in zip(la, lb):
        p, q = np.asarray(p), np.asarray(q)
        assert p.dtype == q.dtype and p.shape == q.shape
        assert p.tobytes() == q.tobytes()


# ---------------------------------------------------------------- sampler
SAMPLERS = [
    dict(num_records=100, batch_size=10, shuffle=True, seed=3),
    dict(num_records=100, batch_size=10, shuffle=False, seed=3),
    dict(num_records=97, batch_size=4, shuffle=True, seed=9,
         shard_index=1, shard_count=3),
    dict(num_records=25, batch_size=10, shuffle=True, seed=1,
         remainder="pad"),
    dict(num_records=50, batch_size=4, shuffle=True, seed=2,
         shard_index=2, shard_count=3, remainder="pad"),
]


@pytest.mark.parametrize("kw", SAMPLERS, ids=range(len(SAMPLERS)))
def test_sampler_matches_the_reference(kw):
    kw = dict(kw)
    kw.setdefault("shard_index", 0)
    kw.setdefault("shard_count", 1)
    j, t = jdata.IndexSampler(**kw), tdata.IndexSampler(**kw)
    assert t.num_batches == j.num_batches and t.global_batch == \
        j.global_batch
    for epoch in range(3):
        np.testing.assert_array_equal(t.epoch_perm(epoch),
                                      j.epoch_perm(epoch))
        for step in range(j.num_batches):
            (ti, tm), (ji, jm) = (t.batch_indices(epoch, step),
                                  j.batch_indices(epoch, step))
            assert ti.tobytes() == ji.tobytes() and tm.tobytes() == \
                jm.tobytes()
        for (a, ai, am), (b, bi, bm) in zip(t.iter_epoch(epoch, 1),
                                            j.iter_epoch(epoch, 1)):
            assert a == b and ai.tobytes() == bi.tobytes() and \
                am.tobytes() == bm.tobytes()


def test_sampler_defaults_and_errors_match():
    assert (tdata.IndexSampler(40, 8).shard_index,
            tdata.IndexSampler(40, 8).shard_count) == (0, 1)
    assert tdata.IndexSampler(40, 8).seed == int(
        tconfig.get_config().get("data.shuffle_seed"))
    for mod in (jdata, tdata):
        with pytest.raises(ValueError, match="cannot fill"):
            mod.IndexSampler(7, 8, shard_index=0, shard_count=1)
        with pytest.raises(ValueError, match="out of range"):
            mod.IndexSampler(40, 8, shard_index=2, shard_count=2)
        with pytest.raises(ValueError, match="remainder"):
            mod.IndexSampler(40, 8, shard_index=0, shard_count=1,
                             remainder="wrap")
        with pytest.raises(IndexError):
            mod.IndexSampler(40, 8, shard_index=0,
                             shard_count=1).batch_indices(0, 5)


# --------------------------------------------------------------- pipeline
class _JAdd(JPreprocessing):
    def apply(self, x):
        return x + 100.0


class _TAdd(Preprocessing):
    def apply(self, x):
        return x + 100.0


def _scale(b):
    return (b[0] * 3.0, b[1])


PIPELINES = {
    "plain": (dict(batch_size=10), None),
    "workers": (dict(batch_size=10, num_workers=3), "map"),
    "unshuffled_pad": (dict(batch_size=12, shuffle=False,
                            remainder="pad"), None),
    "shard": (dict(batch_size=6, shard_index=1, shard_count=2,
                   num_workers=2), "transform"),
    "per_leaf_pad": (dict(n=97, batch_size=8, remainder="pad"), "leaf"),
}


@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipeline_batches_are_byte_identical(name):
    kw, stage = PIPELINES[name]
    j, t = _both(**kw)
    if stage == "map":
        j, t = j.map(_scale), t.map(_scale)
    elif stage == "transform":
        j, t = j.transform(_JAdd()), t.transform(_TAdd())
    elif stage == "leaf":
        j = j.map(lambda a: a * 2, per_leaf=True)
        t = t.map(lambda a: a * 2, per_leaf=True)
    try:
        # two and a half epochs: the rollover and a mid-epoch stop
        for _ in range(2):
            got, want = list(t), list(j)
            assert len(got) == len(want) == len(j)
            for a, b in zip(got, want):
                _assert_same_tree(a, b)
            assert (t.epoch, t.step) == (j.epoch, j.step)
        it_t, it_j = iter(t), iter(j)
        for _ in range(len(j) // 2):
            _assert_same_tree(next(it_t), next(it_j))
        assert t.state_dict() == j.state_dict()
        assert (t.epoch, t.step) == (2, len(j) // 2)
    finally:
        t.close()
        j.close()


def test_state_dicts_cross_load_and_encode_to_flaxs_bytes():
    j, t = _both(batch_size=10)
    it_j, it_t = iter(j), iter(t)
    for _ in range(4):
        next(it_j), next(it_t)
    sj, st = j.state_dict(), t.state_dict()
    assert st == sj and list(st) == list(sj)
    # flax's serializer walks the tree with jax.tree_util, which sorts a
    # dict's keys: the same bytes for the same key order (the ints of
    # the smallest width, the bools and the version)
    assert msgpack_codec.packb(dict(sorted(st.items()))) == \
        fser.msgpack_serialize(sj)
    assert fser.msgpack_restore(msgpack_codec.packb(st)) == st
    # each package's state into a fresh pipeline of the other: the same
    # remaining batches
    j2, t2 = _both(batch_size=10)
    t2.load_state_dict(sj)
    j2.load_state_dict(st)
    rest = [list(p) for p in (it_j, it_t, j2, t2)]
    assert [len(r) for r in rest] == [6] * 4
    for batches in zip(*rest):
        for b in batches[1:]:
            _assert_same_tree(b, batches[0])
    # the fingerprint: another seed describes another stream
    for mod in (jdata, tdata):
        other = mod.DataPipeline(*_xy(), batch_size=10, seed=6)
        with pytest.raises(ValueError, match="does not match"):
            other.load_state_dict(st)
        other.load_state_dict(st, strict=False)
        assert (other.epoch, other.step) == (0, 4)
        bad = dict(st, version=2)
        with pytest.raises(ValueError, match="version"):
            other.load_state_dict(bad)
    # a position saved exactly at the epoch's end rolls over in both
    end = dict(sj, step=10)
    for p in _both(batch_size=10):
        p.load_state_dict(end)
        assert (p.epoch, p.step) == (1, 0)


def test_sources_adapters_and_stages_match():
    x, y = _xy(30)
    for mod in (jdata, tdata):
        assert mod.as_source(x).gather(np.array([3, 1]))[1] is None
    src_t, src_j = tdata.ArraySource({"a": x, "b": y}), \
        jdata.ArraySource({"a": x, "b": y})
    _assert_same_tree(src_t.gather(np.array([5, 0, 5])),
                      src_j.gather(np.array([5, 0, 5])))
    _assert_same_tree(src_t[7], src_j[7])
    assert src_t.nbytes() == src_j.nbytes()
    with pytest.raises(ValueError, match="rows"):
        tdata.ArraySource(x, y[:5])
    samples = [{"v": np.arange(3) + i} for i in range(4)]
    _assert_same_tree(tdata.BatchStage()(samples),
                      jdata.BatchStage()(samples))
    fs_t = FeatureSet.from_ndarrays(x, y, seed=4)
    fs_j = JFeatureSet.from_ndarrays(x, y, seed=4)
    for a, b in zip(tdata.from_feature_set(fs_t, 8),
                    jdata.from_feature_set(fs_j, 8)):
        _assert_same_tree(a, b)
    p = tdata.as_data_pipeline(x, y, batch_size=8, seed=2)
    assert tdata.as_data_pipeline(p) is p
    assert isinstance(tdata.as_data_pipeline(fs_t, batch_size=8),
                      tdata.DataPipeline)
    out = tdata.pad_to_batch(np.ones((3, 2), np.float32), 5)
    assert out.shape == (5, 2) and not out[3:].any()
    with tdata.WorkerPool(3) as pool:
        assert list(pool.imap(lambda v: v * v, range(20), depth=4)) == \
            [v * v for v in range(20)]
    depths = []
    pit = tdata.PrefetchIterator(iter(range(5)), 2, fn=lambda v: -v,
                                 on_depth=depths.append)
    assert list(pit) == [0, -1, -2, -3, -4] and depths[-1] == 0

    def boom():
        yield 1
        raise RuntimeError("source failed")
    pit = tdata.PrefetchIterator(boom(), 2)
    assert next(pit) == 1
    with pytest.raises(RuntimeError, match="source failed"):
        next(pit)


# ---------------------------------------------------------- device loader
@pytest.mark.parametrize("depth", [0, 2])
def test_device_loader_matches_the_host_stream(depth):
    host = list(_both(batch_size=10, name="host")[1])
    pipe = _both(batch_size=10)[1]
    got = list(tdata.DeviceLoader(pipe, depth=depth))
    assert len(got) == len(host) == 10
    for (dx, dy), (hx, hy) in zip(got, host):
        assert isinstance(dx, torch.Tensor) and dx.device.type == "cpu"
        assert dx.numpy().tobytes() == hx.tobytes()
        assert dy.numpy().tobytes() == hy.tobytes()
    assert (pipe.epoch, pipe.step) == (1, 0)
    assert get_registry().counter(
        "data_batches_total", labels=("pipeline",)).labels(
        "train").value == 10


def test_the_data_batch_fault_trips_before_the_commit():
    pipe = _both(batch_size=10)[1]
    install_chaos(ChaosPlan([FaultSpec("data.batch", at_step=3)]))
    seen = []
    with pytest.raises(TransientFault):
        for b in tdata.DeviceLoader(pipe, depth=2):
            seen.append(b)
    assert len(seen) == 3 and (pipe.epoch, pipe.step) == (0, 3)
    clear_chaos()
    rest = list(tdata.DeviceLoader(pipe, depth=0))
    assert len(rest) == 7
    want = list(_both(batch_size=10)[1])[3]
    assert rest[0][0].numpy().tobytes() == want[0].tobytes()


# --------------------------------------------------- Estimator on a pipeline
def _problem(n=160, d=6):
    rs = np.random.RandomState(0)
    x = rs.randn(n, d).astype(np.float32)
    w = rs.randn(d, 1).astype(np.float32)
    return x, (x @ w).astype(np.float32)


def _port_model(dropout=0.25, jm=None):
    TLayer.reset_name_counters()
    m = Sequential()
    m.add(Dense(8, activation="relu", input_shape=(6,)))
    if dropout:
        m.add(Dropout(dropout))
    m.add(Dense(1))
    m.init(torch.Generator().manual_seed(0))
    if jm is not None:
        load_jax_variables(m, jax.device_get(jm.get_variables()))
    return m


def _jax_model():
    JLayer.reset_name_counters()
    m = JSequential()
    m.add(JDense(8, activation="relu", input_shape=(6,)))
    m.add(JDense(1))
    m.init()
    return m


def _leaves(est):
    return [t.clone() for t in tree_leaves(est.variables["params"])]


def _tpipe(**kw):
    kw.setdefault("seed", 11)
    return tdata.DataPipeline(*_problem(), batch_size=16, **kw)


def test_a_mid_epoch_snapshot_resumes_on_the_exact_next_batch(tmp_path):
    """Interrupted at step 13 of 10-step epochs (mid-epoch 2) and resumed
    by a fresh Estimator and pipeline: the end is bit-identical to the
    uninterrupted run, dropout on — a replayed or skipped batch would
    move the SGD trajectory at once."""
    whole = Estimator(_port_model(), optim_method=SGD(0.05))
    whole.train(_tpipe(), "mse", end_trigger=MaxEpoch(2), rng=3)
    assert whole.train_state.iteration == 20

    d = str(tmp_path / "ckpt")
    half = Estimator(_port_model(), optim_method=SGD(0.05), model_dir=d)
    p_half = _tpipe()
    half.train(p_half, "mse", end_trigger=MaxIteration(13),
               checkpoint_trigger=SeveralIteration(1), rng=3)
    assert half.train_state.iteration == 13
    assert (p_half.epoch, p_half.step) == (1, 3)

    resumed = Estimator(_port_model(), optim_method=SGD(0.05), model_dir=d)
    p_res = _tpipe()
    resumed.train(p_res, "mse", end_trigger=MaxEpoch(2),
                  checkpoint_trigger=SeveralIteration(1), rng=3)
    assert resumed.train_state.iteration == 20
    assert (p_res.epoch, p_res.step) == (2, 0)
    assert get_registry().counter("checkpoint_restore_total").value == 1
    for a, b in zip(_leaves(whole), _leaves(resumed)):
        assert torch.equal(a, b)
    assert resumed.history[-1]["loss"] == whole.history[-1]["loss"]


def test_a_fault_at_the_data_site_retries_from_the_snapshot(tmp_path):
    """``data.batch`` trips at the second epoch's fourth batch: the retry
    restores the snapshot (its ``data`` slot included) and the run ends
    bit-identical to one without the fault."""
    clean = Estimator(_port_model(), optim_method=SGD(0.05))
    clean.train(_tpipe(), "mse", end_trigger=MaxEpoch(2),
                checkpoint_trigger=SeveralIteration(4), rng=3)
    install_chaos(ChaosPlan([FaultSpec("data.batch", at_step=3)]))
    faulted = Estimator(_port_model(), optim_method=SGD(0.05),
                        model_dir=str(tmp_path / "c"))
    pipe = _tpipe()
    faulted.train(pipe, "mse", end_trigger=MaxEpoch(2),
                  checkpoint_trigger=SeveralIteration(4), rng=3)
    assert get_registry().counter("train_retry_total").value == 1
    assert faulted.train_state.iteration == 20
    assert (pipe.epoch, pipe.step) == (2, 0)
    for a, b in zip(_leaves(clean), _leaves(faulted)):
        assert torch.equal(a, b)
    assert [h["loss"] for h in clean.history] == \
        [h["loss"] for h in faulted.history]


def test_a_retry_without_a_snapshot_rewinds_to_the_entry_position(
        tmp_path):
    """A fault at the first step's dispatch, before any snapshot: the
    retry rewinds the pipeline to where it stood at entry, and the run
    ends as one without the fault."""
    clean = Estimator(_port_model(), optim_method=SGD(0.05))
    clean.train(_tpipe(), "mse", end_trigger=MaxEpoch(1), rng=3)
    install_chaos(ChaosPlan([FaultSpec("trainer.dispatch", at_step=0)]))
    faulted = Estimator(_port_model(), optim_method=SGD(0.05),
                        model_dir=str(tmp_path / "c"))
    pipe = _tpipe()
    faulted.train(pipe, "mse", end_trigger=MaxEpoch(1), rng=3)
    assert get_registry().counter("train_retry_total").value == 1
    assert get_registry().counter("checkpoint_restore_total").value == 0
    for a, b in zip(_leaves(clean), _leaves(faulted)):
        assert torch.equal(a, b)


def test_losses_and_one_step_match_the_reference():
    x, y = _problem()
    jm = _jax_model()
    pm = _port_model(dropout=0.0, jm=jm)
    jest = JEstimator(jm, optim_method=JSGD(learning_rate=0.05))
    jest.train(jdata.DataPipeline(x, y, batch_size=16, seed=11), "mse",
               end_trigger=JMaxEpoch(2))
    test = Estimator(pm, optim_method=SGD(0.05))
    test.train(tdata.DataPipeline(x, y, batch_size=16, seed=11), "mse",
               end_trigger=MaxEpoch(2))
    np.testing.assert_allclose([h["loss"] for h in test.history],
                               [h["loss"] for h in jest.history],
                               atol=LOSS_ATOL, rtol=0)
    # one step from the same weights
    jm1 = _jax_model()
    pm1 = _port_model(dropout=0.0, jm=jm1)
    jest = JEstimator(jm1, optim_method=JSGD(learning_rate=0.05))
    jest.train(jdata.DataPipeline(x, y, batch_size=16, seed=11), "mse",
               end_trigger=JMaxIteration(1))
    test = Estimator(pm1, optim_method=SGD(0.05))
    test.train(tdata.DataPipeline(x, y, batch_size=16, seed=11), "mse",
               end_trigger=MaxIteration(1))
    for a, b in zip(_leaves(test), jax.tree_util.tree_leaves(
            jax.device_get(jest.variables["params"]))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=PARAM_ATOL, rtol=0)


def test_a_reference_snapshot_with_a_data_slot_restores_into_the_port(
        tmp_path):
    x, y = _problem()
    jm = _jax_model()
    pm = _port_model(dropout=0.0, jm=jm)
    d = str(tmp_path / "jax")
    jest = JEstimator(jm, optim_method=JSGD(learning_rate=0.05),
                      model_dir=d)
    jpipe = jdata.DataPipeline(x, y, batch_size=16, seed=11)
    jest.train(jpipe, "mse", end_trigger=JMaxIteration(13),
               checkpoint_trigger=JSeveralIteration(1))
    assert (jpipe.epoch, jpipe.step) == (1, 3)
    shutil.copytree(d, tmp_path / "copy")
    jest.train(jpipe, "mse", end_trigger=JMaxEpoch(2),
               checkpoint_trigger=JSeveralIteration(1))
    test = Estimator(pm, optim_method=SGD(0.05),
                     model_dir=str(tmp_path / "copy"))
    tpipe = tdata.DataPipeline(x, y, batch_size=16, seed=11)
    test.train(tpipe, "mse", end_trigger=MaxEpoch(2),
               checkpoint_trigger=SeveralIteration(1))
    assert test.train_state.iteration == 20
    assert (tpipe.epoch, tpipe.step) == (2, 0)
    np.testing.assert_allclose(test.history[-1]["loss"],
                               jest.history[-1]["loss"], atol=LOSS_ATOL,
                               rtol=0)
    for a, b in zip(_leaves(test), jax.tree_util.tree_leaves(
            jax.device_get(jest.variables["params"]))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=LOSS_ATOL, rtol=0)


def test_a_snapshot_without_a_data_slot_restores_the_model_only(
        tmp_path, caplog):
    x, y = _problem()
    d = str(tmp_path / "ckpt")
    est = Estimator(_port_model(), optim_method=SGD(0.05), model_dir=d)
    est.train(FeatureSet.from_ndarrays(x, y, seed=11), "mse",
              end_trigger=MaxEpoch(1), batch_size=16, rng=3)
    pipe = _tpipe()
    again = Estimator(_port_model(), optim_method=SGD(0.05), model_dir=d)
    with caplog.at_level(logging.WARNING,
                         logger="analytics_zoo_torch.estimator"):
        again.train(pipe, "mse", end_trigger=MaxEpoch(2), rng=3)
    assert "no data-pipeline state" in caplog.text
    assert again.train_state.iteration == 20
    # the pipeline replayed its epoch from where it stood: one epoch
    assert (pipe.epoch, pipe.step) == (1, 0)


def test_the_pipeline_fixes_the_batch_size_and_eval_needs_pad():
    est = Estimator(_port_model(), optim_method=SGD(0.05))
    est.train(_tpipe(), "mse", end_trigger=MaxEpoch(1), batch_size=4,
              rng=3)
    assert est.train_state.iteration == 10
    with pytest.raises(ValueError, match="remainder='pad'"):
        next(eval_batches(_tpipe(), 10))


def test_keras_fit_and_pad_validation_match_the_feature_set_route():
    """The FeatureSet on its per-step route (the loss ``history``
    reports follows the route: the last step's on both)."""
    tconfig.get_config().set("train.steps_per_dispatch", 1)
    x, y = _problem(96)
    vx, vy = _problem(37)
    routes = {}
    for kind in ("feature_set", "pipeline"):
        m = _port_model()
        m.compile(optimizer=SGD(0.05), loss="mse", metrics=[MAE()])
        if kind == "feature_set":
            hist = m.fit(x, y, batch_size=16, nb_epoch=2, shuffle=False,
                         validation_data=(vx, vy), rng=3)
        else:
            hist = m.fit(
                tdata.DataPipeline(x, y, batch_size=16, shuffle=False),
                nb_epoch=2, rng=3,
                validation_data=tdata.DataPipeline(
                    vx, vy, batch_size=16, shuffle=False,
                    remainder="pad"))
        routes[kind] = (hist, [np.copy(w) for w in m.get_weights()])
    (fh, fw), (ph, pw) = routes["feature_set"], routes["pipeline"]
    assert [h["loss"] for h in fh] == [h["loss"] for h in ph]
    for a, b in zip(fw, pw):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(fh, ph):
        assert a["val"].keys() == b["val"].keys()
        for k in a["val"]:
            np.testing.assert_allclose(a["val"][k], b["val"][k],
                                       rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="validation_split"):
        _port_model().fit(tdata.DataPipeline(x, y, batch_size=16),
                          validation_split=0.1)
