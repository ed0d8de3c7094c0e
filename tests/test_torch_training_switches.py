"""PyTorch port, the training switches: the transfer-learning surgery
(``freeze``, ``unfreeze``, ``freeze_up_to``, ``new_graph``,
``init_from``), optimizer groups (``DistributedTrainer(optim_groups=)``,
``Estimator(optim_methods=)``, the group-keyed state through
``interop.load_jax_opt_state`` and through a snapshot and resume) and
``train.remat``, held to the JAX package on the same weights (the JAX
model's, through ``interop.load_jax_variables``) under float32 products.

Frozen leaves are bit-identical through ``fit`` with the fused update on
and off; trajectories are within 1e-4 of the reference's; one step's
gradients within 1e-6.  A remat step equals the plain step bit for bit on
the CPU, with dropout (its recompute draws from a generator set to the
step generator's state before the forward) and with BatchNormalization
(the new moving statistics are the first forward's)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.common.triggers import MaxEpoch as JMaxEpoch
from analytics_zoo_tpu.feature.feature_set import FeatureSet as JFeatureSet
from analytics_zoo_tpu.parallel.trainer import _group_params as j_group
from analytics_zoo_tpu.pipeline.api.keras import Input as JInput
from analytics_zoo_tpu.pipeline.api.keras import Model as JModel
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from analytics_zoo_tpu.pipeline.estimator import Estimator as JEstimator

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.common.triggers import MaxEpoch
from analytics_zoo_torch.feature import FeatureSet
from analytics_zoo_torch.interop import load_jax_opt_state, load_jax_variables
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.parallel.trainer import (
    DistributedTrainer, _group_params, step_generator,
)
from analytics_zoo_torch.pipeline.api.keras import Input, Model, Sequential
from analytics_zoo_torch.pipeline.api.keras import objectives as tobj
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras.layers import (
    BatchNormalization, Dense, Dropout, Lambda,
)
from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
from analytics_zoo_torch.pipeline.estimator import Estimator

LOSS = "sparse_categorical_crossentropy_with_logits"
TRAJ_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _port_f32(f32_policy):
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    kernels.reset_launch_counts()
    yield
    assert sum(kernels.launch_counts().values()) == 0
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _base(pkg):
    inp = (JInput if pkg == "jax" else Input)(shape=(8,))
    D = JDense if pkg == "jax" else Dense
    x = D(16, activation="relu", name="backbone1")(inp)
    feat = D(8, activation="relu", name="backbone2")(x)
    out = D(2, name="old_head")(feat)
    return (JModel if pkg == "jax" else Model)(inp, out)


def _pair_base():
    jm, tm = _base("jax"), _base("port")
    load_jax_variables(tm, jax.device_get(jm.init(jax.random.PRNGKey(0))))
    return jm, tm


def _data(n=64, seed=0, classes=2):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, 8)).astype(np.float32),
            r.integers(0, classes, size=(n, 1)))


def _np(tree):
    return {k: {n: t.detach().cpu().numpy().copy() for n, t in v.items()}
            for k, v in tree.items()}


def _close(tparams, jparams, atol):
    jparams = jax.device_get(jparams)
    assert set(tparams) == set(jparams)
    for layer in jparams:
        for name, want in jparams[layer].items():
            np.testing.assert_allclose(
                tparams[layer][name].detach().cpu().numpy(), want,
                atol=atol, rtol=0, err_msg=f"{layer}/{name}")


# ---------------------------------------------------------------- surgery
def test_new_graph_shares_the_sources_layers_and_tensors():
    m = _base("port")
    m.init()
    sub = m.new_graph("backbone2")
    assert [l.name for l in sub.layers] == ["backbone1", "backbone2"]
    assert all(a is b for a, b in zip(sub.layers, m.layers))
    assert sub.get_output_shape() == (None, 8)
    mv, sv = m.get_variables(), sub.get_variables()
    for name in ("backbone1", "backbone2"):
        for k in mv["params"][name]:
            assert sv["params"][name][k] is mv["params"][name][k]
    with pytest.raises(ValueError, match="no such layer"):
        m.new_graph("nope")
    with pytest.raises(ValueError, match="no such layer"):
        m.freeze("nope")
    two = m.new_graph(["backbone1", "old_head"])
    assert len(two.outputs) == 2


def test_freeze_up_to_and_unfreeze_match_the_reference():
    def branchy(pkg):
        inp = (JInput if pkg == "jax" else Input)(shape=(4,))
        D = JDense if pkg == "jax" else Dense
        a = D(3, name="a")(inp)
        b = D(3, name="b")(a)
        c = D(3, name="c")(inp)
        shared = D(3, name="shared")
        s1, s2 = shared(b), shared(c)
        out = D(1, name="out")(s2)
        return (JModel if pkg == "jax" else Model)(inp, [out, s1])
    for names in (("b",), ("shared",), ("c", "a"), ("out",)):
        jm, tm = branchy("jax"), branchy("port")
        jm.freeze_up_to(*names)
        tm.freeze_up_to(*names)
        assert tm.frozen_layer_names() == jm.frozen_layer_names()
        tm.unfreeze("a")
        jm.unfreeze("a")
        assert tm.frozen_layer_names() == jm.frozen_layer_names()
        tm.unfreeze()
        assert tm.frozen_layer_names() == set()
        tm.freeze()
        assert tm.frozen_layer_names() == {l.name for l in tm.layers}


@pytest.mark.parametrize("fused", [True, False])
def test_finetune_frozen_backbone_bit_identical_and_as_the_reference(fused):
    """Train the base, cut it at backbone2, freeze, stack a new head,
    ``init_from`` the base and fine-tune: frozen leaves bit-identical,
    the head moved, every leaf within 1e-4 of the reference's run."""
    tconfig.get_config().set("train.fused_optimizer", fused)
    x, y = _data()
    nets = {}
    jm, tm = _pair_base()
    for pkg, m, opt in (("jax", jm, jopt), ("port", tm, topt)):
        m.compile(opt.Adam(lr=1e-2), LOSS)
        m.fit(x, y, batch_size=16, nb_epoch=1, shuffle=False)
        sub = m.new_graph("backbone2")
        sub.freeze()
        head = (JDense if pkg == "jax" else Dense)(3, name="new_head")
        ft = (JModel if pkg == "jax" else Model)(
            sub.inputs[0], head(sub.outputs[0]))
        ft.init_from(m)
        nets[pkg] = (m, ft)
    jft, tft = nets["jax"][1], nets["port"][1]
    assert tft.frozen_layer_names() == {"backbone1", "backbone2"}
    # the same new head in both packages; the backbone is the port's own
    # training, the donor's tensors themselves
    tv = tft.get_variables()
    for name in ("backbone1", "backbone2"):
        for k, t in tv["params"][name].items():
            assert t is nets["port"][0].get_variables()["params"][name][k]
    head = jax.device_get(jft.get_variables()["params"]["new_head"])
    tv["params"]["new_head"] = {k: torch.as_tensor(np.array(v))
                                for k, v in head.items()}
    _close(tv["params"], jft.get_variables()["params"], TRAJ_ATOL)
    before = _np(tv["params"])
    y3 = np.random.default_rng(1).integers(0, 3, size=(64, 1))
    for ft, opt in ((jft, jopt), (tft, topt)):
        ft.compile(opt.Adam(lr=1e-2), LOSS)
        ft.fit(x, y3, batch_size=16, nb_epoch=2, shuffle=False)
    after = _np(tft.get_variables()["params"])
    for name in ("backbone1", "backbone2"):
        for k in before[name]:
            np.testing.assert_array_equal(after[name][k], before[name][k])
    assert any(not np.array_equal(before["new_head"][k],
                                  after["new_head"][k])
               for k in before["new_head"])
    _close(tft.get_variables()["params"], jft.get_variables()["params"],
           TRAJ_ATOL)
    # fine-tuning the cut net left the source model's tensors as they were
    src = _np(nets["port"][0].get_variables()["params"])
    for name in ("backbone1", "backbone2"):
        for k in before[name]:
            np.testing.assert_array_equal(src[name][k], before[name][k])


@pytest.mark.parametrize("fused", [True, False])
def test_freeze_is_bit_identical_under_weight_decay(fused):
    """Weight decay moves a leaf whose gradient is zero: the trainer
    restores the frozen leaves after the update."""
    tconfig.get_config().set("train.fused_optimizer", fused)
    seq = Sequential()
    seq.add(Dense(8, input_shape=(4,), name="frozen_d", activation="relu"))
    seq.add(Dense(2, name="live_d"))
    seq.compile(topt.AdamWeightDecay(lr=1e-2, weight_decay=0.1), LOSS)
    seq.freeze("frozen_d")
    r = np.random.default_rng(2)
    x = r.normal(size=(32, 4)).astype(np.float32)
    y = r.integers(0, 2, size=(32, 1))
    before = _np(seq.get_variables()["params"])
    seq.fit(x, y, batch_size=16, nb_epoch=2)
    after = _np(seq.get_variables()["params"])
    for k in before["frozen_d"]:
        np.testing.assert_array_equal(before["frozen_d"][k],
                                      after["frozen_d"][k])
    assert not np.array_equal(before["live_d"]["kernel"],
                              after["live_d"]["kernel"])


def test_a_wholly_frozen_model_fits_without_moving():
    """Every layer frozen: the objective carries no gradient, the step
    takes zero gradients (``jax.grad``'s), and nothing moves."""
    x, y = _data(32, seed=3)
    m = _base("port")
    m.init(torch.Generator().manual_seed(0))
    m.freeze()
    before = _np(m.get_variables()["params"])
    m.compile(topt.Adam(lr=1e-2), LOSS)
    hist = m.fit(x, y, batch_size=16, nb_epoch=1)
    assert np.isfinite(hist[0]["loss"])
    after = _np(m.get_variables()["params"])
    for layer in before:
        for k in before[layer]:
            np.testing.assert_array_equal(after[layer][k], before[layer][k])


def test_gradient_flows_through_a_frozen_layer_as_in_the_reference():
    def build(pkg):
        seq = (JSequential if pkg == "jax" else Sequential)()
        D = JDense if pkg == "jax" else Dense
        seq.add(D(8, input_shape=(4,), name="early", activation="relu"))
        seq.add(D(8, name="middle", activation="relu"))
        seq.add(D(2, name="head"))
        seq.freeze("middle")
        return seq
    jm, tm = build("jax"), build("port")
    jvars = jax.device_get(jm.init(jax.random.PRNGKey(3)))
    load_jax_variables(tm, jvars)
    x = np.random.default_rng(4).normal(size=(8, 4)).astype(np.float32)
    y = np.zeros((8, 1), np.int64)

    def jloss(p):
        out, _ = jm.apply(p, x, state=jvars["state"], training=True)
        return jobj.get(LOSS)(y, out)
    jg = jax.device_get(jax.grad(jloss)(jvars["params"]))
    tr = DistributedTrainer(tm, tobj.get(LOSS), topt.Adam())
    _, tg, _ = tr.loss_and_grads(tm.get_variables()["params"], {},
                                 (torch.as_tensor(x), torch.as_tensor(y)),
                                 None)
    for v in tree_leaves(tg["middle"]):
        assert float(v.abs().sum()) == 0.0
    assert any(float(v.abs().sum()) > 0 for v in tree_leaves(tg["early"]))
    _close(tg, jg, 1e-6)


def test_init_from_adopts_the_donors_variables_by_name():
    donor = Sequential()
    donor.add(Dense(4, input_shape=(3,), name="shared_d"))
    donor.add(Dense(2, name="donor_only"))
    donor.init(torch.Generator().manual_seed(1))
    net = Sequential()
    net.add(Dense(4, input_shape=(3,), name="shared_d"))
    net.add(Dense(5, name="own_head"))
    net.init_from(donor, torch.Generator().manual_seed(2))
    p = net.get_variables()["params"]
    assert set(p) == {"shared_d", "own_head"}
    assert p["shared_d"]["kernel"] is \
        donor.get_variables()["params"]["shared_d"]["kernel"]


# ------------------------------------------------------- optimizer groups
@pytest.mark.parametrize("groups", [
    {"a": ["x", "z"], "rest": "*"}, {"rest": "*", "a": ["y"]},
    {"a": ["x"], "b": ["y", "z"]}, {"all": "*"}])
def test_group_params_matches_the_reference(groups):
    params = {"z": {}, "x": {}, "w": {}, "y": {}}
    assert _group_params(params, groups) == j_group(params, groups)


def _grouped(pkg):
    opt = jopt if pkg == "jax" else topt
    return {"head": (opt.Adam(lr=1e-2), ["old_head"]),
            "rest": (opt.SGD(0.05, momentum=0.9), "*")}


def _jax_grouped_fit(jm, x, y, epochs, model_dir=None):
    est = JEstimator(jm, optim_methods=_grouped("jax"), model_dir=model_dir)
    est.train(JFeatureSet.from_ndarrays(x, y, shuffle=False), LOSS,
              end_trigger=JMaxEpoch(epochs), batch_size=16)
    return est


def _port_grouped_fit(tm, x, y, epochs, model_dir=None):
    est = Estimator(tm, optim_methods=_grouped("port"),
                    model_dir=None if model_dir is None else str(model_dir))
    est.train(FeatureSet.from_ndarrays(x, y, shuffle=False), LOSS,
              end_trigger=MaxEpoch(epochs), batch_size=16)
    return est


def test_optimizer_groups_match_the_reference():
    x, y = _data(seed=5)
    jm, tm = _pair_base()
    jest = _jax_grouped_fit(jm, x, y, 2)
    test = _port_grouped_fit(tm, x, y, 2)
    np.testing.assert_allclose([h["loss"] for h in test.history],
                               [h["loss"] for h in jest.history],
                               atol=TRAJ_ATOL)
    _close(tm.get_variables()["params"], jm.get_variables()["params"],
           TRAJ_ATOL)
    tr = DistributedTrainer(tm, tobj.get(LOSS),
                            optim_groups=_grouped("port"))
    assert not tr.fused_optimizer_active
    state = tr.init_opt_state(tm.get_variables()["params"])
    assert set(state) == {"head", "rest"}
    adam, = [s for s in topt.collect_states(state["head"])
             if hasattr(s, "mu")]
    trace, = [s for s in topt.collect_states(state["rest"])
              if hasattr(s, "trace")]
    assert set(adam.mu) == {"old_head"}
    assert set(trace.trace) == {"backbone1", "backbone2"}
    with pytest.raises(ValueError, match="optim_method"):
        Estimator(tm).train(FeatureSet.from_ndarrays(x, y), LOSS)


def test_grouped_state_loads_from_the_reference():
    """The reference's ``{group: optax state}`` after two updates, carried
    into the port, equals the port's own state after the same updates."""
    jm, tm = _pair_base()
    jp = jax.device_get(jm.get_variables()["params"])
    groups = _group_params(jp, {k: v[1] for k, v in
                                _grouped("jax").items()})
    rs = np.random.RandomState(7)
    grads = [{k: {n: rs.randn(*np.shape(a)).astype(np.float32)
                  for n, a in v.items()} for k, v in jp.items()}
             for _ in range(2)]
    jstate, tstate = {}, {}
    for g, names in groups.items():
        for pkg, out in (("jax", jstate), ("port", tstate)):
            method = _grouped(pkg)[g][0]
            sub = {k: jp[k] for k in names}
            if pkg == "port":
                sub = {k: {n: torch.as_tensor(np.array(a))
                           for n, a in v.items()}
                       for k, v in sub.items()}
            s = method.init(sub)
            for gr in grads:
                gsub = {k: gr[k] for k in names}
                if pkg == "port":
                    gsub = {k: {n: torch.as_tensor(a) for n, a in v.items()}
                            for k, v in gsub.items()}
                _, s = method.update(gsub, s, sub)
            out[g] = s
    loaded = load_jax_opt_state(_grouped("port"),
                                jax.device_get(jstate))
    assert set(loaded) == {"head", "rest"}
    for g in loaded:
        got, want = tree_leaves(loaded[g]), tree_leaves(tstate[g])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="groups differ"):
        load_jax_opt_state(_grouped("port"), {"head": jstate["head"]})


def test_grouped_snapshots_resume(tmp_path):
    """Groups through ``model_dir``: a port run resumed after one epoch
    ends bit-identical to the uninterrupted run; the reference's
    snapshot resumes in the port within 1e-4 of the reference's run."""
    x, y = _data(seed=6)
    _, whole = _pair_base()
    _port_grouped_fit(whole, x, y, 2)
    _, first = _pair_base()
    _port_grouped_fit(first, x, y, 1, tmp_path / "port")
    _, resumed = _pair_base()
    resumed.init(torch.Generator().manual_seed(9))   # overwritten by resume
    est = _port_grouped_fit(resumed, x, y, 2, tmp_path / "port")
    assert [h["epoch"] for h in est.history] == [2]
    for a, b in zip(resumed.get_weights(), whole.get_weights()):
        np.testing.assert_array_equal(a, b)

    jm, _ = _pair_base()
    _jax_grouped_fit(jm, x, y, 1, str(tmp_path / "jax"))
    jwhole, _ = _pair_base()
    _jax_grouped_fit(jwhole, x, y, 2)
    _, from_jax = _pair_base()
    _port_grouped_fit(from_jax, x, y, 2, tmp_path / "jax")
    _close(from_jax.get_variables()["params"],
           jwhole.get_variables()["params"], TRAJ_ATOL)


# ------------------------------------------------------------ train.remat
class _DirectDraw(Sequential):
    """A container whose forward draws from the step generator itself
    (not from a generator folded from its seed), so a recompute sees the
    first forward's masks only if it is handed that generator's state."""

    def apply(self, params, inputs, state=None, training=False, rng=None):
        out, new_state = super().apply(params, inputs, state=state,
                                       training=training, rng=rng)
        if training:
            mask = torch.rand(tuple(out.shape), generator=rng) < 0.7
            out = torch.where(mask, out / 0.7, torch.zeros_like(out))
        return out, new_state


def _remat_net(kind, calls):
    def count(v):
        calls.append(1)
        return v
    seq = _DirectDraw() if kind == "direct" else Sequential()
    seq.add(Dense(16, input_shape=(6,), activation="relu", name="d1"))
    seq.add(Lambda(count, name="counter"))
    if kind == "batchnorm":
        seq.add(BatchNormalization(name="bn"))
    else:
        seq.add(Dropout(0.4, name="drop"))
    seq.add(Dense(3, name="d2"))
    seq.init(torch.Generator().manual_seed(0))
    return seq


@pytest.mark.parametrize("kind", ["dropout", "batchnorm", "direct"])
def test_remat_step_equals_the_plain_step(kind):
    rs = np.random.RandomState(8)
    batch = (torch.as_tensor(rs.randn(12, 6).astype(np.float32)),
             torch.as_tensor(rs.randint(0, 3, (12, 1))))
    out = {}
    for remat in (False, True):
        tconfig.get_config().set("train.remat", remat)
        calls = []
        net = _remat_net(kind, calls)
        calls.clear()              # the shape probes at build
        tr = DistributedTrainer(net, tobj.get(LOSS), topt.Adam(lr=1e-2))
        v = net.get_variables()
        params = tr.place_params(v["params"])
        opt_state = tr.init_opt_state(params)
        state = v["state"]
        for step in range(3):
            params, opt_state, state, loss = tr.train_step_at(
                params, opt_state, state, batch, seed=11, step=step)
        out[remat] = (params, state, loss, len(calls))
    p0, s0, l0, c0 = out[False]
    p1, s1, l1, c1 = out[True]
    # the recompute ran: the forward twice a step
    assert (c0, c1) == (3, 6)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        assert torch.equal(a, b)
    assert set(s0) == set(s1)
    for a, b in zip(tree_leaves(s0), tree_leaves(s1)):
        assert torch.equal(a, b)
    if kind == "batchnorm":
        init = _remat_net(kind, []).get_variables()["state"]["bn"]
        assert not torch.equal(s1["bn"]["moving_mean"], init["moving_mean"])


def test_remat_fit_matches_the_reference():
    x, y = _data(seed=9)
    jm, tm = _pair_base()
    for cfg in (tconfig.get_config(),):
        cfg.set("train.remat", True)
    from analytics_zoo_tpu.common.config import get_config as jcfg
    jcfg().set("train.remat", True)
    jm.compile(jopt.Adam(lr=1e-2), LOSS)
    tm.compile(topt.Adam(lr=1e-2), LOSS)
    jh = jm.fit(x, y, batch_size=16, nb_epoch=2, shuffle=False)
    th = tm.fit(x, y, batch_size=16, nb_epoch=2, shuffle=False)
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], atol=TRAJ_ATOL)
    _close(tm.get_variables()["params"], jm.get_variables()["params"],
           TRAJ_ATOL)
