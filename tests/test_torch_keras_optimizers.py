"""PyTorch port, Keras optimizers: AdamWeightDecay (with and without its
warmup/linear-decay schedule), RMSprop, Adagrad, Adadelta and Adamax
against the JAX package's (optax) over five steps on the same seeded
leaves and gradients — params and every state leaf within 1e-6 absolute
plus 1e-6 relative after each step (float32, the same formulas op for
op) — their state layouts, the state carried both ways between the
packages, and a JAX snapshot of a model trained under AdamWeightDecay
resumed in the port (within 1e-4, several float32 steps in each
package)."""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization as fser

from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.interop import load_jax_opt_state
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import fused as tfused
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.parallel.trainer import DistributedTrainer
from analytics_zoo_torch.pipeline.api.keras import Sequential
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.api.keras.layers import Dense
from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
from analytics_zoo_torch.utils import serialization as ser

TOL = 1e-6
# several steps of a model in each package from the same snapshot
RESUME_ATOL = 1e-4

# each optimizer built the same way from either package's module
OPTIMS = {
    "adamw": lambda m: m.AdamWeightDecay(lr=1e-2),
    "adamw_warmup_decay": lambda m: m.AdamWeightDecay(
        lr=1e-2, warmup_portion=0.4, total=4, weight_decay=0.1),
    "adamw_decay_only": lambda m: m.AdamWeightDecay(lr=1e-2, total=8),
    "rmsprop": lambda m: m.RMSprop(lr=1e-2),
    "rmsprop_schedule": lambda m: m.RMSprop(
        lr=1e-2, schedule=m.poly(1e-2, 0.5, 10)),
    "adagrad": lambda m: m.Adagrad(lr=1e-1),
    "adadelta": lambda m: m.Adadelta(),
    "adamax": lambda m: m.Adamax(lr=1e-2),
}

# optax's state classes, by name, in order
LAYOUTS = {
    "adamw": ["ScaleByAdamState", "EmptyState", "EmptyState"],
    "adamw_warmup_decay": ["ScaleByAdamState", "EmptyState",
                           "ScaleByScheduleState"],
    "adamw_decay_only": ["ScaleByAdamState", "EmptyState",
                         "ScaleByScheduleState"],
    "rmsprop": ["ScaleByRmsState", "EmptyState", "EmptyState"],
    "rmsprop_schedule": ["ScaleByRmsState", "ScaleByScheduleState",
                         "EmptyState"],
    "adagrad": ["ScaleByRssState", "EmptyState"],
    "adadelta": ["EmptyState", "ScaleByAdaDeltaState", "EmptyState"],
    "adamax": ["ScaleByAdamState", "EmptyState"],
}


@pytest.fixture(autouse=True)
def _port_cpu():
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tdtypes.restore_policy(None)
    tctx.init_zoo_context(device="cpu")
    kernels.reset_launch_counts()
    yield
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _leaves(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return {"dense": {"kernel": (rs.randn(6, 4) * scale).astype(np.float32),
                      "bias": (rs.randn(4) * scale).astype(np.float32)},
            "emb": {"embeddings": (rs.randn(10, 3) * scale
                                   ).astype(np.float32)}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _state_names(state):
    return [type(s).__name__ for s in state]


def _assert_trees_close(got, want, tol=TOL, what=""):
    g = tree_leaves(ser.to_state_dict(got))
    w = jax.tree_util.tree_leaves(fser.to_state_dict(want))
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                                   rtol=tol, err_msg=what)


def _run(name, steps, jp, js, tp, ts, jo, to, start=0):
    """``steps`` updates in both packages from the same gradients."""
    for i in range(start, start + steps):
        g = _leaves(100 + i, scale=0.5)
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = to.update(_torch(g), ts, tp)
        tp = jax.tree_util.tree_map(lambda p, u: p + u, tp, tu)
        _assert_trees_close(tp, _np(jp), what=f"{name} params, step {i}")
        _assert_trees_close(ts, _np(js), what=f"{name} state, step {i}")
    return jp, js, tp, ts


@pytest.mark.parametrize("name", sorted(OPTIMS))
def test_five_steps_match_reference(name):
    jo, to = OPTIMS[name](jopt), OPTIMS[name](topt)
    assert to.name == jo.name
    assert to._init_kwargs.keys() == jo._init_kwargs.keys()
    p0 = _leaves(0)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = _torch(p0)
    js, ts = jo.init(jp), to.init(tp)
    assert _state_names(ts) == _state_names(js) == LAYOUTS[name]
    _run(name, 5, jp, js, tp, ts, jo, to)
    # the reference's fused update declines every one of them
    assert tfused.build_fused_update(to, None) is None


@pytest.mark.parametrize("name", sorted(OPTIMS))
def test_state_carries_both_ways(name):
    """Three JAX steps carried into the port by ``load_jax_opt_state``,
    and three port steps carried into the JAX package through the
    snapshot encoding (flax's ``from_bytes`` of the port's bytes); each
    then takes two more steps beside the run it left."""
    jo, to = OPTIMS[name](jopt), OPTIMS[name](topt)
    p0 = _leaves(1)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = _torch(p0)
    js, ts = jo.init(jp), to.init(tp)
    jp, js, tp, ts = _run(name, 3, jp, js, tp, ts, jo, to)

    carried = load_jax_opt_state(to, _np(js))
    assert _state_names(carried) == LAYOUTS[name]
    _run(name, 2, jp, js, _torch(_np(jp)), carried, jo, to, start=3)

    back = fser.from_bytes(js, ser.to_bytes(ts))
    assert _state_names(back) == LAYOUTS[name]
    _run(name, 2, jax.tree_util.tree_map(jnp.asarray, _np(jp)), back, tp,
         ts, jo, to, start=3)

    with pytest.raises(ValueError, match="states differ"):
        load_jax_opt_state(topt.SGD(0.1, momentum=0.9), _np(js))


def test_adamw_schedule_matches_optax():
    steps = np.arange(0, 14, dtype=np.int32)
    for kw in (dict(warmup_portion=0.1, total=8),
               dict(warmup_portion=0.25, total=12), dict(total=5)):
        js = jopt.AdamWeightDecay(lr=2e-5, **kw).learning_rate
        ts = topt.AdamWeightDecay(lr=2e-5, **kw).learning_rate
        want = np.array([np.float32(js(jnp.int32(s))) for s in steps])
        got = np.array([float(ts(torch.tensor(s, dtype=torch.int32)))
                        for s in steps], np.float32)
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=1e-6)
    assert topt.AdamWeightDecay(lr=2e-5).learning_rate == 2e-5
    with pytest.raises(NotImplementedError, match="Plateau"):
        topt.plateau(0.1)


# ------------------------------- a JAX snapshot resumed in the port
def _data(n=32):
    rs = np.random.RandomState(5)
    return (rs.randn(n, 8).astype(np.float32),
            rs.randn(n, 3).astype(np.float32))


def _optim(m):
    return m.AdamWeightDecay(lr=1e-2, warmup_portion=0.25, total=12)


def _jax_fit(epochs, model_dir):
    JLayer.reset_name_counters()
    model = JSequential()
    model.add(JDense(16, activation="tanh", input_shape=(8,)))
    model.add(JDense(3))
    model.compile(_optim(jopt), "mse")
    model.set_checkpoint(str(model_dir))
    x, y = _data()
    return model, model.fit(x, y, batch_size=8, nb_epoch=epochs)


def _port_fit(epochs, model_dir):
    TLayer.reset_name_counters()
    model = Sequential()
    model.add(Dense(16, activation="tanh", input_shape=(8,)))
    model.add(Dense(3))
    model.compile(_optim(topt), "mse")
    model.set_checkpoint(str(model_dir))
    x, y = _data()
    return model, model.fit(x, y, batch_size=8, nb_epoch=epochs)


def test_a_jax_adamw_snapshot_resumes_in_the_port(tmp_path, f32_policy):
    """Two JAX epochs under AdamWeightDecay with its schedule into a
    model_dir; the port resumes the third epoch from that snapshot (the
    Adam moments and the schedule's count included) and ends where the
    JAX package's third epoch ends."""
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    jdir = tmp_path / "jax"
    _jax_fit(2, jdir)
    shutil.copytree(jdir, tmp_path / "copy")
    jwhole, jrest = _jax_fit(3, jdir)
    tmodel, trest = _port_fit(3, tmp_path / "copy")
    assert [h["epoch"] for h in trest] == [h["epoch"] for h in jrest] == [3]
    np.testing.assert_allclose(trest[0]["loss"], jrest[0]["loss"],
                               atol=RESUME_ATOL, rtol=0)
    jparams = _np(jwhole.get_variables()["params"])
    tparams = tmodel.get_variables()["params"]
    for layer in sorted(jparams):
        for key in sorted(jparams[layer]):
            np.testing.assert_allclose(
                tparams[layer][key].numpy(), jparams[layer][key],
                atol=RESUME_ATOL, rtol=0, err_msg=f"{layer}/{key}")
    # the unfused chain ran: no kernel, and the trainer declined the
    # fused update
    assert not DistributedTrainer(
        tmodel, None, optim_method=_optim(topt)).fused_optimizer_active
    assert sum(kernels.launch_counts().values()) == 0
