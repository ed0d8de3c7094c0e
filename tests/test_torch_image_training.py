"""PyTorch port, training the image classification models: ResNet-18
built in both packages, the port holding the JAX model's variables, then
a training-mode forward (logits and new moving statistics) and five
steps of ``fit`` with the ResNet bench's SGD, momentum and warmup/poly
schedule (losses, params and moving statistics) compared on the CPU;
and, on the port alone, that ``fit`` and ``train_step`` hand BN's new
state out of the step.

Both packages run ``dtype.compute=float32``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.common import zoo_context as jctx
from analytics_zoo_tpu.models.image.imageclassification import nets as jnets
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.models.image.imageclassification import nets as tnets
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.parallel.trainer import DistributedTrainer
from analytics_zoo_torch.pipeline.api.keras import objectives as tobj
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves

LOSS = "sparse_categorical_crossentropy_with_logits"
# a training-mode forward normalizes by the batch's statistics, which
# amplifies rounding with depth: one ulp of change in the input moves
# ResNet-18's (8, 16, 16, 3) training logits by 2.3e-5 in the JAX
# package itself, and the port differs from it by 3.6e-5
TRAIN_ATOL = 1e-4
# multi-step losses, params and moving statistics: the reference's own
# cross-program float32 tolerance (ROADMAP.md, ground rules)
STEP_ATOL = 1e-4


def _port_context():
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tdtypes.restore_policy(None)
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(autouse=True)
def _port_cpu(f32_policy):
    _port_context()
    kernels.reset_launch_counts()
    yield
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shared(jbuild, tbuild):
    """The same net built in both packages, the port holding the JAX
    net's variables (``load_jax_variables``).  The values are drawn by
    the port's initializers and set into the JAX net first: the JAX
    package's initializers take 10-30 s a net on this CPU, one compile
    per parameter shape."""
    JLayer.reset_name_counters()
    jm = jbuild()
    TLayer.reset_name_counters()
    tm = tbuild()
    drawn = getattr(tm, "model", tm).init(torch.Generator().manual_seed(0))
    jm.set_variables(jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), drawn))
    load_jax_variables(tm, _np(jm.get_variables()))
    return jm, tm


def _images(n, shape, seed=0):
    return np.random.RandomState(seed).randn(n, *shape).astype(np.float32)


def test_resnet18_training_forward_matches_reference():
    jm, tm = _shared(
        lambda: jnets.resnet(18, num_classes=4, input_shape=(16, 16, 3)),
        lambda: tnets.resnet(18, num_classes=4, input_shape=(16, 16, 3)))
    jv, tv = _np(jm.get_variables()), tm.get_variables()
    x = _images(8, (16, 16, 3), seed=3)
    want, wstate = jm.apply(jv["params"], x, state=jv["state"],
                            training=True)
    got, gstate = tm.apply(tv["params"], torch.from_numpy(x),
                           state=tv["state"], training=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TRAIN_ATOL, rtol=0)
    assert sorted(gstate) == sorted(wstate)
    n_bn = 0
    for layer, s in wstate.items():
        for k, v in s.items():
            n_bn += k == "moving_mean"
            np.testing.assert_allclose(gstate[layer][k].numpy(),
                                       np.asarray(v), atol=TRAIN_ATOL, rtol=0,
                                       err_msg=f"{layer}/{k}")
            assert not gstate[layer][k].requires_grad
    assert n_bn == 20


def _bench_sgd(opt, lr=0.1):
    """``benchmarks/resnet.py``'s optimizer: SGD, momentum 0.9, a linear
    warmup over 5 steps then poly(0.5) over 10,000, base lr ``lr``."""
    return opt.SGD(learning_rate=lr, momentum=0.9,
                   schedule=opt.warmup_then(
                       lr, 5, opt.poly(lr, 0.5, max_iteration=10_000)))


def test_resnet18_fit_matches_reference():
    """Five steps (five epochs of one batch of 16, so each epoch's loss is
    one step's) of the ResNet bench's SGD, momentum 0.9 and the
    warmup-then-poly schedule: losses, params and moving statistics.

    The base lr is 0.01, not the bench's 0.1, and the batch 16: this
    small net's trajectory is chaotic at lr 0.1 (loss 2.3 -> 10.2 by the
    fourth step) and at batch 8, where a change of one ulp in the JAX
    package's own weights moves its fifth loss by 2.2e-2, so no tolerance
    could tell a fault from the chaos.  Here one ulp of input moves the
    JAX package's losses by at most 5.2e-6, and the port's differ by at
    most 1.4e-5."""
    jm, tm = _shared(
        lambda: jnets.resnet(18, num_classes=4, input_shape=(16, 16, 3)),
        lambda: tnets.resnet(18, num_classes=4, input_shape=(16, 16, 3)))
    x = _images(16, (16, 16, 3), seed=5)
    y = np.random.RandomState(6).randint(0, 4, 16).astype(np.int32)
    # over the test mesh's 8 data-parallel devices the JAX package would
    # take BN's statistics per shard of 2 rows, the port over the whole
    # batch: a model axis of 8 keeps the JAX batch whole
    jctx.init_zoo_context(mesh_shape={"data": 1, "model": 8})
    jm.compile(_bench_sgd(jopt, lr=0.01), LOSS)
    tm.compile(_bench_sgd(topt, lr=0.01), LOSS)
    jhist = jm.fit(x, y, batch_size=16, nb_epoch=5)
    thist = tm.fit(x, y, batch_size=16, nb_epoch=5)
    assert len(thist) == len(jhist) == 5
    for t, j in zip(thist, jhist):
        np.testing.assert_allclose(t["loss"], j["loss"], atol=STEP_ATOL,
                                   rtol=0)
    # the warmup's first step has lr 0: the params move from step 2 on
    assert thist[-1]["loss"] != thist[0]["loss"]
    assert kernels.launch_counts()["fused_sgd"] == 0      # the CPU route
    jv, tv = _np(jm.get_variables()), tm.get_variables()
    for col in ("params", "state"):
        assert sorted(tv[col]) == sorted(jv[col])
        for layer in jv[col]:
            for k, v in jv[col][layer].items():
                np.testing.assert_allclose(
                    tv[col][layer][k].numpy(), v, atol=STEP_ATOL, rtol=0,
                    err_msg=f"{col}/{layer}/{k}")
    np.testing.assert_allclose(tm.predict(x), np.asarray(jm.predict(x)),
                               atol=STEP_ATOL, rtol=0)


def test_fit_updates_batchnorm_moving_statistics():
    """The JAX package's ``test_batchnorm_state_updates_in_training`` on
    the port; the new state is what ``predict`` reads afterwards."""
    m = tnets.resnet(18, num_classes=4, input_shape=(8, 8, 3))
    m.compile(optimizer="sgd", loss=LOSS)
    x = np.random.RandomState(0).randint(0, 256, (16, 8, 8, 3)).astype(
        np.float32)
    y = np.zeros(16, np.int32)
    before = [t.clone() for t in tree_leaves(m.get_variables()["state"])]
    p_before = m.predict(x[:2])
    m.fit(x, y, batch_size=16, nb_epoch=1)
    after = tree_leaves(m.get_variables()["state"])
    assert len(after) == len(before) == 40
    assert any(not torch.allclose(a, b) for a, b in zip(before, after))
    assert not any(t.requires_grad for t in after)
    assert not np.allclose(m.predict(x[:2]), p_before)


def test_train_step_returns_the_new_state():
    """``DistributedTrainer.train_step`` hands the moving statistics out
    of the step, detached, and leaves the caller's tensors alone."""
    m = tnets.resnet(18, num_classes=4, input_shape=(8, 8, 3))
    opt = _bench_sgd(topt)
    tr = DistributedTrainer(m, tobj.get(LOSS), optim_method=opt)
    v = m.get_variables()
    params = tr.place_params(v["params"])
    state0 = tr.replicate(v["state"])
    opt_state = tr.init_opt_state(params)
    batch = tr.put_batch((_images(8, (8, 8, 3)),
                          np.arange(8, dtype=np.int64) % 4))
    state = state0
    for _ in range(2):
        params, opt_state, state, loss = tr.train_step(
            params, opt_state, state, batch, None)
    assert np.isfinite(float(loss))
    for layer in state0:
        for k in state0[layer]:
            assert state[layer][k] is not state0[layer][k]
            assert not state[layer][k].requires_grad
            assert not torch.equal(state[layer][k], state0[layer][k])


