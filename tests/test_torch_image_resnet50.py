"""PyTorch port, ResNet-50 (the ResNet bench's net, BASELINE config 3)
against the JAX package on the CPU at (2, 32, 32, 3), 10 classes, for
both stems (``conv7``, ``space_to_depth``) and both paddings (``same``,
``torch``): the variable trees, eval-mode logits, and a training-mode
forward's moving statistics.  Each pair is built once for the module.

Both packages run ``dtype.compute=float32``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.models.image.imageclassification import nets as jnets
from analytics_zoo_tpu.ops import dtypes as jdtypes
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.models.image.imageclassification import nets as tnets
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves

# eval-mode logits of the whole float32 net: the frameworks sum each
# convolution's products in other orders (seen: at most 4.2e-7)
LOGITS_ATOL = 1e-5
# a training-mode forward's moving statistics (batch 8): float32 means
# of activations that the batch normalization of the layers before
# them amplifies rounding into (seen: 1.8e-5)
STATE_ATOL = 1e-4
VARIANTS = [(stem, pad) for stem in ("conv7", "space_to_depth")
            for pad in ("same", "torch")]


def _port_context():
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tdtypes.restore_policy(None)
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(autouse=True)
def _port_cpu(f32_policy):
    _port_context()
    yield
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


@pytest.fixture(scope="module")
def resnet50_pairs():
    """{(stem, padding): (JAX net, port net)}, the port holding the JAX
    net's variables.  The values are drawn by the port and set into the
    JAX net first: the JAX package's initializers take ~10 s a ResNet-50
    on this CPU."""
    old = jdtypes.get_policy()
    jdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    _port_context()
    pairs = {}
    for stem, pad in VARIANTS:
        kw = dict(num_classes=10, input_shape=(32, 32, 3), stem=stem,
                  conv_padding=pad)
        JLayer.reset_name_counters()
        jm = jnets.resnet(50, **kw)
        TLayer.reset_name_counters()
        tm = tnets.resnet(50, **kw)
        drawn = tm.init(torch.Generator().manual_seed(0))
        jm.set_variables(jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.numpy()), drawn))
        load_jax_variables(tm, jax.tree_util.tree_map(
            np.asarray, jm.get_variables()))
        pairs[stem, pad] = (jm, tm)
    jdtypes.restore_policy(old)
    return pairs


@pytest.mark.parametrize("stem,pad", VARIANTS)
def test_resnet50_variables_match_reference(resnet50_pairs, stem, pad):
    jm, tm = resnet50_pairs[stem, pad]
    want = jax.eval_shape(lambda k: JLayer.init(jm, k, None),
                          jax.random.PRNGKey(0))
    got = tm.get_variables()
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == tuple(w.shape)
    # the bench's count: 161 parameter leaves, 53 BNs' two statistics
    assert len(tree_leaves(got["params"])) == 161
    assert len(tree_leaves(got["state"])) == 106


@pytest.mark.parametrize("stem,pad", VARIANTS)
def test_resnet50_eval_logits_match_reference(resnet50_pairs, stem, pad):
    jm, tm = resnet50_pairs[stem, pad]
    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(jm.predict(x, batch_size=2))
    got = tm.predict(x, batch_size=2)
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)


def test_resnet50_training_forward_statistics_match_reference(
        resnet50_pairs):
    """One training-mode forward of the bench's stem (batch 8): every
    BN's new moving mean and variance."""
    jm, tm = resnet50_pairs["space_to_depth", "same"]
    jv = jax.tree_util.tree_map(np.asarray, jm.get_variables())
    tv = tm.get_variables()
    x = np.random.RandomState(2).randn(8, 32, 32, 3).astype(np.float32)
    want, wstate = jm.apply(jv["params"], x, state=jv["state"],
                            training=True)
    got, gstate = tm.apply(tv["params"], torch.from_numpy(x),
                           state=tv["state"], training=True)
    assert tuple(got.shape) == want.shape and torch.isfinite(got).all()
    n = 0
    for layer, s in wstate.items():
        for k, v in s.items():
            n += 1
            np.testing.assert_allclose(gstate[layer][k].numpy(),
                                       np.asarray(v), atol=STATE_ATOL,
                                       rtol=0, err_msg=f"{layer}/{k}")
            assert not np.array_equal(np.asarray(v), jv["state"][layer][k])
    assert n == 106
