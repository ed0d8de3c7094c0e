"""PyTorch port, layers: each ported layer against its JAX layer on the
same weights and inputs (numpy, from seeds), under a float32 compute
policy in both packages, at 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.common.config import get_config as j_get_config
from analytics_zoo_tpu.pipeline.api.keras.layers import attention as jatt
from analytics_zoo_tpu.pipeline.api.keras.layers import core as jcore
from analytics_zoo_tpu.pipeline.api.keras.layers import embedding as jemb
from analytics_zoo_tpu.pipeline.api.keras.layers.merge import Merge as JMerge
from analytics_zoo_tpu.pipeline.api.keras.layers import normalization as jnorm
from analytics_zoo_tpu.pipeline.api.keras.layers import pooling as jpool

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.pipeline.api.keras import layers as tl
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer


@pytest.fixture(autouse=True)
def _port_f32(f32_policy):
    """The port on the CPU with a float32 policy (the JAX side gets the
    same from the conftest's f32_policy)."""
    tctx.reset_zoo_context()
    tconfig.reset_config()
    TLayer.reset_name_counters()
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    kernels.reset_launch_counts()
    yield
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _set_mode(mode):
    j_get_config().set("ops.fused", "lax" if mode == "auto" else mode)
    tconfig.get_config().set("ops.fused", mode)


def _compare(jlayer, tlayer, inputs, in_shape, seed=0, atol=1e-5):
    """Build both layers, give them the same weights, run both on the
    same inputs (an array, or a list of arrays), compare."""
    jparams = jlayer.init(jax.random.PRNGKey(0), in_shape)["params"]
    tparams = tlayer.init(torch.Generator().manual_seed(0), in_shape)["params"]
    assert sorted(jparams) == sorted(tparams)
    rs = np.random.RandomState(seed)
    shared = {}
    for name in sorted(jparams):
        assert tuple(jparams[name].shape) == tuple(tparams[name].shape), name
        shared[name] = (rs.randn(*jparams[name].shape) * 0.3
                        ).astype(np.float32)
    if isinstance(inputs, list):     # a multi-input layer
        jin = [jnp.asarray(a) for a in inputs]
        tin = [torch.from_numpy(a) for a in inputs]
    else:
        jin, tin = jnp.asarray(inputs), torch.from_numpy(inputs)
    want = jlayer.call({k: jnp.asarray(v) for k, v in shared.items()}, jin)
    got = tlayer.call({k: torch.from_numpy(v) for k, v in shared.items()},
                      tin)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=atol, rtol=atol)
    assert sum(kernels.launch_counts().values()) == 0
    return got


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("activation,mode", [
    ("relu", "auto"), ("gelu", "auto"), ("gelu", "off"), ("tanh", "auto"),
    (None, "auto")])
def test_dense(activation, mode):
    _set_mode(mode)
    _compare(jcore.Dense(24, activation=activation),
             tl.Dense(24, activation=activation),
             _x(1, 4, 10, 32), (10, 32))


def test_embedding():
    ids = np.random.RandomState(2).randint(0, 50, size=(4, 7))
    _compare(jemb.Embedding(50, 16), tl.Embedding(50, 16), ids, (7,))


@pytest.mark.parametrize("mode,n", [
    ("sum", 3), ("mul", 3), ("max", 3), ("min", 3), ("ave", 3),
    ("concat", 3), ("sub", 2), ("dot", 2), ("cosine", 2)])
def test_merge(mode, n):
    xs = [_x(s, 4, 8) for s in range(n)]
    _compare(JMerge(mode=mode), tl.Merge(mode=mode), xs, [(8,)] * n)


def test_flatten():
    _compare(jcore.Flatten(), tl.Flatten(), _x(8, 4, 3, 5), (3, 5))


def test_lambda_infers_its_output_shape():
    from analytics_zoo_torch.pipeline.api.keras import Input
    x = Input(shape=(6, 4))
    y = tl.Lambda(lambda t: t[:, 0] * 2)(x)
    assert y.shape == (None, 4)


def test_dropout_is_identity_at_inference_and_scales_in_training():
    x = torch.ones(64, 64)
    drop = tl.Dropout(0.25)
    assert drop.call({}, x) is x
    out = drop.call({}, x, training=True,
                    rng=torch.Generator().manual_seed(3))
    kept = out != 0
    assert torch.equal(out[kept], torch.full_like(out[kept], 1 / 0.75))
    assert 0.65 < kept.float().mean().item() < 0.85
    with pytest.raises(ValueError, match="rng"):
        drop.call({}, x, training=True)


def test_global_max_pooling_1d():
    _compare(jpool.GlobalMaxPooling1D(), tl.GlobalMaxPooling1D(),
             _x(3, 4, 9, 16), (9, 16))


@pytest.mark.parametrize("activation,mode", [
    (None, "auto"), ("gelu", "auto"), ("gelu", "off"), ("relu", "auto")])
def test_layernorm(activation, mode):
    _set_mode(mode)
    _compare(jnorm.LayerNorm(epsilon=1e-5, activation=activation),
             tl.LayerNorm(epsilon=1e-5, activation=activation),
             _x(4, 4, 6, 32) * 2 + 1, (6, 32))


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True)])
def test_multi_head_self_attention(causal, masked):
    x = _x(5, 2, 16, 32)
    kw = dict(hidden_size=32, n_head=4, causal=causal)
    if masked:
        mask = (np.random.RandomState(6).rand(2, 16) > 0.25
                ).astype(np.float32)
        _compare(jatt.MultiHeadSelfAttention(**kw),
                 tl.MultiHeadSelfAttention(**kw), [x, mask],
                 [(16, 32), (16,)])
    else:
        _compare(jatt.MultiHeadSelfAttention(**kw),
                 tl.MultiHeadSelfAttention(**kw), x, (16, 32))


@pytest.mark.parametrize("activation,mode", [
    ("gelu", "auto"), ("gelu", "off"), ("relu", "auto")])
def test_positionwise_feed_forward(activation, mode):
    _set_mode(mode)
    _compare(jatt.PositionwiseFeedForward(32, 64, activation=activation),
             tl.PositionwiseFeedForward(32, 64, activation=activation),
             _x(7, 2, 8, 32), (8, 32))


def test_parallelism_waits_for_the_multi_gpu_slice():
    """The multi-GPU slice has come: the parallel options build, and on a
    one-rank mesh each layer computes the reference layer's output with
    the same options (tests/test_torch_parallel.py holds them on
    several ranks)."""
    _compare(jatt.MultiHeadSelfAttention(32, 4, sequence_parallel=True),
             tl.MultiHeadSelfAttention(32, 4, sequence_parallel=True),
             _x(3, 8, 8, 32), (8, 32))
    _compare(jatt.PositionwiseFeedForward(32, 64, tensor_parallel=True),
             tl.PositionwiseFeedForward(32, 64, tensor_parallel=True),
             _x(4, 2, 8, 32), (8, 32))
    _compare(jcore.Dense(8, parallel_mode="column"),
             tl.Dense(8, parallel_mode="column"), _x(5, 4, 32), (32,))


def test_auto_names_follow_the_reference():
    from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
    JLayer.reset_name_counters()
    TLayer.reset_name_counters()
    jnames = [jcore.Dense(4).name, jcore.Dense(4).name,
              jnorm.LayerNorm().name, jatt.MultiHeadSelfAttention(8, 2).name]
    tnames = [tl.Dense(4).name, tl.Dense(4).name, tl.LayerNorm().name,
              tl.MultiHeadSelfAttention(8, 2).name]
    assert tnames == jnames == ["dense_1", "dense_2", "layernorm_1",
                                "multiheadselfattention_1"]
