"""PyTorch port, recurrent layers: ``SimpleRNN``/``LSTM``/``GRU`` and
``Bidirectional`` against the JAX package's layers on the same weights and
inputs (numpy, from seeds): forward under float32 products (1e-6 at
T <= 12, 1e-5 at T = 64) and under bf16 products (1e-2), ``run`` with an
initial carry, and input and parameter gradients by autograd against
``jax.grad`` (1e-5)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.ops import dtypes as jdtypes
from analytics_zoo_tpu.pipeline.api.keras.layers import recurrent as jrnn

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.pipeline.api.keras import layers as tl
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.api.keras.layers import recurrent as trnn

# Under bf16 products both packages round the same operands, but the
# float32 sums feeding each rounding are taken in different orders (XLA
# vs PyTorch); a value on a bf16 rounding boundary moves one bf16 step
# (2^-8 relative) and carries through the following steps.
BF16_ATOL = 1e-2

CLASSES = ["SimpleRNN", "LSTM", "GRU"]
B, D, H = 3, 5, 6


@pytest.fixture(autouse=True)
def _port_cpu():
    tctx.reset_zoo_context()
    tconfig.reset_config()
    TLayer.reset_name_counters()
    tctx.init_zoo_context(device="cpu")
    kernels.reset_launch_counts()
    yield
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


@pytest.fixture
def f32_both(f32_policy):
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")


def _pair(cls, *args, **kwargs):
    return getattr(jrnn, cls)(*args, **kwargs), \
        getattr(trnn, cls)(*args, **kwargs)


def _shared(jparams, tparams, rs):
    """The same random values under both trees' keys (nested dicts
    included)."""
    assert sorted(jparams) == sorted(tparams)
    out = {}
    for k in sorted(jparams):
        if isinstance(jparams[k], dict):
            out[k] = _shared(jparams[k], tparams[k], rs)
        else:
            assert tuple(jparams[k].shape) == tuple(tparams[k].shape), k
            out[k] = (rs.randn(*jparams[k].shape) * 0.4).astype(np.float32)
    return out


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _build(jlayer, tlayer, t, seed=0):
    shape = (None, t, D)
    jparams = jlayer.init(jax.random.PRNGKey(0), shape)["params"]
    tparams = tlayer.init(torch.Generator().manual_seed(0), shape)["params"]
    rs = np.random.RandomState(seed)
    shared = _shared(jparams, tparams, rs)
    x = rs.randn(B, t, D).astype(np.float32)
    return shared, x


def _forward(jlayer, tlayer, shared, x):
    want = np.asarray(jlayer.call(_tree(jnp.asarray, shared),
                                  jnp.asarray(x)))
    got = tlayer.call(_tree(torch.from_numpy, shared), torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    assert sum(kernels.launch_counts().values()) == 0
    return got.numpy(), want


@pytest.mark.parametrize("go_backwards", [False, True])
@pytest.mark.parametrize("return_sequences", [False, True])
@pytest.mark.parametrize("cls", CLASSES)
def test_forward_matches_reference(f32_both, cls, return_sequences,
                                   go_backwards):
    jlayer, tlayer = _pair(cls, H, return_sequences=return_sequences,
                           go_backwards=go_backwards)
    got, want = _forward(jlayer, tlayer, *_build(jlayer, tlayer, 7))
    assert got.shape == ((B, 7, H) if return_sequences else (B, H))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("cls", CLASSES)
def test_forward_matches_reference_at_64_steps(f32_both, cls):
    jlayer, tlayer = _pair(cls, H, return_sequences=True)
    got, want = _forward(jlayer, tlayer, *_build(jlayer, tlayer, 64, seed=1))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("merge_mode", ["concat", "sum", "mul", "ave"])
def test_bidirectional_matches_reference(f32_both, merge_mode):
    jinner, tinner = _pair("LSTM", H, return_sequences=True)
    jlayer = jrnn.Bidirectional(jinner, merge_mode=merge_mode)
    tlayer = trnn.Bidirectional(tinner, merge_mode=merge_mode)
    assert tlayer.backward_layer.name == tinner.name + "_bwd"
    assert tlayer.backward_layer.go_backwards and not tinner.go_backwards
    shared, x = _build(jlayer, tlayer, 9)
    assert sorted(shared) == ["backward", "forward"]
    got, want = _forward(jlayer, tlayer, shared, x)
    width = 2 * H if merge_mode == "concat" else H
    assert got.shape == (B, 9, width)
    assert tlayer.compute_output_shape((None, 9, D)) == (None, 9, width)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("cls", CLASSES)
def test_forward_bf16_products_match_reference(cls):
    assert jdtypes.get_policy().compute_dtype == jnp.bfloat16
    assert tdtypes.get_policy().compute_dtype == torch.bfloat16
    jlayer, tlayer = _pair(cls, H, return_sequences=True)
    got, want = _forward(jlayer, tlayer, *_build(jlayer, tlayer, 12))
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("cls", CLASSES)
def test_run_with_initial_carry(f32_both, cls, collect):
    """``run`` from a given carry returns the reference's outputs (or
    None) and final carry; LSTM's carry is an (h, c) pair."""
    jlayer, tlayer = _pair(cls, H)
    shared, x = _build(jlayer, tlayer, 8)
    rs = np.random.RandomState(5)
    n = 2 if cls == "LSTM" else 1
    carry = [rs.randn(B, H).astype(np.float32) for _ in range(n)]
    jcarry = tuple(map(jnp.asarray, carry)) if n == 2 else \
        jnp.asarray(carry[0])
    tcarry = tuple(map(torch.from_numpy, carry)) if n == 2 else \
        torch.from_numpy(carry[0])
    jouts, jlast = jlayer.run(_tree(jnp.asarray, shared), jnp.asarray(x),
                              initial_carry=jcarry, collect_outputs=collect)
    touts, tlast = tlayer.run(_tree(torch.from_numpy, shared),
                              torch.from_numpy(x), initial_carry=tcarry,
                              collect_outputs=collect)
    if collect:
        np.testing.assert_allclose(touts.numpy(), np.asarray(jouts),
                                   atol=1e-6, rtol=0)
    else:
        assert touts is None and jouts is None
    jlast = jlast if n == 2 else (jlast,)
    tlast = tlast if n == 2 else (tlast,)
    assert len(tlast) == len(jlast) == n
    for a, b in zip(tlast, jlast):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("cls", CLASSES + ["Bidirectional"])
def test_gradients_match_jax_grad(f32_both, cls):
    """d <out, w> / d(params, x) by autograd against ``jax.grad``."""
    if cls == "Bidirectional":
        jin, tin = _pair("GRU", H, return_sequences=True)
        jlayer, tlayer = (jrnn.Bidirectional(jin, merge_mode="mul"),
                          trnn.Bidirectional(tin, merge_mode="mul"))
    else:
        jlayer, tlayer = _pair(cls, H, return_sequences=True)
    shared, x = _build(jlayer, tlayer, 10, seed=3)
    w = np.random.RandomState(4).randn(
        *tlayer.compute_output_shape((B, 10, D))).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jlayer.call(p, xx) * jnp.asarray(w))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(_tree(jnp.asarray, shared),
                                                 jnp.asarray(x))
    tp = _tree(lambda a: torch.from_numpy(a).requires_grad_(), shared)
    tx = torch.from_numpy(x).requires_grad_()
    (tlayer.call(tp, tx) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5,
                               rtol=0)

    def check(t, j):
        for k in j:
            if isinstance(j[k], dict):
                check(t[k], j[k])
            else:
                np.testing.assert_allclose(t[k].grad.numpy(),
                                           np.asarray(j[k]), atol=1e-5,
                                           rtol=0, err_msg=k)
    check(tp, jgp)


def test_bidirectional_model_variables_carry_over(f32_both):
    """A graph ``Model`` holding a ``Bidirectional`` layer: its nested
    {"forward", "backward"} params load through ``load_jax_variables``
    under the reference's key paths, and the models agree."""
    from analytics_zoo_tpu.pipeline.api.keras import Input as JInput
    from analytics_zoo_tpu.pipeline.api.keras import Model as JModel
    from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
    from analytics_zoo_tpu.pipeline.api.keras.layers import (
        Dense as JDense, Embedding as JEmbedding)
    from analytics_zoo_torch.interop import load_jax_variables
    from analytics_zoo_torch.pipeline.api.keras import Input, Model

    def build(inp, emb, rnn, bidi, dense, model):
        i = inp(shape=(11,))
        h = bidi(rnn(H, return_sequences=False), merge_mode="concat")(
            emb(30, D, init="uniform")(i))
        return model(i, dense(4)(h))
    JLayer.reset_name_counters()
    jm = build(JInput, JEmbedding, jrnn.GRU, jrnn.Bidirectional, JDense,
               JModel)
    TLayer.reset_name_counters()
    tm = build(Input, tl.Embedding, trnn.GRU, trnn.Bidirectional, tl.Dense,
               Model)
    jvars = jax.tree_util.tree_map(np.asarray, jm.get_variables())
    assert sorted(jvars["params"]["bidirectional_1"]) == \
        ["backward", "forward"]
    load_jax_variables(tm, jvars)
    x = np.random.RandomState(6).randint(0, 30, (5, 11))
    want, _ = jm.apply(jm.get_variables()["params"], jnp.asarray(x))
    got, _ = tm.apply(tm.get_variables()["params"], torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_lstm_options_match_reference(f32_both):
    """Any activation pair, positional as Keras-1 passes them, and
    ``unit_forget_bias`` (keyword-only) setting the forget slice to 1."""
    jlayer, tlayer = _pair("LSTM", H, "relu", "hard_sigmoid",
                           return_sequences=True)
    got, want = _forward(jlayer, tlayer, *_build(jlayer, tlayer, 6))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    bias = trnn.LSTM(H, unit_forget_bias=True).init(
        torch.Generator().manual_seed(0), (None, 4, D))["params"]["bias"]
    np.testing.assert_array_equal(
        bias.numpy(), np.r_[np.zeros(H), np.ones(H), np.zeros(2 * H)])
    # the positional slots end at the three regularizers, as in the
    # reference: unit_forget_bias cannot be passed positionally
    with pytest.raises(TypeError):
        trnn.LSTM(H, "tanh", "sigmoid", False, False, "glorot_uniform",
                  "orthogonal", None, None, None, True)


def test_layers_exported_and_shapes():
    assert tl.LSTM is trnn.LSTM and tl.GRU is trnn.GRU
    assert tl.SimpleRNN is trnn.SimpleRNN
    assert tl.Bidirectional is trnn.Bidirectional
    layer = tl.GRU(H)
    params = layer.init(torch.Generator().manual_seed(0),
                        (None, 4, D))["params"]
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        "kernel": (D, 3 * H), "recurrent_kernel": (H, 3 * H),
        "bias": (3 * H,)}
    u = params["recurrent_kernel"]          # orthogonal rows
    np.testing.assert_allclose((u @ u.T).numpy(), np.eye(H), atol=1e-5)
    assert layer.compute_output_shape((None, 4, D)) == (None, H)
    carry = tl.LSTM(H).initial_carry(2)
    assert carry[0] is carry[1] and carry[0].device.type == "cpu"
