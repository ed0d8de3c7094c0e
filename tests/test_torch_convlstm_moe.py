"""PyTorch port, ``layers/convlstm.py`` (``ConvLSTM2D``, ``ConvLSTM3D``)
and ``layers/moe.py`` (``MoE``) held to the JAX package on the same
inputs and weights (the JAX layer's, carried across as tensors).

ConvLSTM under float32 products: ``return_sequences``, ``go_backwards``
and ``subsample`` 2 (XLA's SAME split), forward within 1e-6 and gradients
within 1e-6 of their largest magnitude (the convolutions sum in another
order than XLA's).  MoE: top-1 and top-2 routing, a capacity overflow
(tokens dropped as the reference drops them), ties (the first expert),
the auxiliary loss and the gradients, under the float32 policy (1e-6)
and the bf16 policy, where the router and the second expert product
round their result to bf16 as the reference's promotion does: the output
within 1e-6 under both (a float32 product there misses by ~2e-3); the
gradients under bf16 within 4 bf16 ulps of their scale (JAX's backward of
a bf16 product rounds the cotangent products to bf16, the port's backward
of the cast does not)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.ops import dtypes as jdtypes
from analytics_zoo_tpu.pipeline.api.keras.layers import (
    ConvLSTM2D as JConvLSTM2D, ConvLSTM3D as JConvLSTM3D, MoE as JMoE,
)

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.pipeline.api.keras import Sequential
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras.layers import (
    ConvLSTM2D, ConvLSTM3D, Dense, Flatten, MoE,
)
from analytics_zoo_torch.pipeline.api.keras.layers import moe as tmoe

BF16_ULP = 2.0 ** -8


@pytest.fixture(autouse=True)
def _port_cpu():
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    kernels.reset_launch_counts()
    jold = jdtypes.get_policy()
    yield
    assert sum(kernels.launch_counts().values()) == 0
    tdtypes.restore_policy(None)
    jdtypes.restore_policy(jold)
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _policy(compute):
    jdtypes.set_policy(param_dtype="float32", compute_dtype=compute)
    tdtypes.set_policy(param_dtype="float32", compute_dtype=compute)


def _to_torch(params):
    return {k: torch.as_tensor(np.array(v)) for k, v in params.items()}


def _grads_both(jlayer, tlayer, jparams, x, weight, call="call"):
    """Gradients of sum(out * weight) w.r.t. params and input, both
    packages."""
    def jloss(p, xi):
        return jnp.sum(getattr(jlayer, call)(p, xi) * weight)
    jg, jgx = jax.device_get(jax.grad(jloss, argnums=(0, 1))(
        jparams, jnp.asarray(x)))
    tp = {k: v.requires_grad_() for k, v in _to_torch(jparams).items()}
    tx = torch.as_tensor(x).requires_grad_()
    (getattr(tlayer, call)(tp, tx) * torch.as_tensor(weight)).sum() \
        .backward()
    return jg, jgx, {k: v.grad.numpy() for k, v in tp.items()}, \
        tx.grad.numpy()


def _assert_scaled(got, want, rel, what=""):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0,
                               err_msg=what)


# --------------------------------------------------------------- ConvLSTM
CONV_CASES = [
    (2, False, False, 1), (2, True, False, 1), (2, True, True, 1),
    (2, False, True, 2), (2, True, False, 2), (3, True, True, 1),
    (3, False, False, 2)]


@pytest.mark.parametrize("spatial,seqs,backwards,sub", CONV_CASES)
def test_convlstm_matches_the_reference(spatial, seqs, backwards, sub):
    _policy("float32")
    jcls, tcls = ((JConvLSTM2D, ConvLSTM2D) if spatial == 2
                  else (JConvLSTM3D, ConvLSTM3D))
    size = (7, 6) if spatial == 2 else (5, 4, 3)
    shape = (None, 4) + size + (3,)
    kw = dict(return_sequences=seqs, go_backwards=backwards, subsample=sub)
    jl, tl = jcls(5, 3, **kw), tcls(5, 3, **kw)
    jparams = jax.device_get(jl.init(jax.random.PRNGKey(spatial),
                                     shape)["params"])
    assert tl.compute_output_shape(shape) == jl.compute_output_shape(shape)
    own = tl.init(torch.Generator().manual_seed(0), shape)["params"]
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in jparams.items()}
    # the recurrent kernel is orthogonal over its flattened rows
    u = own["recurrent_kernel"].reshape(-1, 20)
    np.testing.assert_allclose((u.T @ u).numpy(), np.eye(20), atol=1e-5)
    x = np.random.RandomState(1).randn(2, *shape[1:]).astype(np.float32)
    want = np.asarray(jl.call(jparams, jnp.asarray(x)))
    got = tl.call(_to_torch(jparams), torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (2,) + tuple(
        tl.compute_output_shape(shape)[1:])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    weight = np.random.RandomState(2).randn(*want.shape).astype(np.float32)
    jg, jgx, tg, tgx = _grads_both(jl, tl, jparams, x, weight)
    for k in jg:
        _assert_scaled(tg[k], jg[k], 1e-6, k)
    _assert_scaled(tgx, jgx, 1e-6, "input")


def test_convlstm_trains_in_a_sequential():
    _policy("float32")
    seq = Sequential()
    seq.add(ConvLSTM2D(4, 3, return_sequences=True,
                       input_shape=(3, 6, 6, 2)))
    seq.add(ConvLSTM2D(4, 3, subsample=2))
    seq.add(Flatten())
    seq.add(Dense(1))
    assert seq.get_output_shape() == (None, 1)
    rs = np.random.RandomState(3)
    x = rs.randn(32, 3, 6, 6, 2).astype(np.float32)
    y = x.mean(axis=(1, 2, 3, 4))[:, None] * 4
    seq.compile(topt.Adam(lr=1e-2), "mse")
    hist = seq.fit(x, y, batch_size=8, nb_epoch=4, shuffle=False)
    assert hist[-1]["loss"] < hist[0]["loss"]


# -------------------------------------------------------------------- MoE
def _moe_pair(e, k, cf, d=6, h=8, seed=0, activation="relu"):
    jl = JMoE(num_experts=e, hidden_dim=h, top_k=k, capacity_factor=cf,
              activation=activation)
    tl = MoE(num_experts=e, hidden_dim=h, top_k=k, capacity_factor=cf,
             activation=activation)
    params = jax.device_get(jl.init(jax.random.PRNGKey(seed),
                                    (None, d))["params"])
    # the reference initialises the biases at zero: move them so that
    # they enter the comparison
    rs = np.random.RandomState(seed + 100)
    params = dict(params)
    params["b1"] = rs.randn(e, h).astype(np.float32) * 0.1
    params["b2"] = rs.randn(e, d).astype(np.float32) * 0.1
    return jl, tl, params


MOE_CASES = [(4, 1, 4.0), (4, 2, 4.0), (4, 1, 0.5), (3, 2, 0.6),
             (8, 1, 1.25)]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,k,cf", MOE_CASES)
def test_moe_matches_the_reference(compute, e, k, cf):
    _policy(compute)
    jl, tl, params = _moe_pair(e, k, cf)
    x = np.random.RandomState(e * 10 + k).randn(3, 8, 6).astype(np.float32)
    jy, jaux = jl.call_with_aux(params, jnp.asarray(x))
    ty, taux = tl.call_with_aux(_to_torch(params), torch.as_tensor(x))
    jy, jaux = np.asarray(jy), float(jaux)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    # the same roundings in the same places: 1e-6 under either policy
    _assert_scaled(ty.numpy(), jy, 1e-6)
    tol = 1e-6 if compute == "float32" else 4 * BF16_ULP
    np.testing.assert_allclose(float(taux), jaux, atol=1e-6)
    assert float(tl.aux_loss()) == float(taux)
    # which tokens were dropped: an output row of exactly zero bias-free
    # contribution is the same set in both packages
    tokens = x.reshape(-1, 6)
    jcomb, _ = jl._route(jax.nn.softmax(
        jnp.asarray(tokens) @ params["router"]), len(tokens))
    tcomb, _ = tl._route(torch.softmax(
        torch.as_tensor(tokens) @ torch.as_tensor(np.array(params["router"])),
        dim=-1), len(tokens))
    np.testing.assert_array_equal(np.asarray(jcomb) > 0,
                                  tcomb.numpy() > 0)
    if cf < 1:     # capacity overflow: some token is dropped
        kept = (tcomb.numpy() > 0).sum(axis=(1, 2))
        assert (kept < k).any()
    weight = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    jg, jgx, tg, tgx = _grads_both(jl, tl, params, x, weight)
    for name in jg:
        _assert_scaled(tg[name], jg[name], tol, name)
    _assert_scaled(tgx, jgx, tol, "input")


@pytest.mark.parametrize("k", [1, 2])
def test_moe_ties_go_to_the_first_expert_and_overflow_drops(k):
    """A zero router gives every expert the same probability: ties go to
    expert 0 (then 1 for the second choice), which takes ``capacity``
    tokens; the rest are dropped, as in the reference."""
    _policy("float32")
    jl, tl, params = _moe_pair(4, k, 1.0)
    params["router"] = np.zeros_like(params["router"])
    x = np.random.RandomState(6).randn(12, 6).astype(np.float32)
    jy = np.asarray(jl.call(params, jnp.asarray(x)))
    ty = tl.call(_to_torch(params), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(ty, jy, atol=1e-6)
    cap = tl._capacity(12)
    assert cap == int(np.ceil(12 * k / 4))
    probs = torch.full((12, 4), 0.25)
    comb, aux = tl._route(probs, 12)
    used = comb.numpy() > 0
    assert used[:, 0].sum() == cap and used[:, 2:].sum() == 0
    assert used[:, 1].sum() == (cap if k == 2 else 0)
    np.testing.assert_array_equal(ty[cap:], 0.0)   # dropped tokens
    assert float(aux) == pytest.approx(4 * 0.25)


def test_moe_aux_drives_training_and_the_axis_name():
    _policy("float32")
    assert tmoe.EXPERT_AXIS == "expert"
    with pytest.raises(ValueError, match="top_k"):
        MoE(4, 8, top_k=3)
    layer = MoE(4, 8, top_k=1)
    with pytest.raises(ValueError, match="no forward"):
        layer.aux_loss()
    params = layer.init(torch.Generator().manual_seed(0), (None, 6))[
        "params"]
    live = {k: v.requires_grad_() for k, v in params.items()}
    x = torch.randn(16, 6, generator=torch.Generator().manual_seed(1))
    y, aux = layer.call_with_aux(live, x)
    (y.square().mean() + 1e-2 * aux).backward()
    assert float(live["router"].grad.abs().sum()) > 0
    assert layer.compute_output_shape((None, 7, 6)) == (None, 7, 6)
