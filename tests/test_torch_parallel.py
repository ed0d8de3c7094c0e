"""PyTorch port, the sharded training paths on two gloo ranks against the
JAX package on the same meshes (two of the eight virtual CPU devices).

One two-rank run (``tests/torch_dist_workers.py::scenario_modes``) takes:

- the reference's ``_train_some`` (``tests/test_parallel.py:25-48``): 5
  SGD steps of Dense(256, relu) → Dense(1) on ``{"data": 2}``,
  ``{"fsdp": 2}`` and ``{"model": 2}`` (column then row parallel);
- two steps of Dense → BatchNormalization → Dense on ``{"data": 2}``;
- three steps of MultiHeadSelfAttention → PositionwiseFeedForward under
  ``{"model": 2}`` (tensor parallel) and ``{"seq": 2}`` (ring attention,
  causal).

A four-rank run (``scenario_combos``) takes the same block under two
axes at once, ``data`` with ``model``, ``fsdp`` or ``seq``: there every
process passes the global batch and a rank takes its rows.

Tolerances: one step 1e-6, several steps 1e-4 (ROADMAP ground rules); the
row-parallel sums and the ring's blockwise softmax add in another order
than one device, which the several-step bound covers.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.common.zoo_context import init_zoo_context as jinit
from analytics_zoo_tpu.parallel.mesh import create_mesh as jcreate_mesh
from analytics_zoo_tpu.parallel.trainer import (
    DistributedTrainer as JTrainer)
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
from analytics_zoo_tpu.pipeline.api.keras.layers import (
    BatchNormalization as JBN, Dense as JDense)
from analytics_zoo_tpu.pipeline.api.keras.layers.attention import (
    MultiHeadSelfAttention as JMHSA, PositionwiseFeedForward as JFFN)
from analytics_zoo_tpu.pipeline.api.keras.optimizers import SGD as JSGD

from tests import torch_dist_workers as W


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    codes, outs = W.run_world("modes", 2, tmp_path_factory.mktemp("modes"),
                              timeout=150)
    assert codes == [0, 0], codes
    return outs


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    codes, outs = W.run_world("combos", 4, tmp_path_factory.mktemp("combos"),
                              timeout=150)
    assert codes == [0, 0, 0, 0], codes
    return outs


@pytest.fixture
def jax_mesh(f32_policy):
    ctx = jinit()

    def make(shape):
        n = int(np.prod(list(shape.values())))
        mesh = jcreate_mesh(shape, devices=jax.devices()[:n])
        ctx.mesh = mesh
        return mesh
    return make


def _jax_train(mesh, model, params, x, y, steps, lr=0.05):
    trainer = JTrainer(model, jobj.get("mse"), optim_method=JSGD(lr),
                       mesh=mesh)
    v = model.init(jax.random.PRNGKey(0))
    placed = trainer.place_params(params)
    state = trainer.replicate(v["state"])
    opt_state = trainer.init_opt_state(placed)
    batch = trainer.put_batch((x, y))
    losses = []
    for _ in range(steps):
        placed, opt_state, state, loss = trainer.train_step(
            placed, opt_state, state, batch, jax.random.PRNGKey(1))
        losses.append(float(loss))
    return jax.device_get(placed), jax.device_get(state), losses


def _jax_mlp(mode):
    JLayer.reset_name_counters()
    m = JSequential()
    m.add(JDense(256, activation="relu", input_shape=(16,),
                 parallel_mode="column" if mode == "model" else None))
    m.add(JDense(1, parallel_mode="row" if mode == "model" else None))
    return m


MODES = [("data", {"data": 2}), ("fsdp", {"fsdp": 2}),
         ("model", {"model": 2})]


@pytest.mark.parametrize("mode,shape", MODES, ids=[m for m, _ in MODES])
def test_each_mode_matches_the_jax_run_on_the_same_mesh(ranks, jax_mesh,
                                                        mode, shape):
    mesh = jax_mesh(shape)
    m = _jax_mlp(mode)
    m.init(jax.random.PRNGKey(0))
    names = [l.name for l in m.layers]
    params = {n: {k: jnp.asarray(a) for k, a in w.items()}
              for n, w in zip(names, W.mlp_weights())}
    x, y = W.problem()
    want, _, losses = _jax_train(mesh, m, params, x, y, steps=5, lr=0.02)
    for r in ranks:
        for i, n in enumerate(names):
            for k in ("kernel", "bias"):
                np.testing.assert_allclose(r[f"{mode}_p{i}_{k}"],
                                           np.asarray(want[n][k]),
                                           rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r[f"{mode}_losses"], losses, rtol=1e-4,
                                   atol=1e-6)


def test_dp_fsdp_tp_agree_and_ranks_hold_the_same_params(ranks):
    """``tests/test_parallel.py:51-66``: the three modes take the same
    steps; and the two ranks' gathered params are bit-identical."""
    r0, r1 = ranks
    for key in [k for k in r0 if k.startswith("data_p") and
                "piece" not in k]:
        for mode in ("fsdp", "model"):
            np.testing.assert_allclose(r0[key.replace("data", mode)],
                                       r0[key], rtol=1e-4, atol=1e-5)
    for key in [k for k in r0 if "_p" in k or k.endswith("losses")]:
        if "piece" in key:
            continue
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)


def test_whole_params_loaded_cut_into_pieces_and_gathered_back(ranks):
    """``interop.load_jax_variables`` loads the reference's numpy params
    whole; each rank keeps its pieces (``place_params``) and
    ``fetch_global`` puts them back bit for bit, on every mesh."""
    for r in ranks:
        for mode, _ in MODES:
            assert bool(r[f"{mode}_roundtrip"]), mode


def test_fsdp_really_shards_and_tp_places_the_columns(ranks):
    """Under ``fsdp=2`` the 16 x 256 kernel lives as a 16 x 128 piece on
    each rank (the 256 x 1 kernel is under the 4096-element threshold
    and stays whole); under ``model=2`` the column layer holds its
    columns and the row layer its rows."""
    for r in ranks:
        assert tuple(r["fsdp_piece_dense_1_kernel"]) == (16, 128)
        assert tuple(r["fsdp_piece_dense_2_kernel"]) == (256, 1)
        assert tuple(r["data_piece_dense_1_kernel"]) == (16, 256)
        assert tuple(r["model_piece_dense_1_kernel"]) == (16, 128)
        assert tuple(r["model_piece_dense_1_bias"]) == (128,)
        assert tuple(r["model_piece_dense_2_kernel"]) == (128, 1)
        assert tuple(r["model_piece_dense_2_bias"]) == (1,)
    # the QKV kernel splits by heads: each of q, k, v gives its columns
    whole = W.attn_weights()["mhsa"]["qkv_kernel"]
    for rank, r in enumerate(ranks):
        assert tuple(r["tp_qkv_piece"]) == (16, 24)
        parts = whole.reshape(16, 3, 2, 8)[:, :, rank].reshape(16, 24)
        np.testing.assert_array_equal(r["tp_qkv_piece_values"], parts)


def test_batchnorm_takes_the_global_batch_statistics(ranks, jax_mesh):
    """BN on ``data=2``: each rank normalises with the 64-row batch's
    statistics, as the reference's ``jnp.mean`` over its sharded batch
    does (per-rank statistics would be another model)."""
    mesh = jax_mesh({"data": 2})
    JLayer.reset_name_counters()
    m = JSequential()
    m.add(JDense(8, input_shape=(16,)))
    m.add(JBN(momentum=0.9))
    m.add(JDense(1))
    v = m.init(jax.random.PRNGKey(0))
    names = [l.name for l in m.layers]
    w = W.mlp_weights(16, 8)
    params = {names[0]: w[0], names[1]: v["params"][names[1]],
              names[2]: w[1]}
    x, y = W.problem()
    want, state, losses = _jax_train(mesh, m, params, x, y, steps=2,
                                     lr=0.1)
    for r in ranks:
        np.testing.assert_allclose(r["bn_mean"],
                                   state[names[1]]["moving_mean"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["bn_var"],
                                   state[names[1]]["moving_var"],
                                   rtol=1e-5, atol=1e-6)
        for i, n in enumerate(names):
            for k, a in want[n].items():
                np.testing.assert_allclose(r[f"bn_p{i}_{k}"], a, rtol=1e-4,
                                           atol=1e-5)
        np.testing.assert_allclose(r["bn_loss"], losses[-1], rtol=1e-5)
    # per-rank statistics would differ: the two halves' means are apart
    h = x @ W.mlp_weights(16, 8)[0]["kernel"]
    assert np.abs(h[:32].mean(0) - h[32:].mean(0)).max() > 1e-2


@pytest.mark.parametrize("tag,shape,causal", [
    ("tp", {"model": 2}, False), ("sp", {"seq": 2}, True)])
def test_attention_block_matches_jax_under_tp_and_sp(ranks, jax_mesh, tag,
                                                     shape, causal):
    mesh = jax_mesh(shape)
    JLayer.reset_name_counters()
    m = JSequential()
    m.add(JMHSA(16, 4, causal=causal, input_shape=(8, 16)))
    m.add(JFFN(16, 32))
    m.init(jax.random.PRNGKey(0))
    names = [l.name for l in m.layers]
    w = W.attn_weights()
    params = {names[0]: w["mhsa"], names[1]: w["ffn"]}
    x, y = W.block_problem()
    fwd, _ = m.apply(params, jnp.asarray(x), state={})
    want, _, losses = _jax_train(mesh, m, params, x, y, steps=3, lr=0.1)
    for r in ranks:
        np.testing.assert_allclose(r[f"{tag}_forward"], np.asarray(fwd),
                                   rtol=1e-6, atol=1e-6)
        for i, n in enumerate(names):
            for k, a in want[n].items():
                np.testing.assert_allclose(r[f"{tag}_p{i}_{k}"], a,
                                           rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r[f"{tag}_losses"], losses, rtol=1e-4)


@pytest.mark.parametrize("shape,tag", W.COMBOS, ids=[t for _, t in W.COMBOS])
def test_two_axes_on_four_ranks_match_jax(ranks4, jax_mesh, shape, tag):
    mesh = jax_mesh(shape)
    JLayer.reset_name_counters()
    m = JSequential()
    m.add(JMHSA(16, 4, causal=True, input_shape=(8, 16)))
    m.add(JFFN(16, 32))
    m.init(jax.random.PRNGKey(0))
    names = [l.name for l in m.layers]
    w = W.attn_weights()
    params = {names[0]: w["mhsa"], names[1]: w["ffn"]}
    x, y = W.block_problem()
    want, _, losses = _jax_train(mesh, m, params, x, y, steps=3, lr=0.1)
    for r in ranks4:
        for i, n in enumerate(names):
            for k, a in want[n].items():
                np.testing.assert_allclose(r[f"{tag}_p{i}_{k}"], a,
                                           rtol=1e-4, atol=1e-5)
                np.testing.assert_array_equal(r[f"{tag}_p{i}_{k}"],
                                              ranks4[0][f"{tag}_p{i}_{k}"])
        np.testing.assert_allclose(r[f"{tag}_losses"], losses, rtol=1e-4)
