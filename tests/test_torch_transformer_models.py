"""PyTorch port, the Keras transformer models: ``BERT`` and the GPT-style
``TransformerLayer`` (2 blocks, width 32, 4 heads) against the JAX
package's on the same weights (exported through
``interop.load_jax_variables``) and seeded numpy inputs, under a float32
policy in both packages: outputs within 1e-5; ``TimeDistributed`` and
``KerasLayerWrapper``; the shared embedding's single entry and its
gradient, the sum of both uses' (within 1e-5 of ``jax.grad``);
causality; and three training steps of a GPT-style token model with the
losses within 1e-4 (several float32 steps), then ``fit``/``evaluate``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.parallel.trainer import DistributedTrainer as JTrainer
from analytics_zoo_tpu.pipeline.api.keras import Model as JModel
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.parallel.trainer import (
    DistributedTrainer, step_generator,
)
from analytics_zoo_torch.pipeline.api.keras import Model
from analytics_zoo_torch.pipeline.api.keras import layers as TL
from analytics_zoo_torch.pipeline.api.keras import objectives as tobj
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer

OUT_ATOL = 1e-5
LOSS_ATOL = 1e-4
LOSS = "sparse_categorical_crossentropy_with_logits"
WIDTH = dict(n_block=2, n_head=4, hidden_size=32)
T, TOKENS = 16, 50           # sequence length, token vocabulary


@pytest.fixture(autouse=True)
def _port_f32(f32_policy):
    """The port on the CPU with a float32 policy (the JAX side gets the
    same from the conftest's f32_policy)."""
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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _both(build):
    """``build(layers, Model)`` in each package, the port loaded with the
    JAX model's weights."""
    JLayer.reset_name_counters()
    jmodel = build(JL, JModel)
    TLayer.reset_name_counters()
    tmodel = build(TL, Model)
    load_jax_variables(tmodel, _np(jmodel.get_variables()))
    return jmodel, tmodel


def _apply_both(jmodel, tmodel, inputs):
    jout, _ = jmodel.apply(jmodel.get_variables()["params"],
                           [jnp.asarray(a) for a in inputs], state={},
                           training=False)
    tout, _ = tmodel.apply(tmodel.get_variables()["params"],
                           [torch.from_numpy(a) for a in inputs], state={},
                           training=False)
    return jout, tout


def _assert_outputs_close(jout, tout):
    jout = jout if isinstance(jout, (list, tuple)) else [jout]
    tout = tout if isinstance(tout, (list, tuple)) else [tout]
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=OUT_ATOL, rtol=OUT_ATOL)


def _bert_inputs(n=3, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, TOKENS, (n, T))
    seg = (np.arange(T) >= T // 2).astype(np.int64)[None].repeat(n, 0)
    pos = np.arange(T)[None].repeat(n, 0)
    mask = np.ones((n, T), np.int64)
    mask[0, T - 5:] = 0                 # a padded row
    return [ids, seg, pos, mask]


def _gpt_inputs(n=3, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, TOKENS, (n, T))
    pos = np.arange(TOKENS, TOKENS + T)[None].repeat(n, 0)
    return [ids, pos]


@pytest.mark.parametrize("hidden_act", ["gelu", "gelu_erf"])
def test_bert_outputs_match_reference(hidden_act):
    def build(L, M):
        return L.BERT(vocab=TOKENS, seq_len=T, intermediate_size=64,
                      max_position_len=T, hidden_drop=0.0, attn_drop=0.0,
                      hidden_act=hidden_act, **WIDTH).build()
    jmodel, tmodel = _both(build)
    assert [l.name for l in tmodel.layers] == [l.name for l in jmodel.layers]
    jout, tout = _apply_both(jmodel, tmodel, _bert_inputs())
    assert [tuple(o.shape) for o in tout] == [(3, T, 32), (3, 32)]
    _assert_outputs_close(jout, tout)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_transformer_layer_outputs_match_reference(bidirectional):
    def build(L, M):
        return L.TransformerLayer.init_with_default_embedding(
            vocab=TOKENS + T, seq_len=T, hidden_drop=0.0, attn_drop=0.0,
            bidirectional=bidirectional, **WIDTH).build()
    jmodel, tmodel = _both(build)
    jout, tout = _apply_both(jmodel, tmodel, _gpt_inputs())
    _assert_outputs_close(jout, tout)
    attn = [l for l in tmodel.layers
            if isinstance(l, TL.MultiHeadSelfAttention)]
    assert len(attn) == 2 and all(l.causal != bidirectional for l in attn)


def test_transformer_layer_defaults_are_the_reference_defaults():
    jl = JL.TransformerLayer.init_with_default_embedding()
    tl = TL.TransformerLayer.init_with_default_embedding()
    assert tl.cfg == jl.cfg
    assert tl.cfg["intermediate_size"] == 3072 and tl.cfg["seq_len"] == 77
    assert TL.BERT().cfg == JL.BERT().cfg


def test_causal_mask_applied():
    """Unidirectional: changing a later token leaves the first position's
    state unchanged and moves the last one's."""
    TLayer.reset_name_counters()
    model = TL.TransformerLayer(n_block=1, n_head=2, vocab=50, seq_len=6,
                                hidden_size=8, bidirectional=False).build()
    params = model.init()["params"]
    pos = torch.arange(44, 50)[None]
    ids1 = torch.tensor([[1, 2, 3, 4, 5, 6]])
    ids2 = torch.tensor([[1, 2, 3, 4, 5, 7]])
    (s1, _), _ = model.apply(params, [ids1, pos], state={}, training=False)
    (s2, _), _ = model.apply(params, [ids2, pos], state={}, training=False)
    np.testing.assert_allclose(s1[0, 0].numpy(), s2[0, 0].numpy(),
                               atol=1e-6)
    assert not np.allclose(s1[0, -1].numpy(), s2[0, -1].numpy())


def _gpt_tokens(L, M):
    """TransformerLayer with a time-distributed token head over its
    sequence output."""
    enc = L.TransformerLayer.init_with_default_embedding(
        vocab=TOKENS + T, seq_len=T, hidden_drop=0.0, attn_drop=0.0,
        **WIDTH).build()
    logits = L.TimeDistributed(L.Dense(TOKENS))(enc.outputs[0])
    return M(enc.inputs, logits)


def test_shared_embedding_has_one_entry_and_a_summed_gradient():
    jmodel, tmodel = _both(_gpt_tokens)
    params = tmodel.get_variables()["params"]
    embeds = [l for l in tmodel.layers if isinstance(l, TL.Embedding)]
    assert len(embeds) == 1 and embeds[0].name in params
    assert sum(len(n.inbound) for n in embeds[0]._nodes) == 2
    assert sorted(params) == sorted(jmodel.get_variables()["params"])
    ids, pos = _gpt_inputs(4, seed=1)
    y = np.random.RandomState(2).randint(0, TOKENS, (4, T))

    jp = jmodel.get_variables()["params"]
    jgrad = jax.grad(lambda p: jobj.get(LOSS)(jnp.asarray(y), jmodel.apply(
        p, [jnp.asarray(ids), jnp.asarray(pos)], state={},
        training=False)[0]))(jp)
    tr = DistributedTrainer(tmodel, tobj.get(LOSS))
    _, tgrad, _ = tr.loss_and_grads(
        params, {}, tr.put_batch(([ids, pos], y)), None)
    name = embeds[0].name
    got = tgrad[name]["embeddings"].numpy()
    np.testing.assert_allclose(got, np.asarray(jgrad[name]["embeddings"]),
                               atol=OUT_ATOL, rtol=0)
    # both uses reach the one table (jax.grad sums a shared parameter's
    # uses): the token rows and every position row
    assert np.abs(got[:TOKENS]).sum() > 0
    assert (np.abs(got[TOKENS:]).sum(-1) > 0).all()


@pytest.mark.parametrize("inner", ["dense", "bilstm"])
def test_time_distributed_matches_reference(inner):
    rs = np.random.RandomState(4)
    if inner == "dense":
        x = rs.randn(3, 5, 7).astype(np.float32)

        def make(L):
            return L.TimeDistributed(L.Dense(6, activation="softmax"))
    else:
        x = rs.randn(2, 4, 6, 3).astype(np.float32)

        def make(L):
            return L.TimeDistributed(L.Bidirectional(
                L.LSTM(5, return_sequences=False)))
    JLayer.reset_name_counters()
    jlayer = make(JL)
    TLayer.reset_name_counters()
    tlayer = make(TL)
    shape = x.shape[1:]
    jparams = jlayer.init(jax.random.PRNGKey(0), shape)["params"]
    tparams = tlayer.init(torch.Generator().manual_seed(0), shape)["params"]
    assert jax.tree_util.tree_structure(jparams) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda t: 0, tparams))
    tparams = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), _np(jparams))
    want, _ = jlayer.apply(jparams, jnp.asarray(x))
    got, _ = tlayer.apply(tparams, torch.from_numpy(x))
    assert tuple(got.shape) == tuple(want.shape) == tuple(
        (x.shape[0],) + tuple(tlayer.compute_output_shape(
            (None,) + shape)[1:]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=OUT_ATOL, rtol=OUT_ATOL)


def test_keras_layer_wrapper():
    def build(rng, shape):
        return {"w": torch.full((shape[-1],), 2.0)}
    layer = TL.KerasLayerWrapper(lambda p, x: x * p["w"], build_fn=build,
                                 output_shape_fn=lambda s: s)
    params = layer.init(torch.Generator().manual_seed(0), (3,))["params"]
    x = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(layer.call(params, x).numpy(),
                                  (x * 2).numpy())
    assert layer.compute_output_shape((None, 3)) == (None, 3)
    assert TL.KerasLayerWrapper(lambda p, x: x).init(
        torch.Generator(), (3,))["params"] == {}


def test_train_steps_and_fit_match_reference():
    """Three Adam steps of the GPT-style token model in both packages
    from the same weights and batches: each step's loss within 1e-4; then
    ``fit`` for an epoch of three steps and ``evaluate``."""
    jmodel, tmodel = _both(_gpt_tokens)
    rs = np.random.RandomState(7)
    ids = rs.randint(0, TOKENS, (24, T))
    pos = np.arange(TOKENS, TOKENS + T)[None].repeat(24, 0)
    y = np.roll(ids, -1, axis=1)            # next-token targets
    jtr = JTrainer(jmodel, jobj.get(LOSS), optim_method=jopt.Adam(lr=1e-3))
    ttr = DistributedTrainer(tmodel, tobj.get(LOSS),
                             optim_method=topt.Adam(lr=1e-3))
    jv, tv = jmodel.get_variables(), tmodel.get_variables()
    jp, js = jtr.place_params(jv["params"]), jtr.replicate(jv["state"])
    jo = jtr.init_opt_state(jp)
    tp, ts = ttr.place_params(tv["params"]), ttr.replicate(tv["state"])
    to = ttr.init_opt_state(tp)
    for i in range(3):
        sl = slice(8 * i, 8 * i + 8)
        batch = ([ids[sl], pos[sl]], y[sl])
        jp, jo, js, jloss = jtr.train_step(
            jp, jo, js, jtr.put_batch(batch),
            jax.random.fold_in(jax.random.PRNGKey(0), i))
        tp, to, ts, tloss = ttr.train_step(
            tp, to, ts, ttr.put_batch(batch), step_generator(0, i, "cpu"))
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   atol=LOSS_ATOL, rtol=0)

    for model, opt in ((jmodel, jopt), (tmodel, topt)):
        model.compile(opt.Adam(lr=1e-3), LOSS)
    jhist = jmodel.fit([ids, pos], y, batch_size=8, nb_epoch=1)
    thist = tmodel.fit([ids, pos], y, batch_size=8, nb_epoch=1)
    np.testing.assert_allclose(thist[0]["loss"], jhist[0]["loss"],
                               atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(
        tmodel.evaluate([ids, pos], y, batch_size=8)["loss"],
        jmodel.evaluate([ids, pos], y, batch_size=8)["loss"],
        atol=LOSS_ATOL, rtol=0)
