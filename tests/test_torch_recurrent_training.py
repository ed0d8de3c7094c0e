"""PyTorch port, training the recurrent models: ``Seq2seq`` (at the
chatbot example's shape, cut to a few units), the lstm and gru
``TextClassifier`` and ``SessionRecommender``, each built in both
packages on the same weights and trained through ``compile``/``fit``
with Adam for two epochs of two steps; the epoch losses, every parameter
and the recurrent carries after training (``Seq2seq.prefill``; for the
classifiers their predictions, which read the last carry) held to the
JAX package's within 1e-4, ROADMAP.md's multi-step float32 tolerance.
Both packages run ``dtype.compute=float32``; the classifier's dropout is
set to 0 (the frameworks draw different masks)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.models.recommendation.session_recommender import (
    SessionRecommender as JSessionRecommender,
)
from analytics_zoo_tpu.models.seq2seq import Seq2seq as JSeq2seq
from analytics_zoo_tpu.models.textclassification.text_classifier import (
    TextClassifier as JTextClassifier,
)
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.models.recommendation import SessionRecommender
from analytics_zoo_torch.models.seq2seq import Seq2seq
from analytics_zoo_torch.models.textclassification import TextClassifier
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer

LOSS = "sparse_categorical_crossentropy_with_logits"
ATOL = 1e-4
N, BATCH, EPOCHS = 16, 8, 2


@pytest.fixture(autouse=True)
def _port_cpu(f32_policy):
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


def _seq2seq_data():
    """examples/chatbot/seq2seq_example.py's reversal dialogue."""
    rs = np.random.RandomState(0)
    src = rs.randint(3, 40, (N, 5)).astype(np.int32)
    tgt = src[:, ::-1].copy()
    dec_in = np.concatenate([np.ones((N, 1), np.int32), tgt[:, :-1]], 1)
    return [src, dec_in], tgt[..., None]


def _classifier_data():
    rs = np.random.RandomState(1)
    return rs.randint(0, 100, (N, 12)), rs.randint(0, 5, (N,))


def _session_data():
    rs = np.random.RandomState(2)
    return ([rs.randint(1, 61, (N, 5)), rs.randint(1, 61, (N, 7))],
            rs.randint(0, 61, (N,)))


TEXT = dict(class_num=5, token_length=16, sequence_length=12,
            encoder_output_dim=24, max_words_num=100)
SESSION = dict(item_count=60, item_embed=8, rnn_hidden_layers=(12, 6),
               session_length=5, mlp_hidden_layers=(10, 6),
               history_length=7, include_history=True)
S2S = dict(vocab_size=40, embed_dim=12, hidden_sizes=(24,), bridge="pass")

MODELS = {
    "seq2seq": (lambda: JSeq2seq(**S2S), lambda: Seq2seq(**S2S),
                _seq2seq_data),
    "lstm": (lambda: JTextClassifier(encoder="lstm", **TEXT),
             lambda: TextClassifier(encoder="lstm", **TEXT),
             _classifier_data),
    "gru": (lambda: JTextClassifier(encoder="gru", **TEXT),
            lambda: TextClassifier(encoder="gru", **TEXT),
            _classifier_data),
    "session": (lambda: JSessionRecommender(**SESSION),
                lambda: SessionRecommender(**SESSION), _session_data),
}


def _net(model):
    return getattr(model, "model", model)


def _zero_dropout(model):
    for layer in _net(model).layers:
        if hasattr(layer, "p"):
            layer.p = 0.0


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree.numpy() if isinstance(tree, torch.Tensor)
                               else tree)}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fit_matches_reference(name):
    jbuild, tbuild, data = MODELS[name]
    JLayer.reset_name_counters()
    jm = jbuild()
    TLayer.reset_name_counters()
    tm = tbuild()
    _zero_dropout(jm)
    _zero_dropout(tm)
    # weights drawn by the port and set into the JAX model (the JAX
    # initializers compile once per parameter shape)
    drawn = _net(tm).init(torch.Generator().manual_seed(0))
    jm.set_variables(jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), drawn))
    jm.compile(jopt.Adam(lr=1e-2), LOSS)
    tm.compile(topt.Adam(lr=1e-2), LOSS)
    x, y = data()
    jhist = jm.fit(x, y, batch_size=BATCH, nb_epoch=EPOCHS)
    thist = tm.fit(x, y, batch_size=BATCH, nb_epoch=EPOCHS, rng=0)
    assert [h["epoch"] for h in thist] == [h["epoch"] for h in jhist] == \
        list(range(1, EPOCHS + 1))
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], atol=ATOL, rtol=0)
    jvars = jax.device_get(jm.get_variables())
    tvars = tm.get_variables()
    jflat, tflat = _flat(jvars["params"]), _flat(tvars["params"])
    assert sorted(jflat) == sorted(tflat)
    moved = 0
    for k in jflat:
        np.testing.assert_allclose(tflat[k], jflat[k], atol=ATOL, rtol=0,
                                   err_msg=k)
        moved += not np.array_equal(tflat[k], _flat(drawn["params"])[k])
    assert moved == len(tflat)            # every leaf trained
    if name == "seq2seq":
        enc = x[0][:4]
        jc = jm.prefill(jvars["params"], jnp.asarray(enc))
        tc = tm.prefill(tvars["params"], torch.from_numpy(enc))
        for (th, tcell), (jh, jcell) in zip(tc, jc):
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL,
                                       rtol=0)
            np.testing.assert_allclose(tcell.numpy(), np.asarray(jcell),
                                       atol=ATOL, rtol=0)
    else:
        np.testing.assert_allclose(
            tm.predict(x, batch_size=BATCH),
            np.asarray(jm.predict(x, batch_size=BATCH)), atol=ATOL, rtol=0)
