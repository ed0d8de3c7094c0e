"""PyTorch port, the TFPark text models: ``BERTClassifier``, ``BERTNER``
and ``BERTSQuAD`` (``train``/``evaluate``/``predict``/``predict_spans``)
against the JAX package's at a tiny width, from the same weights and
seeded inputs (predictions within 1e-5; after training under
AdamWeightDecay, params, losses and predictions within 1e-4: several
float32 steps); ``load_bert_checkpoint`` from a ``transformers.BertModel``
(against its forward, 1e-4 as ``tests/test_bert_checkpoint.py`` holds the
JAX package) and from a plain seeded state_dict (every leaf bit-identical
to the JAX package's import and to its source); ``_google_reader`` and
``BERTClassifier(bert_checkpoint=)`` on a TF checkpoint written here; and
``NER``, ``SequenceTagger`` and ``IntentEntity`` against the reference
(predictions within 1e-5, a ``fit`` epoch's loss within 1e-4)."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
from analytics_zoo_tpu.tfpark import text as jtext
from analytics_zoo_tpu.tfpark.text import bert_checkpoint as jbc

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.tfpark import text as ttext
from analytics_zoo_torch.tfpark.text import bert_checkpoint as tbc

OUT_ATOL = 1e-5
TRAIN_ATOL = 1e-4
HF_ATOL = 1e-4
HID, HEADS, BLOCKS, VOCAB, SEQ, INTER = 32, 4, 2, 60, 16, 64
TINY = dict(vocab=VOCAB, hidden_size=HID, n_block=BLOCKS, n_head=HEADS,
            seq_len=SEQ, intermediate_size=INTER, max_position_len=SEQ,
            hidden_drop=0.0, attn_drop=0.0)


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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _both(make):
    """``make(text_module)`` in each package, the port's model loaded
    with the JAX model's weights (and its encoder's copies synced)."""
    JLayer.reset_name_counters()
    jest = make(jtext)
    TLayer.reset_name_counters()
    test = make(ttext)
    load_jax_variables(test.model, _np(jest.model.get_variables()))
    if test.encoder is not test.model:
        load_jax_variables(test.encoder, _np(jest.encoder.get_variables()))
    return jest, test


def _features(n=16, seed=0):
    rs = np.random.RandomState(seed)
    mask = np.ones((n, SEQ), np.int64)
    mask[::3, SEQ - 4:] = 0
    return {"input_ids": rs.randint(0, VOCAB, (n, SEQ)),
            "token_type_ids": (np.arange(SEQ) >= SEQ // 2).astype(
                np.int64)[None].repeat(n, 0),
            "attention_mask": mask}


def _assert_close(got, want, atol):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, w, atol)
        return
    assert np.shape(got) == np.shape(want)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _assert_params_close(tmodel, jmodel, atol):
    jp = _np(jmodel.get_variables()["params"])
    tp = tmodel.get_variables()["params"]
    assert sorted(tp) == sorted(jp)
    for layer in sorted(jp):
        for key in sorted(jp[layer]):
            np.testing.assert_allclose(
                tp[layer][key].numpy(), jp[layer][key], atol=atol, rtol=0,
                err_msg=f"{layer}/{key}")


def _adamw(m):
    return m.AdamWeightDecay(lr=1e-3, warmup_portion=0.5, total=2)


# (name, estimator, labels of n rows, loss for the base train)
HEADS_ = {
    "classifier": (lambda m: m.BERTClassifier(num_classes=3, dropout=0.0,
                                              **TINY),
                   lambda rs, n: rs.randint(0, 3, (n,))),
    "ner": (lambda m: m.BERTNER(num_entities=5, dropout=0.0, **TINY),
            lambda rs, n: rs.randint(0, 5, (n, SEQ))),
    "squad": (lambda m: m.BERTSQuAD(**TINY),
              lambda rs, n: rs.randn(n, SEQ, 2).astype(np.float32)),
}


@pytest.mark.parametrize("head", sorted(HEADS_))
def test_estimator_matches_reference(head):
    make, labels_of = HEADS_[head]
    jest, test = _both(make)
    feats = _features()
    labels = labels_of(np.random.RandomState(1), 16)
    _assert_close(test.predict(feats, batch_size=4),
                  jest.predict(feats, batch_size=4), OUT_ATOL)
    if head == "squad":
        ts, te = test.predict_spans(feats, batch_size=8)
        js, je = jest.predict_spans(feats, batch_size=8)
        assert ts.shape == te.shape == (16, SEQ)
        _assert_close(ts, js, OUT_ATOL)
        _assert_close(te, je, OUT_ATOL)
        train = dict(loss="mse")
    else:
        train = {}
    jest.train(feats, labels, optim_method=_adamw(jopt), batch_size=8,
               **train)
    test.train(feats, labels, optim_method=_adamw(topt), batch_size=8,
               **train)
    _assert_params_close(test.model, jest.model, TRAIN_ATOL)
    _assert_close(test.predict(feats), jest.predict(feats), TRAIN_ATOL)
    tscores = test.evaluate(feats, labels, batch_size=8)
    jscores = jest.evaluate(feats, labels, batch_size=8)
    assert set(tscores) == set(jscores) == {"loss"}
    np.testing.assert_allclose(tscores["loss"], jscores["loss"],
                               atol=TRAIN_ATOL, rtol=0)


def test_base_estimator_serves_both_outputs_and_trains_under_adamw():
    """The feature-extraction base predicts [sequence, pooled]; the
    classifier's default optimizer is AdamWeightDecay(lr=2e-5), which the
    trainer runs unfused, as the reference does: every leaf moves."""
    jest, test = _both(lambda m: m.BERTBaseEstimator(**TINY))
    feats = _features(8)
    got = test.predict(feats, batch_size=4)
    assert [g.shape for g in got] == [(8, SEQ, HID), (8, HID)]
    _assert_close(got, jest.predict(feats, batch_size=4), OUT_ATOL)

    TLayer.reset_name_counters()
    clf = ttext.BERTClassifier(num_classes=2, **TINY)
    before = clf.model.get_weights()
    clf.train(feats, np.arange(8) % 2, batch_size=8)
    assert type(clf.model.optim_method).__name__ == "AdamWeightDecay"
    after = clf.model.get_weights()
    assert all(not np.array_equal(a, b) for a, b in zip(before, after))


# --------------------------------------------------- checkpoint import
def _hf_state(seed=11):
    """A seeded state_dict under the HF names _hf_reader reads."""
    rs = np.random.RandomState(seed)
    shapes = {
        "embeddings.word_embeddings.weight": (VOCAB, HID),
        "embeddings.token_type_embeddings.weight": (2, HID),
        "embeddings.position_embeddings.weight": (SEQ + 8, HID),
        "embeddings.LayerNorm.weight": (HID,),
        "embeddings.LayerNorm.bias": (HID,),
        "pooler.dense.weight": (HID, HID), "pooler.dense.bias": (HID,)}
    for i in range(BLOCKS):
        h = f"encoder.layer.{i}"
        for w in ("query", "key", "value"):
            shapes[f"{h}.attention.self.{w}.weight"] = (HID, HID)
            shapes[f"{h}.attention.self.{w}.bias"] = (HID,)
        shapes[f"{h}.attention.output.dense.weight"] = (HID, HID)
        shapes[f"{h}.attention.output.dense.bias"] = (HID,)
        shapes[f"{h}.attention.output.LayerNorm.weight"] = (HID,)
        shapes[f"{h}.attention.output.LayerNorm.bias"] = (HID,)
        shapes[f"{h}.intermediate.dense.weight"] = (INTER, HID)
        shapes[f"{h}.intermediate.dense.bias"] = (INTER,)
        shapes[f"{h}.output.dense.weight"] = (HID, INTER)
        shapes[f"{h}.output.dense.bias"] = (HID,)
        shapes[f"{h}.output.LayerNorm.weight"] = (HID,)
        shapes[f"{h}.output.LayerNorm.bias"] = (HID,)
    return {k: (rs.randn(*s) * 0.2).astype(np.float32)
            for k, s in shapes.items()}


def _native(module, **kw):
    return module.BERT(**dict(TINY, hidden_act="gelu_erf", **kw)).build()


@pytest.mark.parametrize("prefixed", [False, True])
def test_state_dict_import_is_bit_identical(prefixed):
    sd = _hf_state()
    src = {("bert." + k if prefixed else k): v for k, v in sd.items()}
    from analytics_zoo_tpu.pipeline.api.keras.layers import attention as ja
    from analytics_zoo_torch.pipeline.api.keras.layers import attention as ta
    JLayer.reset_name_counters()
    jmodel = _native(ja)
    jbc.load_bert_checkpoint(jmodel, src)
    TLayer.reset_name_counters()
    tmodel = _native(ta)
    tbc.load_bert_checkpoint(
        tmodel, {k: torch.from_numpy(v) for k, v in src.items()})
    jp = _np(jmodel.get_variables()["params"])
    tp = tmodel.get_variables()["params"]
    for layer in sorted(jp):
        for key in sorted(jp[layer]):
            np.testing.assert_array_equal(tp[layer][key].numpy(),
                                          jp[layer][key])
    # the sources: kernels transposed, Q/K/V fused, positions sliced
    attn = [l for l in tmodel.layers
            if isinstance(l, ta.MultiHeadSelfAttention)][0]
    np.testing.assert_array_equal(
        tp[attn.name]["qkv_kernel"][:, HID:2 * HID].numpy(),
        sd["encoder.layer.0.attention.self.key.weight"].T)
    pos = [l for l in tmodel.layers if type(l).__name__ == "Embedding"][2]
    np.testing.assert_array_equal(
        tp[pos.name]["embeddings"].numpy(),
        sd["embeddings.position_embeddings.weight"][:SEQ])
    ids = _features(4)
    inputs = [ids["input_ids"], ids["token_type_ids"],
              np.arange(SEQ)[None].repeat(4, 0), ids["attention_mask"]]
    _assert_close(tmodel.predict(inputs), jmodel.predict(inputs), OUT_ATOL)
    bad = dict(sd)
    bad["embeddings.word_embeddings.weight"] = np.zeros((VOCAB + 1, HID),
                                                        np.float32)
    with pytest.raises(ValueError, match="checkpoint shape"):
        tbc.load_bert_checkpoint(tmodel, bad)


def _hf_model(transformers):
    cfg = transformers.BertConfig(
        vocab_size=VOCAB, hidden_size=HID, num_hidden_layers=BLOCKS,
        num_attention_heads=HEADS, intermediate_size=INTER,
        max_position_embeddings=SEQ + 8, type_vocab_size=2,
        hidden_act="gelu", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, layer_norm_eps=1e-12)
    torch.manual_seed(11)
    return transformers.BertModel(cfg).eval()


def _hf_forward(hf, feats):
    with torch.no_grad():
        out = hf(**{k: torch.from_numpy(v) for k, v in feats.items()})
    return out.last_hidden_state.numpy(), out.pooler_output.numpy()


def _unpadded(feats):
    """Rows whose tokens all count: a padded token's own state is not
    meaningful output (HF's mask differs there)."""
    return feats["attention_mask"].all(-1)


def test_import_from_transformers_matches_its_forward():
    transformers = pytest.importorskip("transformers")
    hf = _hf_model(transformers)
    from analytics_zoo_torch.pipeline.api.keras.layers import attention as ta
    TLayer.reset_name_counters()
    model = _native(ta)
    tbc.load_bert_checkpoint(model, hf)
    feats = _features(6, seed=3)
    seq, pooled = model.predict(
        [feats["input_ids"], feats["token_type_ids"],
         np.arange(SEQ)[None].repeat(6, 0), feats["attention_mask"]])
    want_seq, want_pool = _hf_forward(hf, feats)
    keep = _unpadded(feats)
    np.testing.assert_allclose(seq[keep], want_seq[keep], atol=HF_ATOL,
                               rtol=HF_ATOL)
    np.testing.assert_allclose(pooled, want_pool, atol=HF_ATOL,
                               rtol=HF_ATOL)


def _save_google_ckpt(tf, sd, out_dir):
    """The state_dict under google's variable names as a TF checkpoint
    beside its bert_config.json."""
    g = {}
    for name in [n for n in tbc._G2HF] + [
            f"bert/encoder/layer_{i}/{tail}" for i in range(BLOCKS)
            for tail in tbc._BLOCK_G2HF]:
        arr = sd[tbc.hf_name(name)]
        g[name] = arr.T if name.endswith("/kernel") else arr
    saver = tf.compat.v1.train.Saver(
        {name: tf.Variable(val) for name, val in g.items()})
    saver.save(None, os.path.join(out_dir, "bert_model.ckpt"))
    with open(os.path.join(out_dir, "bert_config.json"), "w") as f:
        json.dump({"vocab_size": VOCAB, "hidden_size": HID,
                   "num_hidden_layers": BLOCKS,
                   "num_attention_heads": HEADS,
                   "intermediate_size": INTER,
                   "max_position_embeddings": SEQ + 8,
                   "type_vocab_size": 2, "hidden_act": "gelu",
                   "hidden_dropout_prob": 0.0,
                   "attention_probs_dropout_prob": 0.0}, f)
    return g


def test_google_checkpoint_through_bert_classifier(tmp_path):
    """``_google_reader`` reads every variable as written, and
    ``BERTClassifier(bert_checkpoint=dir)`` configures its encoder from
    bert_config.json, loads the weights into the head model and syncs the
    encoder's copies: the same leaves as the state_dict import."""
    tf = pytest.importorskip("tensorflow")
    sd = _hf_state(seed=4)
    g = _save_google_ckpt(tf, sd, str(tmp_path))
    get = tbc._google_reader(str(tmp_path))
    for name, arr in g.items():
        np.testing.assert_array_equal(get(name), arr)
    assert tbc.bert_kwargs_from_config(
        str(tmp_path / "bert_config.json"))["hidden_act"] == "gelu_erf"

    TLayer.reset_name_counters()
    clf = ttext.BERTClassifier(num_classes=3, dropout=0.0,
                               bert_checkpoint=str(tmp_path), seq_len=SEQ)
    assert clf.cfg["n_block"] == BLOCKS and clf.cfg["vocab"] == VOCAB
    from analytics_zoo_torch.pipeline.api.keras.layers import attention as ta
    TLayer.reset_name_counters()
    ref = ta.BERT(**dict(tbc.bert_kwargs_from_config(
        str(tmp_path / "bert_config.json")), seq_len=SEQ)).build()
    tbc.load_bert_checkpoint(ref, sd)
    rp = ref.get_variables()["params"]
    ep = clf.encoder.get_variables()["params"]
    mp = clf.model.get_variables()["params"]
    assert sorted(ep) == sorted(rp)
    for layer in rp:
        for key in rp[layer]:
            np.testing.assert_array_equal(ep[layer][key].numpy(),
                                          rp[layer][key].numpy())
            assert ep[layer][key] is mp[layer][key]
    feats = _features(8)
    first = clf.predict(feats)
    clf.train(feats, np.arange(8) % 3, batch_size=8)
    assert first.shape == clf.predict(feats).shape == (8, 3)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no TF checkpoint"):
        tbc._google_reader(str(tmp_path / "empty"))


# ----------------------------------------------- the Keras text models
TEXT_MODELS = {
    "ner": lambda m: m.NER(num_entities=5, word_vocab_size=40,
                           char_vocab_size=20, word_length=5, seq_len=6,
                           word_emb_dim=8, char_emb_dim=4,
                           tagger_lstm_dim=6, dropout=0.0),
    "sequence_tagger": lambda m: m.SequenceTagger(
        num_pos_labels=4, num_chunk_labels=3, word_vocab_size=40,
        char_vocab_size=20, word_length=5, feature_size=8, seq_len=6,
        dropout=0.0),
    "sequence_tagger_words": lambda m: m.SequenceTagger(
        num_pos_labels=4, num_chunk_labels=3, word_vocab_size=40,
        feature_size=8, seq_len=6, dropout=0.0),
    "intent_entity": lambda m: m.IntentEntity(
        num_intents=3, num_entities=4, word_vocab_size=40,
        char_vocab_size=20, word_length=5, seq_len=6, token_emb_size=8,
        char_emb_size=4, tagger_lstm_dim=6, dropout=0.0),
}


@pytest.mark.parametrize("name", sorted(TEXT_MODELS))
def test_text_keras_model_matches_reference(name):
    JLayer.reset_name_counters()
    jm = TEXT_MODELS[name](jtext)
    TLayer.reset_name_counters()
    tm = TEXT_MODELS[name](ttext)
    load_jax_variables(tm.model, _np(jm.model.get_variables()))
    rs = np.random.RandomState(6)
    words = rs.randint(0, 40, (16, 6))
    x = words if name == "sequence_tagger_words" else \
        [words, rs.randint(0, 20, (16, 6, 5))]
    want = jm.predict(x, batch_size=4)
    got = tm.predict(x, batch_size=4)
    _assert_close(got, [np.asarray(w) for w in want]
                  if isinstance(want, (list, tuple)) else want, OUT_ATOL)
    if name == "ner":
        tags = rs.randint(0, 5, (16, 6))
        for m, opt in ((jm, jopt), (tm, topt)):
            m.compile(opt.Adam(lr=1e-2), "sparse_categorical_crossentropy")
        jh = jm.fit(x, tags, batch_size=8, epochs=1)
        th = tm.fit(x, tags, batch_size=8, epochs=1)
        np.testing.assert_allclose(th[0]["loss"], jh[0]["loss"],
                                   atol=TRAIN_ATOL, rtol=0)
        _assert_close(tm.predict(x), jm.predict(x), TRAIN_ATOL)
        np.testing.assert_allclose(
            tm.evaluate(x, tags, batch_size=4)["loss"],
            jm.evaluate(x, tags, batch_size=4)["loss"], atol=TRAIN_ATOL,
            rtol=0)
    assert len(tm.get_weights()) == len(jm.get_weights())
