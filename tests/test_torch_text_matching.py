"""PyTorch port, text matching: ``feature/text.py`` (``TextSet``),
``models/common_ranker.py`` (``evaluate_map``/``evaluate_ndcg``) and
``models/textmatching`` (``KNRM``, ``KernelPooling``) held to the JAX
package on the same inputs and, for KNRM, the same weights (the JAX
model's, through ``interop.load_jax_variables``).

Tolerances: the word index, the sequences and the ranker metrics are
exact (the modules are copies); one forward within 1e-6 (+ 1e-6
relative); gradients within 1e-6 of their largest magnitude, since the
exact-match kernel's slope at a match, ``(t - 1) / sigma^2`` with sigma
1e-3, scales the cosine's rounding (~1e-7, another summation order than
XLA's) by 1e6; a 3-epoch ``fit`` trajectory with ``rank_hinge`` and
``shuffle=False`` within 1e-4.  A zero embedding row gives the same NaN
gradient row in both packages (the norm is ``sqrt(sum(x * x))``: its
backward at zero is 0 * inf), and finite values everywhere else."""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.feature.text import TextSet as JTextSet
from analytics_zoo_tpu.models.common_ranker import (
    evaluate_map as j_map, evaluate_ndcg as j_ndcg,
)
from analytics_zoo_tpu.models.textmatching import KNRM as JKNRM
from analytics_zoo_tpu.models.textmatching.knrm import (
    KernelPooling as JKernelPooling,
)
from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.feature.feature_set import FeatureSet
from analytics_zoo_torch.feature.text import TextFeature, TextSet
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.models.common_ranker import (
    evaluate_map, evaluate_ndcg,
)
from analytics_zoo_torch.models.textmatching import KNRM, KernelPooling
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.pipeline.api.keras import objectives as tobj
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer

REPO = pathlib.Path(__file__).resolve().parents[1]
TEXTS = ["The quick brown fox jumps over the lazy dog",
         "JAX compiles to XLA; the dog's bowl is empty",
         "the dog sleeps", "", "Dog dog DOG, 42 foxes!"]


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


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------ TextSet
@pytest.mark.parametrize("args", [
    {}, {"remove_topN": 1}, {"max_words_num": 4}, {"min_freq": 2},
    {"remove_topN": 1, "max_words_num": 3, "min_freq": 1}])
def test_word_index_and_sequences_match_the_reference(args):
    labels = [0, 1, 0, 1, 1]
    got = TextSet.from_texts(TEXTS, labels).tokenize().normalize() \
        .word2idx(**args)
    want = JTextSet.from_texts(TEXTS, labels).tokenize().normalize() \
        .word2idx(**args)
    assert got.word_index == want.word_index
    assert list(got.word_index.items()) == list(want.word_index.items())
    for g, w in zip(got.features, want.features):
        assert g.tokens == w.tokens
        np.testing.assert_array_equal(g.indices, w.indices)
        assert g.indices.dtype == w.indices.dtype == np.int32
    for length, mode in ((6, "pre"), (6, "post"), (3, "pre"), (3, "post"),
                         (1, "pre")):
        gx, gy = got.shape_sequence(length, trunc_mode=mode,
                                    pad_element=7).to_arrays()
        wx, wy = want.shape_sequence(length, trunc_mode=mode,
                                     pad_element=7).to_arrays()
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype


def test_word_index_files_and_existing_maps(tmp_path):
    ts = TextSet.from_texts(TEXTS).tokenize().normalize().word2idx()
    path = tmp_path / "wi.json"
    ts.save_word_index(str(path))
    assert json.loads(path.read_text()) == ts.word_index
    # a file the reference wrote loads in the port, and the reverse
    jts = JTextSet.from_texts(TEXTS).tokenize().normalize().word2idx()
    jpath = tmp_path / "jwi.json"
    jts.save_word_index(str(jpath))
    assert path.read_text() == jpath.read_text()
    new = ["a lazy new dog", "nothing known"]
    got = TextSet.from_texts(new).tokenize().normalize() \
        .load_word_index(str(jpath))
    got.word2idx(existing_map=got.word_index)
    want = JTextSet.from_texts(new).tokenize().normalize() \
        .load_word_index(str(path))
    want.word2idx(existing_map=want.word_index)
    for g, w in zip(got.features, want.features):
        np.testing.assert_array_equal(g.indices, w.indices)
    assert got.features[0].indices[-1] == ts.word_index["dog"]
    assert len(got) == 2 and got.generate_sample() is got


def test_read_csv_matches_the_reference(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("u1,hello world, again\nu2,the dog\n")
    got = TextSet.read_csv(str(path)).tokenize().normalize().word2idx()
    want = JTextSet.read_csv(str(path)).tokenize().normalize().word2idx()
    assert [f.uri for f in got.features] == ["u1", "u2"]
    assert [f.text for f in got.features] == [f.text for f in want.features]
    assert got.word_index == want.word_index
    x, y = got.shape_sequence(4).to_arrays()
    assert y is None and x.shape == (2, 4)


def test_to_feature_set_is_the_ports():
    ts = TextSet.from_texts(TEXTS, [0, 1, 0, 1, 1]).tokenize().normalize() \
        .word2idx().shape_sequence(5)
    fs = ts.to_feature_set(shuffle=False)
    assert isinstance(fs, FeatureSet) and fs.size == 5
    x, y = ts.to_arrays()
    (bx, by), = list(fs.epoch_batches(0, 5, train=True))
    np.testing.assert_array_equal(bx, x)
    np.testing.assert_array_equal(by, y)
    assert isinstance(ts.features[0], TextFeature)


def test_relation_pairs_match_the_reference():
    smoke = _load("chip_smoke", REPO / "chip_smoke.py")
    relations, q_corpus, a_corpus = smoke.qa_relations(7, 3, 50, seed=2)
    got = TextSet.from_relation_pairs(relations, q_corpus, a_corpus)
    want = JTextSet.from_relation_pairs(relations, q_corpus, a_corpus)
    assert [(f.text, f.label) for f in got.features] == \
        [(f.text, f.label) for f in want.features]
    assert [f.label for f in got.features] == [1, 0] * 21


def test_qa_relations_is_the_examples_generator():
    """chip_smoke.py's generator at the example's sizes (4 answers a
    question, 200 words) is the qaranker example's, value for value."""
    example = _load("qa_ranker", REPO / "examples/qaranker/qa_ranker.py")
    smoke = _load("chip_smoke", REPO / "chip_smoke.py")
    for n, seed in ((20, 0), (60, 3)):
        assert smoke.qa_relations(n, 3, 200, seed) == \
            example._synthetic_relations(n, seed)


# ------------------------------------------------------------- the metrics
def test_ranker_metrics_match_the_reference():
    rs = np.random.RandomState(0)
    relations = []
    for q in range(30):
        n = rs.randint(1, 8)
        labels = rs.randint(0, 3, n) * (rs.rand(n) < 0.5)
        relations += [(f"q{q}", f"d{q}_{i}", int(l))
                      for i, l in enumerate(labels)]
    scores = rs.randn(len(relations)).astype(np.float32)
    scores[::5] = scores[1::5][:len(scores[::5])]   # ties
    assert evaluate_map(relations, scores) == j_map(relations, scores)
    for k in (1, 3, 5, 10):
        assert evaluate_ndcg(relations, scores, k=k) == \
            j_ndcg(relations, scores, k=k)
    assert evaluate_map([], np.zeros(0)) == j_map([], np.zeros(0)) == 0.0
    none = [("q", "d", 0), ("q", "e", 0)]
    assert evaluate_ndcg(none, np.ones(2)) == j_ndcg(none, np.ones(2))


# -------------------------------------------------------------------- KNRM
Q_LEN, D_LEN, VOCAB, EMBED = 5, 12, 50, 16


def _pair(embedding_matrix=None, **kw):
    JLayer.reset_name_counters()
    jm = JKNRM(Q_LEN, D_LEN, vocab_size=VOCAB, embed_size=EMBED,
               embedding_matrix=embedding_matrix, **kw)
    TLayer.reset_name_counters()
    tm = KNRM(Q_LEN, D_LEN, vocab_size=VOCAB, embed_size=EMBED,
              embedding_matrix=embedding_matrix, **kw)
    jvars = jax.device_get(jm.model.init(jax.random.PRNGKey(0)))
    load_jax_variables(tm, jvars)
    return jm, tm, jvars


def _ids(n, seed):
    rs = np.random.RandomState(seed)
    q = rs.randint(1, VOCAB + 1, (n, Q_LEN)).astype(np.int32)
    d = rs.randint(1, VOCAB + 1, (n, D_LEN)).astype(np.int32)
    d[:, :3] = q[:, :3]             # exact matches
    d[:, -2:] = 0                   # padding
    return q, d


def test_kernel_pooling_kernels_are_the_references():
    for n, s, e in ((21, 0.1, 0.001), (11, 0.2, 0.01), (2, 0.1, 0.001)):
        layer = KernelPooling(Q_LEN, n, s, e)
        assert layer._kernels()[-1] == (1.0, e)
        jl = JKernelPooling(Q_LEN, n, s, e)
        rs = np.random.RandomState(n)
        q = rs.randn(3, Q_LEN, 8).astype(np.float32)
        d = rs.randn(3, 9, 8).astype(np.float32)
        d[:, 0] = q[:, 0]
        want = np.asarray(jl.call({}, [jnp.asarray(q), jnp.asarray(d)]))
        got = layer.call({}, [torch.as_tensor(q), torch.as_tensor(d)])
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
        assert layer.compute_output_shape([(None, Q_LEN, 8),
                                           (None, 9, 8)]) == (None, n)


@pytest.mark.parametrize("mode", ["ranking", "classification"])
@pytest.mark.parametrize("pretrained", [False, True])
def test_knrm_forward_and_score_pairs_match(mode, pretrained):
    mat = (np.random.RandomState(4).randn(VOCAB + 1, EMBED)
           .astype(np.float32) if pretrained else None)
    jm, tm, _ = _pair(mat, target_mode=mode)
    assert [type(l).__name__ for l in tm.model.layers] == \
        [type(l).__name__ for l in jm.model.layers]
    q, d = _ids(40, 1)
    want = jm.score_pairs(q, d, batch_size=16)
    got = tm.score_pairs(q, d, batch_size=16)
    assert got.shape == want.shape == (40,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tm.predict([q, d]), jm.predict([q, d]),
                               atol=1e-6, rtol=1e-6)


def _grads(jm, tm, jvars, q, d):
    def jloss(p):
        out, _ = jm.model.apply(p, [q, d], state=jvars["state"])
        return jnp.sum(out * jnp.arange(1, len(q) + 1)[:, None])
    jg = jax.device_get(jax.grad(jloss)(jvars["params"]))
    tv = tm.get_variables()
    live = {k: {n: t.detach().requires_grad_() for n, t in v.items()}
            for k, v in tv["params"].items()}
    out, _ = tm.model.apply(live, [torch.as_tensor(q), torch.as_tensor(d)],
                            state=tv["state"])
    w = torch.arange(1, len(q) + 1, dtype=torch.float32)[:, None]
    (out * w).sum().backward()
    return jg, {k: {n: (t.grad.numpy() if t.grad is not None
                        else np.zeros(tuple(t.shape), np.float32))
                    for n, t in v.items()}
                for k, v in live.items()}


@pytest.mark.parametrize("pretrained", [False, True])
def test_knrm_gradients_match(pretrained):
    mat = (np.random.RandomState(5).randn(VOCAB + 1, EMBED)
           .astype(np.float32) if pretrained else None)
    jm, tm, jvars = _pair(mat)
    q, d = _ids(12, 2)
    jg, tg = _grads(jm, tm, jvars, q, d)
    assert set(jg) == set(tg)
    for layer in jg:
        for name, want in jg[layer].items():
            got = tg[layer][name]
            scale = max(float(np.abs(want).max()), 1.0)
            np.testing.assert_allclose(got, want, atol=1e-6 * scale,
                                       err_msg=f"{layer}/{name}")


def test_knrm_zero_embedding_row_gives_the_references_nan_row():
    """A pretrained matrix whose padding row 0 is zero, trainable: the
    norm's backward at that row is 0 * inf in both packages, so row 0's
    gradient is NaN in both and every other entry agrees."""
    mat = np.random.RandomState(6).randn(VOCAB + 1, EMBED).astype(
        np.float32)
    mat[0] = 0.0
    jm, tm, jvars = _pair(mat, train_embed=True)
    q, d = _ids(8, 3)
    # the forward is finite: the clamp at 1e-8 keeps the zero row at zero
    np.testing.assert_allclose(tm.score_pairs(q, d), jm.score_pairs(q, d),
                               atol=1e-6, rtol=1e-6)
    jg, tg = _grads(jm, tm, jvars, q, d)
    want = jg["wordembedding_1"]["embeddings"]
    got = tg["wordembedding_1"]["embeddings"]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want[0]).all() and not np.isnan(want[1:]).any()
    scale = float(np.abs(want[1:]).max())
    np.testing.assert_allclose(got[1:], want[1:], atol=1e-6 * scale)
    # frozen (the default): the table takes no gradient, nothing is NaN
    jm, tm, jvars = _pair(mat, train_embed=False)
    assert tm.model.frozen_layer_names() == {"wordembedding_1"}
    jg, tg = _grads(jm, tm, jvars, q, d)
    assert not np.isnan(tg["dense_1"]["kernel"]).any()
    np.testing.assert_array_equal(tg["wordembedding_1"]["embeddings"], 0.0)
    np.testing.assert_array_equal(jg["wordembedding_1"]["embeddings"], 0.0)


def _qa_arrays(n_questions, seed=0):
    """The qaranker example's pipeline: relations, the word index over
    both corpora, interleaved (pos, neg) pairs, fixed-length ids."""
    smoke = _load("chip_smoke", REPO / "chip_smoke.py")
    relations, qc, ac = smoke.qa_relations(n_questions, 3, VOCAB - 10, seed)
    return smoke.qa_pair_arrays(relations, qc, ac, Q_LEN, D_LEN), relations


@pytest.mark.parametrize("extra_row", [False, True])
def test_knrm_fit_trajectory_with_rank_hinge(extra_row):
    """``fit(shuffle=False)`` keeps the (pos, neg) interleave batch by
    batch in both packages; an odd total drops the same remainder."""
    (q, a, y, _), _ = _qa_arrays(12)
    if extra_row:              # 72 + 1 rows: the odd remainder is dropped
        q, a, y = (np.concatenate([v, v[:1]]) for v in (q, a, y))
    jm, tm, _ = _pair()
    jm.compile(jopt.Adam(lr=0.01), "rank_hinge")
    tm.compile(topt.Adam(lr=0.01), "rank_hinge")
    jh = jm.fit([q, a], y, batch_size=16, nb_epoch=3, shuffle=False)
    th = tm.fit([q, a], y, batch_size=16, nb_epoch=3, shuffle=False)
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], atol=1e-4)
    assert th[-1]["loss"] < th[0]["loss"]
    jp = jax.device_get(jm.get_variables()["params"])
    tp = tm.get_variables()["params"]
    for layer in jp:
        for name, want in jp[layer].items():
            np.testing.assert_allclose(tp[layer][name].numpy(), want,
                                       atol=1e-4)
    # the port's batches: even, interleaved, in order, remainder dropped
    fs = FeatureSet.from_ndarrays([q, a], y, shuffle=False)
    batches = list(fs.epoch_batches(0, 16, train=True))
    assert len(batches) == len(y) // 16
    for i, (_, by) in enumerate(batches):
        np.testing.assert_array_equal(by, y[i * 16:(i + 1) * 16])
        np.testing.assert_array_equal(by[0::2], 1.0)
        np.testing.assert_array_equal(by[1::2], 0.0)


def test_rank_hinge_refuses_an_odd_batch_as_the_reference_does():
    pred = np.arange(5, dtype=np.float32).reshape(5, 1)
    with pytest.raises(Exception):
        jobj.rank_hinge(None, jnp.asarray(pred))
    with pytest.raises(RuntimeError):
        tobj.rank_hinge(None, torch.as_tensor(pred))
    even = np.array([[2.0], [1.5], [0.1], [0.4]], np.float32)
    np.testing.assert_allclose(
        float(tobj.rank_hinge(None, torch.as_tensor(even))),
        float(jobj.rank_hinge(None, jnp.asarray(even))), atol=1e-7)


def test_knrm_ranks_after_training():
    """The example's loop, port only: MAP and NDCG@3 after ``fit`` beat
    the untrained model's on the training relations."""
    (q, a, y, _), relations = _qa_arrays(16, seed=1)
    smoke = _load("chip_smoke", REPO / "chip_smoke.py")
    _, qc, ac = smoke.qa_relations(16, 3, VOCAB - 10, 1)
    rq, ra = smoke.qa_rank_arrays(relations, qc, ac, Q_LEN, D_LEN)
    TLayer.reset_name_counters()
    tm = KNRM(Q_LEN, D_LEN, vocab_size=VOCAB, embed_size=EMBED)
    tm.model.init(torch.Generator().manual_seed(0))
    before = evaluate_map(relations, tm.score_pairs(rq, ra))
    tm.compile(topt.Adam(lr=0.01), "rank_hinge")
    tm.fit([q, a], y, batch_size=16, nb_epoch=8, shuffle=False)
    scores = tm.score_pairs(rq, ra)
    after = evaluate_map(relations, scores)
    assert after > before and after > 0.5
    assert evaluate_ndcg(relations, scores, k=3) > 0.5
