"""PyTorch port, the recommenders slice: MovieLens samples, NeuralCF and
Wide & Deep built in both packages from the same weights
(``load_jax_variables``), then predicted, trained (Adam steps, ``fit``
with validation), evaluated with HitRatio/NDCG and ranked, and compared
on the CPU; the trainer's ``prefetch`` and ``train_step_at``.

Both packages run ``dtype.compute=float32`` so the comparison is of the
algorithm, not of bf16 rounding."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from analytics_zoo_tpu.feature.datasets import movielens as jmovielens
from analytics_zoo_tpu.models.recommendation import (
    ColumnFeatureInfo as JColumnFeatureInfo, NeuralCF as JNeuralCF,
    UserItemFeature as JUserItemFeature, WideAndDeep as JWideAndDeep,
)
from analytics_zoo_tpu.parallel.trainer import DistributedTrainer as JTrainer
from analytics_zoo_tpu.pipeline.api.keras import metrics as jmetrics
from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.feature.datasets import movielens
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.models.recommendation import (
    ColumnFeatureInfo, NeuralCF, SessionRecommender, UserItemFeature,
    WideAndDeep,
)
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.parallel.trainer import (
    DistributedTrainer, step_generator,
)
from analytics_zoo_torch.pipeline.api.keras import Input, Model
from analytics_zoo_torch.pipeline.api.keras import metrics as tmetrics
from analytics_zoo_torch.pipeline.api.keras import objectives as tobj
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.api.keras.layers import Dense, Dropout

LOSS = "sparse_categorical_crossentropy_with_logits"
USERS, ITEMS, RATINGS = 50, 40, 2000
NCF_WIDTHS = dict(user_embed=8, item_embed=8, mf_embed=4,
                  hidden_layers=(16, 8))
# one forward in float32: the two frameworks sum the products in other
# orders (~1e-7 relative of a logit)
PREDICT_ATOL = 1e-6
# multi-step losses and params: the reference's own cross-program float32
# tolerance (ROADMAP.md, ground rules)
STEP_ATOL = 1e-4
# scores compared only where two candidates' scores differ by more than
# this (below it the order may flip on float32 noise)
RANK_GAP = 1e-5
VAL_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _port_cpu(f32_policy):
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tdtypes.restore_policy(None)
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    kernels.reset_launch_counts()
    yield
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _shared(jbuild, tbuild):
    """The same model built in both packages, the port holding the JAX
    model's weights."""
    JLayer.reset_name_counters()
    jmodel = jbuild()
    TLayer.reset_name_counters()
    tmodel = tbuild()
    load_jax_variables(tmodel, jax.tree_util.tree_map(
        np.asarray, jmodel.get_variables()))
    return jmodel, tmodel


def _ncf_pair(include_mf):
    return _shared(
        lambda: JNeuralCF(USERS, ITEMS, include_mf=include_mf, **NCF_WIDTHS),
        lambda: NeuralCF(USERS, ITEMS, include_mf=include_mf, **NCF_WIDTHS))


def _ncf_data(eval_neg=100):
    ratings = movielens.synthetic_ratings(USERS, ITEMS, RATINGS)
    return movielens.build_ncf_samples(ratings, USERS, ITEMS,
                                       eval_neg=eval_neg)


def _assert_params_close(tparams, jparams, atol):
    assert sorted(tparams) == sorted(jparams)
    for layer in sorted(jparams):
        for name in sorted(jparams[layer]):
            np.testing.assert_allclose(
                tparams[layer][name].detach().numpy(),
                np.asarray(jparams[layer][name]), atol=atol, rtol=0,
                err_msg=f"{layer}/{name}")


# ------------------------------------------------------------- MovieLens
@pytest.mark.parametrize("neg_per_pos,eval_neg,max_users_eval",
                         [(4, 100, None), (2, 10, 7)])
def test_movielens_samples_are_the_reference_arrays(neg_per_pos, eval_neg,
                                                    max_users_eval):
    ratings = movielens.synthetic_ratings(USERS, ITEMS, RATINGS)
    jratings = jmovielens.synthetic_ratings(USERS, ITEMS, RATINGS)
    np.testing.assert_array_equal(ratings, jratings)
    got = movielens.build_ncf_samples(ratings, USERS, ITEMS, neg_per_pos,
                                      eval_neg,
                                      max_users_eval=max_users_eval)
    want = jmovielens.build_ncf_samples(jratings, USERS, ITEMS, neg_per_pos,
                                        eval_neg,
                                        max_users_eval=max_users_eval)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (movielens.ML1M_USERS, movielens.ML1M_ITEMS) == (6040, 3706)


def test_load_ratings_reads_the_ml1m_format(tmp_path):
    path = tmp_path / "ratings.dat"
    path.write_text("1::1193::5::978300760\n2::661::3.0::978302109\n\n"
                    "6040::3706::1::956704887\n")
    got = movielens.load_ratings(str(path))
    np.testing.assert_array_equal(got, jmovielens.load_ratings(str(path)))
    np.testing.assert_array_equal(
        got, [[1, 1193, 5], [2, 661, 3], [6040, 3706, 1]])


# -------------------------------------------------------------- NeuralCF
@pytest.mark.parametrize("include_mf", [True, False])
def test_neuralcf_predict_matches_reference(include_mf):
    jmodel, tmodel = _ncf_pair(include_mf)
    _, _, eval_x, _ = _ncf_data()
    # batch 512 pads the tail of the 5050 rows
    got = tmodel.predict(eval_x, batch_size=512)
    want = np.asarray(jmodel.predict(eval_x, batch_size=512))
    assert got.shape == want.shape == (len(eval_x[0]), 2)
    np.testing.assert_allclose(got, want, atol=PREDICT_ATOL, rtol=0)
    np.testing.assert_array_equal(
        tmodel.predict_classes([a[:3] for a in eval_x],
                               zero_based_label=False),
        np.argmax(want, axis=-1)[:3] + 1)
    n_mf = 2 if include_mf else 0
    assert len(tmodel.get_weights()) == 2 + n_mf + 2 * 3


@pytest.mark.parametrize("include_mf", [True, False])
def test_neuralcf_adam_steps_match_reference(include_mf):
    """Five Adam steps through ``train_step_at`` in both packages from the
    same weights: every step's loss, then the params leaf by leaf."""
    jmodel, tmodel = _ncf_pair(include_mf)
    train_x, train_y, _, _ = _ncf_data()
    jtr = JTrainer(jmodel.model, jobj.get(LOSS),
                   optim_method=jopt.Adam(lr=1e-2))
    ttr = DistributedTrainer(tmodel.model, tobj.get(LOSS),
                             optim_method=topt.Adam(lr=1e-2))
    jv, tv = jmodel.get_variables(), tmodel.get_variables()
    jp, js = jtr.place_params(jv["params"]), jtr.replicate(jv["state"])
    jo = jtr.init_opt_state(jp)
    tp, ts = ttr.place_params(tv["params"]), ttr.replicate(tv["state"])
    to = ttr.init_opt_state(tp)
    rng = jax.random.PRNGKey(0)
    batches = [([a[i * 256:(i + 1) * 256] for a in train_x],
                train_y[i * 256:(i + 1) * 256]) for i in range(5)]
    for i, b in enumerate(ttr.prefetch(batches)):
        jp, jo, js, jloss = jtr.train_step_at(jp, jo, js,
                                              jtr.put_batch(batches[i]),
                                              rng, np.int32(i))
        tp, to, ts, tloss = ttr.train_step_at(tp, to, ts, b, 0, i)
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   atol=STEP_ATOL, rtol=0)
    _assert_params_close(tp, jax.device_get(jp), atol=STEP_ATOL)
    assert int(to[0].count) == 5
    # the CPU runs the plain update: no kernel launched
    assert sum(kernels.launch_counts().values()) == 0


@pytest.mark.parametrize("include_mf", [True, False])
def test_neuralcf_recommendations_match_reference(include_mf):
    jmodel, tmodel = _ncf_pair(include_mf)
    rs = np.random.RandomState(4)
    users = rs.randint(1, USERS + 1, 20)
    items = rs.randint(1, ITEMS + 1, 20)
    got = tmodel.predict_user_item_pair(
        [UserItemFeature(int(u), int(i), {}) for u, i in zip(users, items)])
    want = jmodel.predict_user_item_pair(
        [JUserItemFeature(int(u), int(i), {}) for u, i in zip(users, items)])
    for g, w in zip(got, want):
        assert (g.user_id, g.item_id, g.prediction) == \
            (w.user_id, w.item_id, w.prediction)
        assert g.prediction in (1, 2)
        assert g.probability == pytest.approx(w.probability,
                                              abs=PREDICT_ATOL)
    for method, ids, cands in (("recommend_for_user", [1, 7, USERS],
                                range(1, ITEMS + 1)),
                               ("recommend_for_item", [1, 9, ITEMS],
                                range(1, USERS + 1))):
        got = getattr(tmodel, method)(ids, cands, 10, batch_size=16)
        want = getattr(jmodel, method)(ids, cands, 10, batch_size=16)
        assert list(got) == list(want) == ids
        for key in ids:
            g, w = got[key], want[key]
            assert len(g) == len(w) == 10
            scores = [p.probability for p in w]
            assert scores == sorted(scores, reverse=True)
            for j, (a, b) in enumerate(zip(g, w)):
                assert a.probability == pytest.approx(b.probability,
                                                      abs=PREDICT_ATOL)
                assert a.prediction == b.prediction
                gaps = [abs(scores[j] - s) for k, s in enumerate(scores)
                        if k != j]
                if min(gaps) > RANK_GAP:
                    assert (a.user_id, a.item_id) == (b.user_id, b.item_id)


def test_neuralcf_fit_evaluates_hit_ratio_and_ndcg_like_the_reference():
    """``fit`` two epochs, then ``evaluate`` HitRatio@10/NDCG@10 over the
    leave-one-out groups at a batch of 4 groups (the tail batch padded)."""
    jmodel, tmodel = _ncf_pair(True)
    train_x, train_y, eval_x, eval_y = _ncf_data()
    for model, opt, met in ((jmodel, jopt, jmetrics),
                            (tmodel, topt, tmetrics)):
        model.compile(opt.Adam(lr=1e-3), LOSS,
                      metrics=[met.HitRatio(10, 100), met.NDCG(10, 100)])
    jhist = jmodel.fit(train_x, train_y, batch_size=512, nb_epoch=2)
    thist = tmodel.fit(train_x, train_y, batch_size=512, nb_epoch=2)
    for t, j in zip(thist, jhist):
        np.testing.assert_allclose(t["loss"], j["loss"], atol=STEP_ATOL,
                                   rtol=0)
    want = jmodel.evaluate(eval_x, eval_y, batch_size=101 * 4)
    got = tmodel.evaluate(eval_x, eval_y, batch_size=101 * 4)
    assert set(got) == set(want) == {"loss", "hit_ratio@10", "ndcg@10"}
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert 0.0 < got["hit_ratio@10"] <= 1.0
    with pytest.raises(ValueError, match="multiple of the group size"):
        tmodel.evaluate(eval_x, eval_y, batch_size=100)


def test_boundary_ids_agree_in_both_packages():
    """The largest ids index the last row of each table: ``user_count``,
    ``item_count`` and the last offset of the wide table."""
    jmodel, tmodel = _ncf_pair(True)
    x = [np.array([[USERS], [1], [USERS]], np.int32),
         np.array([[ITEMS], [ITEMS], [1]], np.int32)]
    np.testing.assert_allclose(tmodel.predict(x), np.asarray(jmodel.predict(x)),
                               atol=PREDICT_ATOL, rtol=0)
    jwd, twd = _wd_pair("wide_n_deep")
    cols = {name: np.full(3, dim - 1) for name, dim in
            zip(WD_INFO["wide_base_cols"] + WD_INFO["wide_cross_cols"],
                WD_INFO["wide_base_dims"] + WD_INFO["wide_cross_dims"])}
    cols.update({"c": [3, 0, 1], "d": [6, 6, 0], "e": [4, 0, 4],
                 "f": [0.5, -1.0, 2.0], "g": [1.0, 0.0, 3.0]})
    feats = twd.features_from_columns(cols)
    last = sum(WD_INFO["wide_base_dims"] + WD_INFO["wide_cross_dims"])
    assert int(feats[0].max()) == last
    jwd.model.set_variables(_nonzero_wide(jwd.get_variables()))
    load_jax_variables(twd, jax.tree_util.tree_map(np.asarray,
                                                   jwd.get_variables()))
    np.testing.assert_allclose(twd.predict(feats),
                               np.asarray(jwd.predict(feats)),
                               atol=PREDICT_ATOL, rtol=0)


# ---------------------------------------------------------- Wide & Deep
WD_INFO = dict(wide_base_cols=["a", "b"], wide_base_dims=[3, 5],
               wide_cross_cols=["ab"], wide_cross_dims=[15],
               indicator_cols=["c"], indicator_dims=[4],
               embed_cols=["d", "e"], embed_in_dims=[6, 4],
               embed_out_dims=[3, 2], continuous_cols=["f", "g"])


def _wd_pair(model_type):
    return _shared(
        lambda: JWideAndDeep(2, JColumnFeatureInfo(**WD_INFO), model_type,
                             hidden_layers=(8, 4)),
        lambda: WideAndDeep(2, ColumnFeatureInfo(**WD_INFO), model_type,
                            hidden_layers=(8, 4)))


def _nonzero_wide(variables):
    """The wide table starts at zero; give it values so that the wide
    part shows in the outputs."""
    rs = np.random.RandomState(9)
    rows = sum(WD_INFO["wide_base_dims"] + WD_INFO["wide_cross_dims"]) + 1
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    for layer, p in params.items():
        if "embeddings" in p and p["embeddings"].shape[0] == rows:
            p["embeddings"] = rs.randn(*p["embeddings"].shape).astype(
                np.float32)
    return {**variables, "params": params}


def _wd_columns(n, seed=5):
    rs = np.random.RandomState(seed)
    a, b = rs.randint(0, 3, n), rs.randint(0, 5, n)
    return ({"a": a, "b": b, "ab": a * 5 + b, "c": rs.randint(0, 9, n),
             "d": rs.randint(0, 7, n), "e": rs.randint(0, 5, n),
             "f": rs.rand(n).astype(np.float32),
             "g": rs.randn(n).astype(np.float32)},
            (a + b + rs.randint(0, 2, n) > 3).astype(np.int64))


@pytest.mark.parametrize("model_type", ["wide_n_deep", "wide", "deep"])
def test_wide_and_deep_matches_reference(model_type):
    """Features, predict, then three Adam steps through ``fit`` (one epoch
    of three batches) and the params after them."""
    jmodel, tmodel = _wd_pair(model_type)
    if model_type != "deep":
        jmodel.model.set_variables(_nonzero_wide(jmodel.get_variables()))
        load_jax_variables(tmodel, jax.tree_util.tree_map(
            np.asarray, jmodel.get_variables()))
    cols, y = _wd_columns(96)
    feats = tmodel.features_from_columns(cols)
    jfeats = jmodel.features_from_columns(cols)
    assert len(feats) == len(jfeats) == {"wide": 1, "deep": 3,
                                         "wide_n_deep": 4}[model_type]
    for g, w in zip(feats, jfeats):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(tmodel.predict(feats, batch_size=40),
                               np.asarray(jmodel.predict(jfeats,
                                                         batch_size=40)),
                               atol=PREDICT_ATOL, rtol=0)
    for model, opt in ((jmodel, jopt), (tmodel, topt)):
        model.compile(opt.Adam(lr=1e-2), LOSS, metrics=["accuracy", "auc"])
    jhist = jmodel.fit(jfeats, y, batch_size=32, nb_epoch=1)
    thist = tmodel.fit(feats, y, batch_size=32, nb_epoch=1)
    np.testing.assert_allclose(thist[0]["loss"], jhist[0]["loss"],
                               atol=STEP_ATOL, rtol=0)
    _assert_params_close(tmodel.get_variables()["params"],
                         jax.device_get(jmodel.get_variables()["params"]),
                         atol=STEP_ATOL)
    with pytest.raises(NotImplementedError, match="features_from_columns"):
        tmodel.recommend_for_user([1], [1, 2], 1)


def test_wide_model_needs_wide_columns():
    info = dataclasses.replace(ColumnFeatureInfo(**WD_INFO),
                               wide_base_cols=(), wide_base_dims=(),
                               wide_cross_cols=(), wide_cross_dims=())
    with pytest.raises(ValueError, match="wide"):
        WideAndDeep(2, info, "wide")


# ------------------------------------------------------ SessionRecommender
SESSION = dict(item_count=60, item_embed=8, rnn_hidden_layers=(12, 6),
               session_length=5, mlp_hidden_layers=(10, 6),
               history_length=7)


@pytest.mark.parametrize("include_history", [False, True])
def test_session_recommender_matches_reference(include_history):
    """GRU stack over the session (and the mean-pooled history through
    its MLP): predict logits within 1e-6 and ``recommend_for_session``'s
    order and probabilities against the JAX package's."""
    from analytics_zoo_tpu.models.recommendation.session_recommender \
        import SessionRecommender as JSessionRecommender
    cfg = dict(SESSION, include_history=include_history)
    jmodel, tmodel = _shared(lambda: JSessionRecommender(**cfg),
                             lambda: SessionRecommender(**cfg))
    params = tmodel.get_variables()["params"]
    assert sorted(params) == sorted(jmodel.get_variables()["params"])
    assert tuple(params["gru_1"]["recurrent_kernel"].shape) == (12, 36)
    rs = np.random.RandomState(0)
    sessions = rs.randint(1, 61, (30, 5))
    history = rs.randint(1, 61, (30, 7))
    x = [sessions, history] if include_history else [sessions]
    got = tmodel.predict(x, batch_size=8)
    assert got.shape == (30, 61)
    np.testing.assert_allclose(
        got, np.asarray(jmodel.predict(x, batch_size=8)),
        atol=PREDICT_ATOL, rtol=0)
    hist = history if include_history else None
    trec = tmodel.recommend_for_session(sessions, max_items=5,
                                        history=hist, batch_size=16)
    jrec = jmodel.recommend_for_session(sessions, max_items=5,
                                        history=hist, batch_size=16)
    assert len(trec) == len(jrec) == 30
    for t_row, j_row in zip(trec, jrec):
        assert len(t_row) == 5
        np.testing.assert_allclose([p for _, p in t_row],
                                   [p for _, p in j_row],
                                   atol=PREDICT_ATOL, rtol=0)
        probs = [p for _, p in j_row]
        for k, ((ti, _), (ji, _)) in enumerate(zip(t_row, j_row)):
            apart = all(abs(probs[k] - probs[m]) > RANK_GAP
                        for m in range(5) if m != k)
            if apart:
                assert ti == ji
    if include_history:
        with pytest.raises(ValueError, match="history"):
            tmodel.recommend_for_session(sessions)


# ------------------------------------------------- validation during fit
@pytest.mark.parametrize("how", ["validation_data", "validation_split",
                                 "loss_only"])
def test_fit_validation_scores_match_reference(how):
    jmodel, tmodel = _wd_pair("wide_n_deep")
    cols, y = _wd_columns(200, seed=6)
    feats = tmodel.features_from_columns(cols)
    vcols, vy = _wd_columns(50, seed=7)
    vfeats = tmodel.features_from_columns(vcols)
    metrics = [] if how == "loss_only" else ["accuracy", "auc"]
    for model, opt in ((jmodel, jopt), (tmodel, topt)):
        model.compile(opt.Adam(lr=1e-2), LOSS, metrics=metrics)
    kw = (dict(validation_split=0.2) if how == "validation_split" else
          dict(validation_data=(vfeats, vy)))
    jhist = jmodel.fit(feats, y, batch_size=32, nb_epoch=2, **kw)
    thist = tmodel.fit(feats, y, batch_size=32, nb_epoch=2, **kw)
    assert len(thist) == len(jhist) == 2
    for t, j in zip(thist, jhist):
        assert set(t) == {"epoch", "loss", "throughput", "wall_s", "val"}
        assert set(t["val"]) == set(j["val"]) == (
            {"loss"} if how == "loss_only" else
            {"sparse_categorical_accuracy", "auc"})
        np.testing.assert_allclose(t["loss"], j["loss"], atol=STEP_ATOL,
                                   rtol=0)
        for k in j["val"]:
            assert t["val"][k] == pytest.approx(j["val"][k], abs=VAL_ATOL), k


# ------------------------------------------- prefetch and train_step_at
def test_prefetch_gives_the_batches_in_order_at_every_depth():
    tr = DistributedTrainer(None, None)
    rs = np.random.RandomState(0)
    batches = [(rs.randn(4, 3).astype(np.float32), rs.randint(0, 2, (4,)))
               for _ in range(7)]
    for depth in (0, 1, 2):
        got = list(tr.prefetch(iter(batches), depth=depth))
        assert len(got) == len(batches)
        for (gx, gy), (wx, wy) in zip(got, batches):
            assert isinstance(gx, torch.Tensor) and gx.device == tr.device
            np.testing.assert_array_equal(gx.numpy(), wx)
            np.testing.assert_array_equal(gy.numpy(), wy)
    tconfig.get_config().set("data.prefetch", 0)
    assert len(list(tr.prefetch(batches))) == 7


def test_prefetch_hands_a_worker_exception_to_the_consumer():
    tr = DistributedTrainer(None, None)

    def broken():
        yield np.zeros(2)
        raise OSError("disk gone")
    it = tr.prefetch(broken(), depth=2)
    np.testing.assert_array_equal(next(it).numpy(), np.zeros(2))
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    # a consumer that stops early stops the worker
    pulled = []

    def endless():
        while True:
            pulled.append(1)
            yield np.zeros(1)
    it = tr.prefetch(endless(), depth=2)
    next(it)
    it.close()     # joins the worker: one taken, two queued, one in hand
    assert len(pulled) <= 4


def test_train_step_at_is_train_step_with_the_step_generator():
    """With dropout on, ``train_step_at(seed, step)`` takes exactly the
    step ``train_step`` takes with ``step_generator(seed, step)``."""
    TLayer.reset_name_counters()
    inp = Input(shape=(6,))
    model = Model(inp, Dense(3)(Dropout(0.5)(Dense(16)(inp))))
    model.init(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(1)
    batch = (rs.randn(8, 6).astype(np.float32), rs.randint(0, 3, (8,)))
    out = []
    for at in (True, False):
        tr = DistributedTrainer(model, tobj.get(LOSS),
                                optim_method=topt.Adam(lr=1e-2))
        params = tr.place_params(model.get_variables()["params"])
        opt_state = tr.init_opt_state(params)
        b = tr.put_batch(batch)
        for step in (5, 6):
            if at:
                params, opt_state, _, loss = tr.train_step_at(
                    params, opt_state, {}, b, 3, step)
            else:
                params, opt_state, _, loss = tr.train_step(
                    params, opt_state, {}, b, step_generator(3, step, "cpu"))
        out.append((float(loss), params))
    assert out[0][0] == out[1][0]
    for layer in out[0][1]:
        for name, t in out[0][1][layer].items():
            assert torch.equal(t, out[1][1][layer][name])
