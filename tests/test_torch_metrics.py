"""PyTorch port, the validation metrics: every metric of the registry, and
the recommenders' HitRatio and NDCG, against the JAX package's on the
same seeded inputs, over two batches whose second ends in zero-padded
rows (mask 0), as an eval's tail batch does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from analytics_zoo_tpu.feature.datasets import movielens as jmovielens
from analytics_zoo_tpu.pipeline.api.keras import metrics as jmetrics

from analytics_zoo_torch.pipeline.api.keras import metrics as tmetrics

LOSS = "sparse_categorical_crossentropy_with_logits"
ATOL = 1e-6
ROWS = 24          # a batch; the second batch's last PAD rows are padding
PAD = 5


def _inputs(name, rs):
    """(y_true, y_pred) for one batch, shaped as the metric takes them."""
    if name in ("accuracy", "acc", "sparse_categorical_accuracy", "loss"):
        return rs.randint(0, 5, (ROWS, 1)), rs.randn(ROWS, 5)
    if name == "categorical_accuracy":
        return np.eye(5)[rs.randint(0, 5, ROWS)], rs.randn(ROWS, 5)
    if name in ("binary_accuracy", "auc"):
        return rs.randint(0, 2, (ROWS, 1)), rs.rand(ROWS, 1)
    if name in ("top5", "top5_accuracy"):
        return rs.randint(0, 10, (ROWS,)), rs.randn(ROWS, 10)
    if name == "mae":
        return rs.randn(ROWS, 3), rs.randn(ROWS, 3)
    raise KeyError(name)


def _pair(name):
    if name == "loss":
        return jmetrics.Loss(LOSS), tmetrics.Loss(LOSS)
    return jmetrics.get(name), tmetrics.get(name)


def _jax_score(metric, batches):
    return jmetrics.accumulate([metric], [
        (metric.batch_update(jnp.asarray(y), jnp.asarray(p),
                             jnp.asarray(m)),) for y, p, m in batches])


def _port_score(metric, batches):
    return tmetrics.accumulate([metric], [
        (metric.batch_update(torch.as_tensor(y), torch.as_tensor(p),
                             torch.as_tensor(m)),) for y, p, m in batches])


def _padded(batches):
    """Zero the last PAD rows of the last batch and mask them off."""
    y, p, _ = batches[-1]
    y, p = y.copy(), p.copy()
    y[-PAD:] = 0
    p[-PAD:] = 0
    mask = np.ones(len(p), np.float32)
    mask[-PAD:] = 0
    return batches[:-1] + [(y, p, mask)]


@pytest.mark.parametrize("name", sorted(jmetrics._REGISTRY) + ["loss"])
def test_metric_matches_reference_under_the_tail_mask(name):
    rs = np.random.RandomState(sum(map(ord, name)))
    batches = []
    for _ in range(2):
        y, p = _inputs(name, rs)
        batches.append((y, p.astype(np.float32), np.ones(ROWS, np.float32)))
    batches = _padded(batches)
    jm, tm = _pair(name)
    assert type(tm).__name__ == type(jm).__name__
    want, got = _jax_score(jm, batches), _port_score(tm, batches)
    assert set(got) == set(want) == {jm.name}
    assert got[jm.name] == pytest.approx(want[jm.name], abs=ATOL)
    # the padded rows count for nothing: the score of the real rows alone
    y, p, m = batches[-1]
    real = batches[:-1] + [(y[:-PAD], p[:-PAD], m[:-PAD])]
    assert got[jm.name] == pytest.approx(_port_score(tm, real)[jm.name],
                                         abs=ATOL)


@pytest.mark.parametrize("cls", ["HitRatio", "NDCG"])
@pytest.mark.parametrize("k,neg_num", [(10, 100), (3, 9)])
def test_ranking_metrics_match_reference_on_ncf_eval_groups(cls, k, neg_num):
    """Scores on ``build_ncf_samples``' leave-one-out groups (one positive
    first, then ``neg_num`` negatives), four groups a batch, the last
    batch's last two groups padding."""
    ratings = jmovielens.synthetic_ratings(50, 40, 2000)
    _, _, eval_x, eval_y = jmovielens.build_ncf_samples(
        ratings, 50, 40, eval_neg=neg_num)
    g = neg_num + 1
    rs = np.random.RandomState(k)
    # positive-class logits that favour the positive a little, with ties
    scores = rs.randn(len(eval_y), 2).astype(np.float32)
    scores[:, 1] += 0.8 * eval_y[:, 0]
    scores[::7, 1] = scores[::7, 1].round(1)
    per = 4 * g
    batches = []
    for lo in range(0, len(eval_y), per):
        y, p = eval_y[lo:lo + per], scores[lo:lo + per]
        mask = np.ones(len(p), np.float32)
        if len(p) < per:
            pad = per - len(p)
            y = np.concatenate([y, np.zeros((pad, 1), y.dtype)])
            p = np.concatenate([p, np.zeros((pad, 2), p.dtype)])
            mask = np.concatenate([mask, np.zeros(pad, np.float32)])
        batches.append((y, p, mask))
    jm = getattr(jmetrics, cls)(k, neg_num)
    tm = getattr(tmetrics, cls)(k, neg_num)
    want, got = _jax_score(jm, batches), _port_score(tm, batches)
    assert tm.name == jm.name
    assert got[tm.name] == pytest.approx(want[tm.name], abs=ATOL)
    assert 0.0 < got[tm.name] < 1.0
    # one score column (a single-output model) ranks the same way
    one = [(y, p[:, 1:], m) for y, p, m in batches]
    assert _port_score(tm, one)[tm.name] == pytest.approx(
        _jax_score(jm, one)[tm.name], abs=ATOL)


@pytest.mark.parametrize("cls", ["HitRatio", "NDCG"])
def test_ranking_metrics_refuse_a_batch_of_broken_groups(cls):
    tm = getattr(tmetrics, cls)(10, 100)
    with pytest.raises(ValueError, match="multiple of the group size 101"):
        tm.batch_update(torch.zeros(100, 1), torch.zeros(100, 2),
                        torch.ones(100))
    with pytest.raises(ValueError, match="unknown metric"):
        tmetrics.get("hit_ratio")
    with pytest.raises(TypeError):
        tmetrics.get(3)
