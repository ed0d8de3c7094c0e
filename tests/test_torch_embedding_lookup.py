"""Embedding lookups at ids outside the table, and ``Top5Accuracy`` at ties,
against the JAX package.

The reference's lookups are ``jnp.take`` in its default fill mode: a
negative id wraps to ``input_dim + id``, and an id still outside the
table gives a NaN row whose gradient is dropped.  ``SparseEmbedding``
clamps its ids at 0 first (its padding is -1), so only ids past the end
give NaN.  The reference's ``Top5Accuracy`` takes ``jax.lax.top_k``,
which puts the lower index first among equal values: where the fifth
place is a tie, the rows it counts correct depend on that order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras import metrics as jmetrics

from analytics_zoo_torch.pipeline.api.keras import layers as tl
from analytics_zoo_torch.pipeline.api.keras import metrics as tmetrics

TABLE = np.arange(20, dtype=np.float32).reshape(5, 4)
# row 0: an id past the end and a negative one; row 1 every id in the table
# (SparseEmbedding's padding -1 at its end), so each layer has rows with a
# gradient
IDS = np.array([[0, 3, 5, -1], [1, 4, 2, -1]], dtype=np.int32)


def _layers(mod):
    return {"Embedding": mod.Embedding(5, 4),
            "WordEmbedding": mod.WordEmbedding(TABLE, trainable=True),
            "SparseEmbedding": mod.SparseEmbedding(5, 4)}


def _reference(name, weights):
    """The JAX layer's output at ``IDS`` and the gradient of
    sum(out * weights) over its rows that hold no NaN."""
    layer = _layers(jl)[name]

    def out(table):
        return layer.call({"embeddings": table}, jnp.asarray(IDS))

    y = np.asarray(out(jnp.asarray(TABLE)))
    keep = jnp.asarray(~np.isnan(y))

    def loss(table):
        return jnp.sum(jnp.where(keep, out(table) * weights, 0.0))

    return y, np.asarray(jax.grad(loss)(jnp.asarray(TABLE)))


@pytest.mark.parametrize("name", ["Embedding", "WordEmbedding",
                                  "SparseEmbedding"])
def test_lookup_outside_the_table_matches_reference(name):
    rs = np.random.RandomState(5)
    layer = _layers(tl)[name]
    table = torch.from_numpy(TABLE.copy()).requires_grad_()
    got = layer.call({"embeddings": table}, torch.from_numpy(IDS))
    weights = rs.randn(*got.shape).astype(np.float32)
    want, want_grad = _reference(name, jnp.asarray(weights))
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got.detach().numpy()),
                                  np.isnan(want))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    keep = ~torch.isnan(got.detach())
    loss = torch.where(keep, got * torch.from_numpy(weights),
                       torch.zeros(())).sum()
    grad, = torch.autograd.grad(loss, table)
    np.testing.assert_allclose(grad.numpy(), want_grad, atol=1e-6, rtol=0)


def test_lookup_wraps_negative_ids_and_fills_nan():
    """Id -1 is row 4; id 5 a NaN row (-6 too, after its wrap)."""
    out = tl.Embedding(5, 4).call(
        {"embeddings": torch.from_numpy(TABLE)},
        torch.tensor([[0, 3, 5, -1, -6]], dtype=torch.int32))[0]
    assert torch.equal(out[[0, 1, 3]], torch.from_numpy(TABLE[[0, 3, 4]]))
    assert torch.isnan(out[[2, 4]]).all()


def _top5_counts(y_true, y_pred):
    n = len(y_true)
    want = jmetrics.Top5Accuracy().batch_update(
        jnp.asarray(y_true), jnp.asarray(y_pred), jnp.ones(n))
    got = tmetrics.Top5Accuracy().batch_update(
        torch.as_tensor(y_true), torch.as_tensor(y_pred), torch.ones(n))
    return float(want[0]), float(got[0])


def test_top5_breaks_fifth_place_ties_as_the_reference():
    """Saturated softmax rows: fewer than 5 nonzero probabilities a row,
    so the fifth place is a tie of exact zeros.  The reference counts 39
    of 64 (``torch.topk`` counted 28 on the CPU)."""
    rs = np.random.RandomState(0)
    logits = rs.randn(64, 10).astype(np.float32) * 200
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1),
                     np.float32)
    labels = rs.randint(0, 10, 64)
    assert ((probs > 0).sum(-1) < 5).all()
    want, got = _top5_counts(labels, probs)
    assert want == 39.0
    assert got == want


def test_top5_on_one_hot_rows_matches_the_reference():
    """One-hot rows of 1000 classes: four zeros share the fifth place; the
    reference takes classes 0-3 (the hot class aside), so labels below 10
    often count.  The reference counts 14 of 40 (``torch.topk`` counted 15
    on the CPU)."""
    rs = np.random.RandomState(1)
    probs = np.eye(1000, dtype=np.float32)[rs.randint(0, 1000, 40)]
    labels = rs.randint(0, 10, 40)
    want, got = _top5_counts(labels, probs)
    assert want == 14.0
    assert got == want
