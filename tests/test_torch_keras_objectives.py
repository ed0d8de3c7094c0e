"""PyTorch port, Keras objectives: every loss of the reference's registry
against the JAX package's on the same seeded numpy inputs (value and
d(loss)/d(y_pred), within 1e-6 absolute plus 1e-6 relative: float32
sums in another order), the (B, T) label layout of the sequence losses,
and tf.keras's values as ``tests/test_golden_objectives.py`` holds the
JAX package to them (its tolerances: 1e-4 on values, 1e-3 on
gradients)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj

from analytics_zoo_torch.pipeline.api.keras import objectives as tobj

TOL = 1e-6


def _probs(rs, shape):
    p = rs.rand(*shape).astype(np.float32) + 0.05
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _inputs(name, seed=0):
    """(y_true, y_pred) of the kind ``name`` takes."""
    rs = np.random.RandomState(seed)
    if name in ("binary_crossentropy",):
        return (rs.randint(0, 2, (8, 1)).astype(np.float32),
                (rs.rand(8, 1) * 0.9 + 0.05).astype(np.float32))
    if name == "categorical_crossentropy":
        return np.eye(5, dtype=np.float32)[rs.randint(0, 5, 6)], \
            _probs(rs, (6, 5))
    if name == "sparse_categorical_crossentropy":
        return rs.randint(0, 5, (6, 1)).astype(np.int32), _probs(rs, (6, 5))
    if name == "categorical_crossentropy_with_logits":
        return np.eye(5, dtype=np.float32)[rs.randint(0, 5, 6)], \
            (rs.randn(6, 5) * 2).astype(np.float32)
    if name == "sparse_categorical_crossentropy_with_logits":
        return rs.randint(0, 5, (6,)).astype(np.int32), \
            (rs.randn(6, 5) * 2).astype(np.float32)
    if name == "class_nll":
        z = rs.randn(6, 5).astype(np.float32)
        logp = z - np.log(np.exp(z).sum(-1, keepdims=True))
        return rs.randint(0, 5, (6, 1)).astype(np.int32), \
            logp.astype(np.float32)
    if name in ("hinge", "squared_hinge"):
        return np.sign(rs.randn(6, 4)).astype(np.float32), \
            rs.randn(6, 4).astype(np.float32)
    if name == "rank_hinge":
        return np.zeros((8, 1), np.float32), \
            rs.randn(8, 1).astype(np.float32)
    if name == "cosine_proximity":
        return rs.randn(4, 6).astype(np.float32), \
            rs.randn(4, 6).astype(np.float32)
    if name in ("kld", "kullback_leibler_divergence"):
        return _probs(rs, (5, 4)), _probs(rs, (5, 4))
    # the regression losses
    return (rs.rand(6, 4).astype(np.float32) + 0.1,
            rs.rand(6, 4).astype(np.float32) + 0.1)


def _jax(name, y_true, y_pred):
    val, grad = jax.value_and_grad(
        lambda p: jobj.get(name)(jnp.asarray(y_true), p))(
            jnp.asarray(y_pred))
    return float(val), np.asarray(grad)


def _port(name, y_true, y_pred):
    p = torch.from_numpy(y_pred).requires_grad_()
    val = tobj.get(name)(torch.from_numpy(y_true), p)
    (grad,) = torch.autograd.grad(val, p)
    return float(val.detach()), grad.numpy()


def test_the_registry_is_the_reference_registry():
    assert sorted(tobj._REGISTRY) == sorted(jobj._REGISTRY)
    assert len(tobj._REGISTRY) == 21
    for name in tobj._REGISTRY:
        obj = tobj.get(name.upper())
        assert obj.name == name == jobj.get(name).name
    with pytest.raises(ValueError, match="unknown loss"):
        tobj.get("f1")
    custom = tobj.get(tobj.hinge)
    assert custom.name == "hinge" and tobj.get(custom) is custom


@pytest.mark.parametrize("name", sorted(jobj._REGISTRY))
def test_every_loss_matches_reference(name):
    y_true, y_pred = _inputs(name)
    want, jgrad = _jax(name, y_true, y_pred)
    got, tgrad = _port(name, y_true, y_pred)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tgrad, jgrad, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", [
    "sparse_categorical_crossentropy_with_logits",
    "sparse_categorical_crossentropy", "class_nll"])
@pytest.mark.parametrize("labels", ["(B, T)", "(B, T, 1)"])
def test_sequence_labels_against_sequence_scores(name, labels):
    """(B, T) or (B, T, 1) labels against (B, T, C) scores, as a token
    head trains (BERTNER, the GPT-1 token head)."""
    rs = np.random.RandomState(3)
    y = rs.randint(0, 7, (3, 5) if labels == "(B, T)" else (3, 5, 1))
    z = (rs.randn(3, 5, 7) * 2).astype(np.float32)
    if name == "sparse_categorical_crossentropy":
        z = _probs(rs, (3, 5, 7))
    elif name == "class_nll":
        z = (z - np.log(np.exp(z).sum(-1, keepdims=True))).astype(
            np.float32)
    want, jgrad = _jax(name, y, z)
    got, tgrad = _port(name, y, z)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tgrad, jgrad, atol=TOL, rtol=TOL)


def test_probability_losses_stay_finite_on_degenerate_rows():
    """An all-zero probability row and a prediction of exactly 0 or 1 are
    clipped, as in the reference."""
    y = np.eye(3, dtype=np.float32)[[0, 2]]
    p = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    for name, yt in (("categorical_crossentropy", y),
                     ("kld", y), ("binary_crossentropy", y)):
        want, jgrad = _jax(name, yt, p)
        got, tgrad = _port(name, yt, p)
        assert np.isfinite(got) and np.isfinite(tgrad).all()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(tgrad, jgrad, atol=TOL, rtol=TOL)


# ---------------------------------------------- tf.keras golden values
@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def _tf_value_and_grad(tf, fn, y_true, y_pred):
    yp = tf.constant(y_pred)
    with tf.GradientTape() as tape:
        tape.watch(yp)
        val = tf.reduce_mean(fn(tf.constant(y_true), yp))
    return float(val.numpy()), tape.gradient(val, yp).numpy()


GOLDEN = [
    ("mse", "mse", 1e-4), ("mae", "mae", 1e-4), ("mape", "mape", 1e-4),
    ("msle", "msle", 1e-4), ("poisson", "poisson", 1e-4),
    ("squared_hinge", "squared_hinge", 1e-4), ("hinge", "hinge", 1e-4),
    ("binary_crossentropy", "binary_crossentropy", 1e-3),
    ("categorical_crossentropy", "categorical_crossentropy", 1e-3),
    ("sparse_categorical_crossentropy", "sparse_categorical_crossentropy",
     1e-3),
    ("sparse_categorical_crossentropy_with_logits", "logits", 1e-4),
    ("kld", "kullback_leibler_divergence", 1e-3),
    ("cosine_proximity", "cosine_similarity", 1e-3),
]


@pytest.mark.parametrize("name,tf_name,grad_atol", GOLDEN,
                         ids=[g[0] for g in GOLDEN])
def test_golden_values_of_tf_keras(tf, name, tf_name, grad_atol):
    """The port against the tf.keras oracle on the golden tests' inputs."""
    rs = np.random.RandomState(0)
    if name in ("mse", "mae", "mape", "msle", "poisson", "hinge",
                "squared_hinge"):
        y_true = rs.rand(6, 4).astype(np.float32) + 0.1
        y_pred = rs.rand(6, 4).astype(np.float32) + 0.1
        if "hinge" in name:
            y_true = np.sign(rs.randn(6, 4)).astype(np.float32)
    elif name == "sparse_categorical_crossentropy_with_logits":
        y_pred = rs.randn(6, 5).astype(np.float32)
        y_true = rs.randint(0, 5, (6, 1)).astype(np.int32)
    elif name == "cosine_proximity":
        y_true = rs.randn(4, 6).astype(np.float32)
        y_pred = rs.randn(4, 6).astype(np.float32)
    else:
        y_true, y_pred = _inputs(name)
    if tf_name == "logits":
        fn = lambda yt, yp: tf.keras.losses.sparse_categorical_crossentropy(
            yt, yp, from_logits=True)  # noqa: E731
    else:
        fn = getattr(tf.keras.losses, tf_name)
    got, tgrad = _port(name, y_true, y_pred)
    want, rgrad = _tf_value_and_grad(tf, fn, y_true, y_pred)
    assert abs(got - want) < 1e-4, (name, got, want)
    np.testing.assert_allclose(tgrad, rgrad, rtol=1e-3, atol=grad_atol)
