"""Loss functions (port of ``pipeline/api/keras/objectives.py``): the
reference's objective set — (Sparse)CategoricalCrossEntropy,
BinaryCrossEntropy, MSE/MAE/MAPE/MSLE, Hinge/SquaredHinge/RankHinge,
Poisson, CosineProximity, KLD, ClassNLL — under its registry names.

Each Objective is ``loss(y_true, y_pred) -> scalar`` (mean over the
batch), a plain tensor function that autograd differentiates.  The
probability-input losses keep the Keras-1 convention of the reference:
predictions are renormalised over the class axis and clipped to
``[eps, 1 - eps]`` before the log.  ``get`` resolves the Keras-style
string names.
"""

from __future__ import annotations

from typing import Callable

import torch

_EPS = 1e-7


class Objective:
    def __init__(self, fn: Callable, name: str):
        self.fn = fn
        self.name = name

    def __call__(self, y_true, y_pred):
        return self.fn(y_true, y_pred)


def _clip(p):
    return torch.clamp(p, _EPS, 1.0 - _EPS)


def _labels(y_true, like):
    """Integer class ids, (B, 1) squeezed to (B,) (the reference casts to
    int32; ids index in int64 here)."""
    labels = y_true.to(torch.int32).long()
    if labels.dim() == like.dim():
        labels = labels.squeeze(-1)
    return labels


def _pick(values, labels):
    return torch.take_along_dim(values, labels.unsqueeze(-1), dim=-1)


def mean_squared_error(y_true, y_pred):
    return torch.mean(torch.square(y_pred - y_true))


def mean_absolute_error(y_true, y_pred):
    return torch.mean(torch.abs(y_pred - y_true))


def mean_absolute_percentage_error(y_true, y_pred):
    diff = torch.abs((y_true - y_pred) /
                     torch.clamp(torch.abs(y_true), min=_EPS))
    return 100.0 * torch.mean(diff)


def mean_squared_logarithmic_error(y_true, y_pred):
    a = torch.log(torch.clamp(y_pred, min=_EPS) + 1.0)
    b = torch.log(torch.clamp(y_true, min=_EPS) + 1.0)
    return torch.mean(torch.square(a - b))


def binary_crossentropy(y_true, y_pred):
    p = _clip(y_pred)
    return -torch.mean(y_true * torch.log(p) +
                       (1.0 - y_true) * torch.log(1.0 - p))


def _norm_probs(y_pred):
    """Keras-1 probability-input convention: renormalise over the class
    axis before the log; an all-zero row stays finite."""
    denom = torch.clamp(torch.sum(y_pred, dim=-1, keepdim=True), min=_EPS)
    return _clip(y_pred / denom)


def categorical_crossentropy(y_true, y_pred):
    """One-hot targets vs probability predictions."""
    p = _norm_probs(y_pred)
    return -torch.mean(torch.sum(y_true * torch.log(p), dim=-1))


def sparse_categorical_crossentropy(y_true, y_pred):
    """Integer targets vs probability predictions."""
    p = _norm_probs(y_pred)
    return -torch.mean(_pick(torch.log(p), _labels(y_true, p)))


def categorical_crossentropy_with_logits(y_true, logits):
    return -torch.mean(torch.sum(
        y_true * torch.log_softmax(logits, dim=-1), dim=-1))


def sparse_categorical_crossentropy_with_logits(y_true, logits):
    """Integer targets ((B,), (B, 1), or (B, T) against (B, T, C)) vs
    class logits."""
    lsm = torch.log_softmax(logits, dim=-1)
    return -_pick(lsm, _labels(y_true, logits)).mean()


def class_nll(y_true, log_probs):
    """Negative log-likelihood over log-probability inputs (BigDL
    ClassNLLCriterion semantics, zero-based labels)."""
    return -torch.mean(_pick(log_probs, _labels(y_true, log_probs)))


def hinge(y_true, y_pred):
    return torch.mean(torch.clamp(1.0 - y_true * y_pred, min=0.0))


def squared_hinge(y_true, y_pred):
    return torch.mean(torch.square(
        torch.clamp(1.0 - y_true * y_pred, min=0.0)))


def rank_hinge(y_true, y_pred, margin: float = 1.0):
    """Pairwise ranking hinge for text matching: interleaved (positive,
    negative) pairs along the batch dim."""
    pos = y_pred[0::2]
    neg = y_pred[1::2]
    return torch.mean(torch.clamp(margin - pos + neg, min=0.0))


def poisson(y_true, y_pred):
    return torch.mean(y_pred - y_true * torch.log(y_pred + _EPS))


def cosine_proximity(y_true, y_pred):
    t = y_true / torch.clamp(torch.linalg.vector_norm(
        y_true, dim=-1, keepdim=True), min=_EPS)
    p = y_pred / torch.clamp(torch.linalg.vector_norm(
        y_pred, dim=-1, keepdim=True), min=_EPS)
    return -torch.mean(torch.sum(t * p, dim=-1))


def kullback_leibler_divergence(y_true, y_pred):
    t = _clip(y_true)
    p = _clip(y_pred)
    return torch.mean(torch.sum(t * torch.log(t / p), dim=-1))


_REGISTRY = {
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
    "mape": mean_absolute_percentage_error,
    "mean_absolute_percentage_error": mean_absolute_percentage_error,
    "msle": mean_squared_logarithmic_error,
    "mean_squared_logarithmic_error": mean_squared_logarithmic_error,
    "binary_crossentropy": binary_crossentropy,
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "categorical_crossentropy_with_logits":
        categorical_crossentropy_with_logits,
    "sparse_categorical_crossentropy_with_logits":
        sparse_categorical_crossentropy_with_logits,
    "class_nll": class_nll,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "rank_hinge": rank_hinge,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "kld": kullback_leibler_divergence,
    "kullback_leibler_divergence": kullback_leibler_divergence,
}


def get(loss) -> Objective:
    if isinstance(loss, Objective):
        return loss
    if callable(loss):
        return Objective(loss, getattr(loss, "__name__", "custom"))
    name = str(loss).lower()
    try:
        return Objective(_REGISTRY[name], name)
    except KeyError:
        raise ValueError(f"unknown loss: {loss!r}") from None
