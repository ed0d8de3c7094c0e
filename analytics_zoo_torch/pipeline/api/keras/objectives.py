"""Loss functions (port of ``pipeline/api/keras/objectives.py``).

Each Objective is ``loss(y_true, y_pred) -> scalar`` (mean over the
batch), a plain tensor function that autograd differentiates.  This
slice ports the loss the transformer TextClassifier trains with,
``sparse_categorical_crossentropy_with_logits``; the reference's other
objectives are not ported yet and ``get`` raises for them.
"""

from __future__ import annotations

from typing import Callable

import torch


class Objective:
    def __init__(self, fn: Callable, name: str):
        self.fn = fn
        self.name = name

    def __call__(self, y_true, y_pred):
        return self.fn(y_true, y_pred)


def sparse_categorical_crossentropy_with_logits(y_true, logits):
    """Integer targets ((B,) or (B, 1)) vs class logits (B, C)."""
    labels = y_true.long()
    if labels.dim() == logits.dim():
        labels = labels.squeeze(-1)
    lsm = torch.log_softmax(logits, dim=-1)
    ll = torch.take_along_dim(lsm, labels.unsqueeze(-1), dim=-1)
    return -ll.mean()


_REGISTRY = {
    "sparse_categorical_crossentropy_with_logits":
        sparse_categorical_crossentropy_with_logits,
}

_NOT_PORTED = (
    "mse", "mean_squared_error", "mae", "mean_absolute_error", "mape",
    "mean_absolute_percentage_error", "msle",
    "mean_squared_logarithmic_error", "binary_crossentropy",
    "categorical_crossentropy", "sparse_categorical_crossentropy",
    "categorical_crossentropy_with_logits", "class_nll", "hinge",
    "squared_hinge", "rank_hinge", "poisson", "cosine_proximity", "kld",
    "kullback_leibler_divergence",
)


def get(loss) -> Objective:
    if isinstance(loss, Objective):
        return loss
    if callable(loss):
        return Objective(loss, getattr(loss, "__name__", "custom"))
    name = str(loss).lower()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"loss {name!r} is not ported to the PyTorch package yet "
            "(ROADMAP.md, port queue)")
    try:
        return Objective(_REGISTRY[name], name)
    except KeyError:
        raise ValueError(f"unknown loss: {loss!r}") from None
