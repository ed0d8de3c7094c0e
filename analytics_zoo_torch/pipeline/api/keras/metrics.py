"""Validation metrics (port of ``pipeline/api/keras/metrics.py``).

Each metric computes partial sums per batch as device tensors, which
merge exactly across batches; ``finalize`` reads them back once at the
end.  A float ``mask`` (1.0 = real row, 0.0 = padding) keeps results
exact when the eval tail batch is zero-padded to a full batch.  This
slice ports ``SparseCategoricalAccuracy`` (``"accuracy"``) and ``Loss``;
the other metrics are not ported yet and ``get`` raises for them.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _flat_labels(y_true, y_pred):
    labels = y_true.long()
    if labels.dim() == y_pred.dim():
        labels = labels.squeeze(-1)
    return labels


class Metric:
    name = "metric"

    def batch_update(self, y_true, y_pred, mask) -> Tuple:
        """Return partial sums for one (possibly padded) batch."""
        raise NotImplementedError

    def merge(self, a, b):
        return tuple(x + y for x, y in zip(a, b))

    def finalize(self, partials) -> float:
        num, den = partials
        return float(num) / max(float(den), 1e-12)


def accumulate(metrics, partial_batches):
    """Fold per-batch partial tuples into final scores (one host read per
    partial, at the end)."""
    partials = None
    for upd in partial_batches:
        if partials is None:
            partials = list(upd)
        else:
            partials = [m.merge(a, b)
                        for m, a, b in zip(metrics, partials, upd)]
    return {m.name: m.finalize(p)
            for m, p in zip(metrics, partials or [None] * len(metrics))
            if p is not None}


class SparseCategoricalAccuracy(Metric):
    """Integer labels vs class scores."""
    name = "sparse_categorical_accuracy"

    def batch_update(self, y_true, y_pred, mask):
        labels = _flat_labels(y_true, y_pred)
        correct = (torch.argmax(y_pred, dim=-1) == labels).float()
        return torch.sum(correct * mask), torch.sum(mask)


class Loss(Metric):
    """Wraps an objective as a validation metric, evaluated per sample so
    padding rows contribute nothing."""

    def __init__(self, objective):
        from analytics_zoo_torch.pipeline.api.keras import objectives
        self.objective = objectives.get(objective)
        self.name = "loss"

    def batch_update(self, y_true, y_pred, mask):
        per_sample = torch.vmap(
            lambda t, p: self.objective(t[None], p[None]))(y_true, y_pred)
        return torch.sum(per_sample * mask), torch.sum(mask)


_REGISTRY = {
    "accuracy": SparseCategoricalAccuracy,
    "acc": SparseCategoricalAccuracy,
    "sparse_categorical_accuracy": SparseCategoricalAccuracy,
}

_NOT_PORTED = ("categorical_accuracy", "binary_accuracy", "top5",
               "top5_accuracy", "mae", "auc")


def get(metric) -> Metric:
    if isinstance(metric, Metric):
        return metric
    if isinstance(metric, str):
        name = metric.lower()
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"metric {name!r} is not ported to the PyTorch package yet "
                "(ROADMAP.md, port queue)")
        try:
            return _REGISTRY[name]()
        except KeyError:
            raise ValueError(f"unknown metric: {metric!r}") from None
    raise TypeError(f"cannot resolve metric from {type(metric)}")
