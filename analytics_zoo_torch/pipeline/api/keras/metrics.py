"""Validation metrics (port of ``pipeline/api/keras/metrics.py``; ref:
zoo/pipeline/api/keras/metrics/ — Accuracy, Top5Accuracy,
SparseCategoricalAccuracy, BinaryAccuracy, CategoricalAccuracy, AUC, MAE,
and the recommenders' HitRatio and NDCG).

Each metric computes partial sums per batch as device tensors, which
merge exactly across batches; ``finalize`` reads them back once at the
end.  A float ``mask`` (1.0 = real row, 0.0 = padding) keeps results
exact when the eval tail batch is zero-padded to a full batch.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

# NumPy 2 renamed ``trapz`` to ``trapezoid``
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


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


class CategoricalAccuracy(Metric):
    """One-hot labels vs class scores."""
    name = "categorical_accuracy"

    def batch_update(self, y_true, y_pred, mask):
        correct = (torch.argmax(y_pred, dim=-1) ==
                   torch.argmax(y_true, dim=-1)).float()
        return torch.sum(correct * mask), torch.sum(mask)


class BinaryAccuracy(Metric):
    name = "binary_accuracy"

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold

    def batch_update(self, y_true, y_pred, mask):
        pred = (y_pred > self.threshold).int()
        correct = (pred == y_true.int()).float()
        correct = correct.reshape(correct.shape[0], -1).mean(dim=-1)
        return torch.sum(correct * mask), torch.sum(mask)


class Top5Accuracy(Metric):
    name = "top5_accuracy"

    def batch_update(self, y_true, y_pred, mask):
        labels = _flat_labels(y_true, y_pred)
        # a stable sort puts the lower index first among equal values, as
        # jax.lax.top_k does (torch.topk leaves their order unspecified)
        top5 = torch.sort(y_pred, dim=-1, descending=True,
                          stable=True).indices[..., :5]
        correct = torch.any(top5 == labels[..., None], dim=-1).float()
        return torch.sum(correct * mask), torch.sum(mask)


class MAE(Metric):
    name = "mae"

    def batch_update(self, y_true, y_pred, mask):
        err = torch.abs(y_pred - y_true).reshape(y_pred.shape[0], -1)
        per_sample = err.mean(dim=-1)
        return torch.sum(per_sample * mask), torch.sum(mask)


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


class AUC(Metric):
    """Streaming AUC by fixed-threshold binning of the first output
    column, as the reference bins it."""

    name = "auc"

    def __init__(self, num_thresholds: int = 200):
        self.num_thresholds = num_thresholds

    def batch_update(self, y_true, y_pred, mask):
        t = torch.linspace(0.0, 1.0, self.num_thresholds,
                           device=y_pred.device)[:, None]
        y = y_true.reshape(y_true.shape[0], -1)[:, 0][None, :]
        p = y_pred.reshape(y_pred.shape[0], -1)[:, 0][None, :]
        m = mask[None, :]
        pred_pos = (p >= t).float() * m
        is_pos = (y > 0.5).float() * m
        is_neg = (y <= 0.5).float() * m
        tp = torch.sum(pred_pos * is_pos, dim=1)
        fp = torch.sum(pred_pos * is_neg, dim=1)
        return tp, fp, torch.sum(is_pos), torch.sum(is_neg)

    def finalize(self, partials):
        tp, fp, pos, neg = (v.double().cpu().numpy() for v in partials)
        tpr = tp / max(float(pos), 1.0)
        fpr = fp / max(float(neg), 1.0)
        order = np.argsort(fpr, kind="stable")
        fpr_s = np.concatenate([[0.0], fpr[order], [1.0]])
        tpr_s = np.concatenate([[0.0], tpr[order], [1.0]])
        return float(_trapezoid(tpr_s, fpr_s))


class HitRatio(Metric):
    """HitRate@k for NCF-style ranking eval (ref: pyzoo recommender
    evaluation; BigDL HitRatio validation method).  Each group of
    ``neg_num + 1`` contiguous rows holds one positive (first) and its
    negatives; a group is a hit if the positive's score ranks in the top
    k of its group.  An eval batch must hold whole groups."""

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k = k
        self.neg_num = neg_num
        self.name = f"hit_ratio@{k}"

    def _groups(self, y_pred, mask):
        g = self.neg_num + 1
        # class outputs -> positive-class score per row
        if y_pred.dim() > 1:
            y_pred = y_pred[..., -1] if y_pred.shape[-1] > 1 \
                else y_pred[..., 0]
        if y_pred.shape[0] % g != 0:
            raise ValueError(
                f"{self.name}: eval batch size {y_pred.shape[0]} must be a "
                f"multiple of the group size {g} (1 positive + "
                f"{self.neg_num} negatives, contiguous per user); pick "
                f"batch_size = k * {g}")
        return y_pred.reshape(-1, g), mask.reshape(-1, g)[:, 0]

    def batch_update(self, y_true, y_pred, mask):
        scores, m = self._groups(y_pred, mask)
        # the positive item is position 0 of each group by construction
        rank = torch.sum((scores[:, 1:] > scores[:, :1]).int(), dim=-1)
        hit = (rank < self.k).float()
        return torch.sum(hit * m), torch.sum(m)


class NDCG(Metric):
    """NDCG@k with a single positive per group (recommendation eval)."""

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k = k
        self.neg_num = neg_num
        self.name = f"ndcg@{k}"

    _groups = HitRatio._groups

    def batch_update(self, y_true, y_pred, mask):
        scores, m = self._groups(y_pred, mask)
        rank = torch.sum((scores[:, 1:] > scores[:, :1]).int(), dim=-1)
        in_k = rank < self.k
        ndcg = torch.where(in_k, math.log(2.0) / torch.log(rank + 2.0),
                           torch.zeros((), device=rank.device))
        return torch.sum(ndcg * m), torch.sum(m)


_REGISTRY = {
    "accuracy": SparseCategoricalAccuracy,
    "acc": SparseCategoricalAccuracy,
    "sparse_categorical_accuracy": SparseCategoricalAccuracy,
    "categorical_accuracy": CategoricalAccuracy,
    "binary_accuracy": BinaryAccuracy,
    "top5": Top5Accuracy,
    "top5_accuracy": Top5Accuracy,
    "mae": MAE,
    "auc": AUC,
}


def get(metric) -> Metric:
    if isinstance(metric, Metric):
        return metric
    if isinstance(metric, str):
        try:
            return _REGISTRY[metric.lower()]()
        except KeyError:
            raise ValueError(f"unknown metric: {metric!r}") from None
    raise TypeError(f"cannot resolve metric from {type(metric)}")
