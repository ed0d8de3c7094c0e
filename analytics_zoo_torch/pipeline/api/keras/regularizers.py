"""Keras-1 regularizer creators (port of
``pipeline/api/keras/regularizers.py``; ref pyzoo keras/regularizers.py —
L1L2Regularizer over the bigdl penalties).

A regularizer here is the ``(l1, l2)`` coefficient pair consumed by
``Layer.add_weight(..., regularizer=...)``: the trainer adds the penalty
to the loss it differentiates, and reports the loss without it.
"""

from __future__ import annotations

from typing import Tuple

Regularizer = Tuple[float, float]


def l1(l: float = 0.01) -> Regularizer:
    return (float(l), 0.0)


def l2(l: float = 0.01) -> Regularizer:
    return (0.0, float(l))


def l1l2(l1: float = 0.01, l2: float = 0.01) -> Regularizer:
    return (float(l1), float(l2))


L1Regularizer = l1
L2Regularizer = l2
L1L2Regularizer = l1l2
