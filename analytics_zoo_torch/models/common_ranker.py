"""Ranking evaluation — mean average precision and NDCG@k over grouped
query/candidate relations (ref: zoo/models/common/Ranker.scala:175,
``evaluateMAP`` / ``evaluateNDCG``; a copy of ``models/common_ranker.py``,
numpy only)."""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np


def _grouped(relations: Sequence[Tuple], scores: np.ndarray):
    groups: Dict = {}
    for (id1, _id2, label), s in zip(relations, scores):
        groups.setdefault(id1, []).append((float(s), int(label)))
    return groups


def evaluate_map(relations: Sequence[Tuple], scores: np.ndarray) -> float:
    """relations: (query_id, doc_id, label); scores aligned."""
    groups = _grouped(relations, scores)
    aps = []
    for items in groups.values():
        ranked = sorted(items, key=lambda t: -t[0])
        hits, precisions = 0, []
        for rank, (_, label) in enumerate(ranked, start=1):
            if label > 0:
                hits += 1
                precisions.append(hits / rank)
        if precisions:
            aps.append(float(np.mean(precisions)))
    return float(np.mean(aps)) if aps else 0.0


def evaluate_ndcg(relations: Sequence[Tuple], scores: np.ndarray,
                  k: int = 3) -> float:
    groups = _grouped(relations, scores)
    vals = []
    for items in groups.values():
        ranked = sorted(items, key=lambda t: -t[0])[:k]
        dcg = sum((2 ** label - 1) / np.log2(rank + 1)
                  for rank, (_, label) in enumerate(ranked, start=1))
        ideal = sorted((l for _, l in items), reverse=True)[:k]
        idcg = sum((2 ** l - 1) / np.log2(r + 1)
                   for r, l in enumerate(ideal, start=1))
        if idcg > 0:
            vals.append(dcg / idcg)
    return float(np.mean(vals)) if vals else 0.0
