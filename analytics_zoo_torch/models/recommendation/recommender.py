"""Recommender base API (port of ``models/recommendation/recommender.py``).

Reference: zoo/models/recommendation/Recommender.scala:46-105 —
``predictUserItemPair``, ``recommendForUser``, ``recommendForItem``.
Each is a batched ``predict`` over columnar id arrays on the zoo
context's device, then a ranking on the host.  The scores are the
model's raw outputs (``NeuralCF`` outputs logits): no softmax is added,
as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from analytics_zoo_torch.models.common import ZooModel


@dataclasses.dataclass
class UserItemFeature:
    user_id: int
    item_id: int
    features: dict          # model-ready input columns


@dataclasses.dataclass
class UserItemPrediction:
    user_id: int
    item_id: int
    prediction: int
    probability: float


class Recommender(ZooModel):
    """Subclasses must map (user_ids, item_ids) -> model inputs via
    ``pair_features``."""

    def pair_features(self, user_ids: np.ndarray, item_ids: np.ndarray):
        raise NotImplementedError

    def predict_user_item_pair(
            self, feature_pairs: Sequence[UserItemFeature],
            batch_size: int = 2048) -> List[UserItemPrediction]:
        users = np.array([p.user_id for p in feature_pairs])
        items = np.array([p.item_id for p in feature_pairs])
        probs = self._pair_scores(users, items, batch_size)
        preds = np.argmax(probs, axis=-1)
        return [UserItemPrediction(int(u), int(i), int(c) + 1,
                                   float(p[c]))
                for u, i, c, p in zip(users, items, preds, probs)]

    def _pair_scores(self, users, items, batch_size):
        x = self.pair_features(users, items)
        return np.asarray(self.predict(x, batch_size=batch_size))

    def recommend_for_user(self, user_ids: Sequence[int],
                           candidate_items: Sequence[int], max_items: int,
                           batch_size: int = 4096):
        """Top ``max_items`` items per user by positive-class score."""
        items = np.asarray(candidate_items)
        result = {}
        for u in user_ids:
            users = np.full(len(items), u)
            probs = self._pair_scores(users, items, batch_size)
            score = probs[:, -1] if probs.ndim > 1 else probs.ravel()
            top = np.argsort(-score)[:max_items]
            result[u] = [UserItemPrediction(int(u), int(items[j]),
                                            int(np.argmax(probs[j])) + 1
                                            if probs.ndim > 1 else 1,
                                            float(score[j]))
                         for j in top]
        return result

    def recommend_for_item(self, item_ids: Sequence[int],
                           candidate_users: Sequence[int], max_users: int,
                           batch_size: int = 4096):
        """Top ``max_users`` users per item by positive-class score."""
        users = np.asarray(candidate_users)
        result = {}
        for it in item_ids:
            items = np.full(len(users), it)
            probs = self._pair_scores(users, items, batch_size)
            score = probs[:, -1] if probs.ndim > 1 else probs.ravel()
            top = np.argsort(-score)[:max_users]
            result[it] = [UserItemPrediction(int(users[j]), int(it),
                                             int(np.argmax(probs[j])) + 1
                                             if probs.ndim > 1 else 1,
                                             float(score[j]))
                          for j in top]
        return result
