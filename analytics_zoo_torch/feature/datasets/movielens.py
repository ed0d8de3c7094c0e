"""MovieLens data utilities for the NCF workload (a numpy-only copy of
the JAX package's ``feature/datasets/movielens.py``: the same draws in
the same order, so the arrays are bit-identical to the reference's).

Reference: pyzoo/zoo/examples/recommendation (NCF on MovieLens-1M) and
models/recommendation sample building.  ``load_ratings`` reads the
ml-1m ``ratings.dat`` format when a copy exists locally;
``synthetic_ratings`` generates a same-shape corpus (6040 users, 3706
items, ~1M interactions) for offline benchmarking.

``build_ncf_samples`` reproduces the implicit-feedback recipe: each
positive (u, i) pairs with ``neg_per_pos`` sampled negatives for
training, and leave-one-out evaluation groups 1 positive + ``eval_neg``
negatives contiguously (what HitRatio/NDCG metrics expect).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

ML1M_USERS = 6040
ML1M_ITEMS = 3706


def load_ratings(path: str) -> np.ndarray:
    """Read ml-1m ratings.dat (``user::item::rating::ts``) into an
    (N, 3) int array of user, item, rating (ids 1-based)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split("::")
            if len(parts) >= 3:
                rows.append((int(parts[0]), int(parts[1]),
                             int(float(parts[2]))))
    return np.asarray(rows, np.int64)


def synthetic_ratings(num_users: int = ML1M_USERS,
                      num_items: int = ML1M_ITEMS,
                      num_ratings: int = 1_000_000,
                      seed: int = 42) -> np.ndarray:
    """Same-shape synthetic corpus with a popularity skew (zipf-ish),
    deterministic per seed."""
    rng = np.random.default_rng(seed)
    users = rng.integers(1, num_users + 1, num_ratings)
    # zipf-like item popularity, clipped into range
    items = (rng.zipf(1.2, num_ratings) % num_items) + 1
    ratings = rng.integers(1, 6, num_ratings)
    return np.stack([users, items, ratings], axis=1)


def build_ncf_samples(ratings: np.ndarray, num_users: int, num_items: int,
                      neg_per_pos: int = 4, eval_neg: int = 100,
                      seed: int = 7,
                      max_users_eval: Optional[int] = None):
    """Implicit-feedback train/eval split.

    Returns ``(train_x=[users, items], train_y, eval_x, eval_groups)``:
    train pairs each observed interaction (label 1) with sampled
    unobserved items (label 0); eval holds out each user's last positive
    and ranks it against ``eval_neg`` sampled negatives, groups laid out
    contiguously (positive first).
    """
    rng = np.random.default_rng(seed)
    users = ratings[:, 0].astype(np.int64)
    items = ratings[:, 1].astype(np.int64)

    # last interaction per user (by row order) → eval positive
    last_row = {}
    for idx in range(len(users)):
        last_row[users[idx]] = idx
    eval_rows = np.array(sorted(last_row.values()))
    train_mask = np.ones(len(users), bool)
    train_mask[eval_rows] = False

    tr_u = users[train_mask]
    tr_i = items[train_mask]

    # negatives: uniform over items; collision with a true positive is
    # rare and tolerated, as in the reference example pipeline
    neg_u = np.repeat(tr_u, neg_per_pos)
    neg_i = rng.integers(1, num_items + 1, len(neg_u))
    train_users = np.concatenate([tr_u, neg_u])
    train_items = np.concatenate([tr_i, neg_i])
    train_labels = np.concatenate(
        [np.ones(len(tr_u), np.int32), np.zeros(len(neg_u), np.int32)])
    perm = rng.permutation(len(train_users))
    train_x = [train_users[perm].reshape(-1, 1).astype(np.int32),
               train_items[perm].reshape(-1, 1).astype(np.int32)]
    train_y = train_labels[perm].reshape(-1, 1)

    # eval: per held-out user, 1 positive + eval_neg negatives
    ev = eval_rows if max_users_eval is None else eval_rows[:max_users_eval]
    g = eval_neg + 1
    ev_users = np.repeat(users[ev], g)
    ev_items = np.empty(len(ev) * g, np.int64)
    ev_items[0::g] = items[ev]
    for k in range(1, g):
        ev_items[k::g] = rng.integers(1, num_items + 1, len(ev))
    eval_x = [ev_users.reshape(-1, 1).astype(np.int32),
              ev_items.reshape(-1, 1).astype(np.int32)]
    eval_y = np.zeros((len(ev_users), 1), np.int32)
    eval_y[0::g] = 1
    return train_x, train_y, eval_x, eval_y
