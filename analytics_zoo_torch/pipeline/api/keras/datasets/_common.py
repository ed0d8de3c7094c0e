"""Shared helpers for the sequence-dataset loaders (imdb, reuters)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def load_npz_splits(path: str, test_split: float = 0.2,
                    seed: int = 113) -> Tuple:
    """Read a Keras sequence archive.  Handles BOTH conventions: the
    pre-split form (x_train/y_train/x_test/y_test) and the raw Keras
    imdb.npz / reuters.npz form (keys x/y, split here by
    ``test_split`` the way Keras does)."""
    with np.load(path, allow_pickle=True) as f:
        if "x_train" in f:
            return ((f["x_train"], f["y_train"]),
                    (f["x_test"], f["y_test"]))
        x, y = f["x"], f["y"]
    idx = np.random.RandomState(seed).permutation(len(x))
    x, y = x[idx], y[idx]
    cut = int(len(x) * (1.0 - test_split))
    return (x[:cut], y[:cut]), (x[cut:], y[cut:])


def cap_num_words(split, num_words: Optional[int]):
    """Map out-of-vocabulary ids to 2 (the Keras oov token).  Sequences
    may be ndarrays OR Python lists (the raw Keras archives store
    lists)."""
    if num_words is None:
        return split
    x, y = split
    capped = [np.where(np.asarray(s) < num_words,
                       np.asarray(s), 2).astype(np.int32) for s in x]
    # build the object array explicitly: np.asarray(..., dtype=object)
    # on same-length sequences would yield a 2-D object array, silently
    # changing the container shape depending on the input
    out = np.empty(len(capped), dtype=object)
    out[:] = capped
    return out, y


def check_maxlen(maxlen: int, minimum: int) -> None:
    if maxlen <= minimum:
        raise ValueError(
            f"maxlen must be > {minimum} (got {maxlen}): synthetic "
            f"sequences draw lengths in [{minimum}, maxlen)")
