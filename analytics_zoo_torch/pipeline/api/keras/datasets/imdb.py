"""IMDB sentiment loader (ref pyzoo keras/datasets/imdb.py — word-index
sequences + binary labels; local imdb.npz or synthetic reviews)."""

from __future__ import annotations

from typing import Optional

import numpy as np

# disjoint sentiment vocabularies (ids beyond the reserved 0..3 band)
_POS = list(range(10, 60))
_NEG = list(range(60, 110))
_NEUTRAL = list(range(110, 400))


def _synthetic(n: int, seed: int, maxlen: int):
    rs = np.random.RandomState(seed)
    y = rs.randint(0, 2, n)
    xs = []
    for label in y:
        length = rs.randint(8, maxlen)
        body = rs.choice(_NEUTRAL, length)
        marked = rs.choice(_POS if label else _NEG,
                           max(2, length // 4))
        body[rs.choice(length, len(marked), replace=False)] = marked
        xs.append(np.concatenate([[1], body]).astype(np.int32))  # 1=start
    return np.asarray(xs, dtype=object), y.astype(np.int64)


def load_data(path: Optional[str] = None, num_words: Optional[int] = None,
              n_train: int = 2000, n_test: int = 500, maxlen: int = 80):
    """-> ((x_train, y_train), (x_test, y_test)); x = object arrays of
    variable-length int32 word-id sequences (Keras imdb convention:
    0=pad, 1=start, 2=oov)."""
    from analytics_zoo_torch.pipeline.api.keras.datasets._common import (
        cap_num_words, check_maxlen, load_npz_splits)
    if path is not None:
        out = load_npz_splits(path)
    else:
        check_maxlen(maxlen, 8)
        out = _synthetic(n_train, 0, maxlen), _synthetic(n_test, 1, maxlen)
    return cap_num_words(out[0], num_words), cap_num_words(out[1],
                                                           num_words)
