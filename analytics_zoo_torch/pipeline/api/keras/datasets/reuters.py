"""Reuters newswire topic loader (ref pyzoo keras/datasets —
46-topic word-id sequences; local .npz or synthetic)."""

from __future__ import annotations

from typing import Optional

import numpy as np

_TOPICS = 46


def _synthetic(n: int, seed: int, maxlen: int):
    rs = np.random.RandomState(seed)
    y = rs.randint(0, _TOPICS, n)
    xs = []
    for label in y:
        length = rs.randint(10, maxlen)
        # each topic owns a 20-word id band starting at 10
        band = 10 + label * 20
        body = rs.randint(10 + _TOPICS * 20, 2000, length)
        marked = rs.randint(band, band + 20, max(3, length // 3))
        body[rs.choice(length, len(marked), replace=False)] = marked
        xs.append(np.concatenate([[1], body]).astype(np.int32))
    return np.asarray(xs, dtype=object), y.astype(np.int64)


def load_data(path: Optional[str] = None, num_words: Optional[int] = None,
              n_train: int = 2000, n_test: int = 500, maxlen: int = 100):
    """-> ((x_train, y_train), (x_test, y_test)); 46 topic classes."""
    from analytics_zoo_torch.pipeline.api.keras.datasets._common import (
        cap_num_words, check_maxlen, load_npz_splits)
    if path is not None:
        out = load_npz_splits(path)
    else:
        check_maxlen(maxlen, 10)
        out = _synthetic(n_train, 0, maxlen), _synthetic(n_test, 1, maxlen)
    return cap_num_words(out[0], num_words), cap_num_words(out[1],
                                                           num_words)
