"""Boston-housing regression loader (ref pyzoo keras/datasets —
13-feature tabular regression; local .npz or synthetic)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def load_data(path: Optional[str] = None, n_train: int = 404,
              n_test: int = 102, seed: int = 113):
    """-> ((x_train, y_train), (x_test, y_test)); x (N,13) f64, y (N,)."""
    if path is not None:
        with np.load(path, allow_pickle=False) as f:
            x, y = f["x"], f["y"]
    else:
        rs = np.random.RandomState(seed)
        n = n_train + n_test
        x = rs.rand(n, 13) * [100, 25, 30, 1, 1, 9, 100, 12, 24, 700,
                              22, 400, 40]
        w = rs.randn(13) * [0.1, 0.05, -0.1, 3.0, -10.0, 5.0, -0.02,
                            -1.0, 0.2, -0.01, -0.8, 0.01, -0.5]
        y = 22.0 + x @ (w * 0.1) + rs.randn(n) * 2.0
    idx = np.random.RandomState(seed).permutation(len(x))
    x, y = x[idx], y[idx]
    return ((x[:n_train], y[:n_train]),
            (x[n_train:n_train + n_test], y[n_train:n_train + n_test]))
