"""MNIST loader (ref pyzoo zoo/pipeline/api/keras/datasets — the
reference shells out to bigdl's mnist download; here: local mnist.npz
or synthetic digits)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _synthetic(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Digit-like 28x28 u8 images: class-dependent stroke patterns."""
    rs = np.random.RandomState(seed)
    y = rs.randint(0, 10, n).astype(np.uint8)
    x = np.zeros((n, 28, 28), np.uint8)
    yy, xx = np.mgrid[:28, :28]
    for i, d in enumerate(y):
        cx, cy = 14 + (d % 5) - 2, 14 + (d // 5) * 3 - 2
        r = 6 + (d % 3) * 2
        ring = np.abs(np.hypot(xx - cx, yy - cy) - r) < 1.8
        if d % 2:                       # odd digits get a bar
            ring |= (np.abs(xx - cx) < 1.5) & (np.abs(yy - cy) < r)
        img = np.where(ring, 255, 0).astype(np.int16)
        img += rs.randint(0, 32, (28, 28))
        x[i] = np.clip(img, 0, 255).astype(np.uint8)
    return x, y


def load_data(path: Optional[str] = None, n_train: int = 6000,
              n_test: int = 1000):
    """-> ((x_train, y_train), (x_test, y_test)); images u8 (N,28,28).

    ``path``: a standard Keras ``mnist.npz`` (keys x_train/y_train/
    x_test/y_test).  Without it, deterministic synthetic digits.
    """
    if path is not None:
        with np.load(path, allow_pickle=False) as f:
            return ((f["x_train"], f["y_train"]),
                    (f["x_test"], f["y_test"]))
    return _synthetic(n_train, 0), _synthetic(n_test, 1)
