"""FeatureSet — the in-memory input pipeline (port of
``feature/feature_set.py``).

Data lives host-side as columnar numpy trees (an array, or a list/tuple/
dict of arrays with samples on the leading axis).  Training iterates a
deterministic per-epoch permutation, ``np.random.default_rng(seed *
1_000_003 + epoch)``, bit for bit the reference's, so the two packages
see the same batches in the same order; evaluation iterates in order
with the tail batch zero-padded and a float mask marking real rows.
This slice ports ``from_ndarrays``, the per-step iteration and the
chunked iteration (``epoch_chunks``); the disk tiers and the other
factories are not ported yet.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import numpy as np

from analytics_zoo_torch.pipeline.api.keras.topology import (
    tree_leaves, tree_map,
)


def _tree_len(tree) -> int:
    return len(tree_leaves(tree)[0])


def pad_rows(tree, pad: int):
    """Zero-pad ``pad`` rows onto the leading axis of every leaf."""
    if pad <= 0:
        return tree
    return tree_map(lambda a: np.concatenate(
        [a, np.zeros((pad,) + a.shape[1:], a.dtype)]), tree)


def _tree_take(tree, idx):
    return tree_map(lambda a: np.take(a, idx, axis=0), tree)


class FeatureSet:
    """Columnar in-memory dataset with train/eval iteration semantics."""

    def __init__(self, x, y=None, shuffle: bool = True,
                 seed: Optional[int] = None):
        self.x = x
        self.y = y
        self.shuffle = shuffle
        if seed is None:
            from analytics_zoo_torch.common.config import get_config
            seed = int(get_config().get("data.shuffle_seed"))
        self.seed = seed
        self._size = _tree_len(x)
        if y is not None:
            ylen = _tree_len(y)
            if ylen != self._size:
                raise ValueError(f"x has {self._size} samples, y has {ylen}")

    @classmethod
    def from_ndarrays(cls, x, y=None, shuffle: bool = True,
                      seed: Optional[int] = None) -> "FeatureSet":
        """From numpy arrays / trees of arrays (leading dim = samples)."""
        return cls(tree_map(np.asarray, x),
                   tree_map(np.asarray, y) if y is not None else None,
                   shuffle=shuffle, seed=seed)

    @property
    def size(self) -> int:
        return self._size

    def num_batches(self, batch_size: int, train: bool = True) -> int:
        if train:
            return self._size // batch_size
        return math.ceil(self._size / batch_size)

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + epoch)
        return rng.permutation(self._size)

    def epoch_batches(self, epoch: int, batch_size: int,
                      train: bool = True) -> Iterator[Tuple]:
        """Finite per-epoch batch iterator.

        Train: ``(x, y)``, deterministically shuffled per epoch, remainder
        dropped.  Eval: ``(x, y, mask)`` in order; the tail batch is
        zero-padded and the float mask marks real rows."""
        n = self._size
        if train:
            idx = self._epoch_perm(epoch) if self.shuffle else np.arange(n)
            for b in range(n // batch_size):
                sel = idx[b * batch_size:(b + 1) * batch_size]
                yield (_tree_take(self.x, sel),
                       _tree_take(self.y, sel) if self.y is not None
                       else None)
            return
        for b in range(math.ceil(n / batch_size)):
            lo = b * batch_size
            hi = min(lo + batch_size, n)
            sel = np.arange(lo, hi)
            xb = _tree_take(self.x, sel)
            yb = _tree_take(self.y, sel) if self.y is not None else None
            mask = np.ones(hi - lo, np.float32)
            if hi - lo < batch_size:
                pad = batch_size - (hi - lo)
                xb = pad_rows(xb, pad)
                if yb is not None:
                    yb = pad_rows(yb, pad)
                mask = np.concatenate([mask, np.zeros(pad, np.float32)])
            yield (xb, yb, mask)

    def epoch_chunks(self, epoch: int, batch_size: int, steps: int
                     ) -> Iterator[Tuple]:
        """Chunked training iterator: ``(x, y, k)`` host arrays of ``k`` (up
        to ``steps``) whole batches each, with the same per-epoch
        permutation and remainder drop as ``epoch_batches``.  The training
        engine runs a chunk's ``k`` steps on the device with no host read
        between them (``DistributedTrainer.epoch_scan_fn(k, batch_size)``),
        holding only ``k x batch_size`` rows there."""
        n = self._size
        idx = self._epoch_perm(epoch) if self.shuffle else np.arange(n)
        nb_total = n // batch_size
        b = 0
        while b < nb_total:
            k = min(int(steps), nb_total - b)
            sel = idx[b * batch_size:(b + k) * batch_size]
            yield (_tree_take(self.x, sel),
                   _tree_take(self.y, sel) if self.y is not None else None,
                   k)
            b += k
