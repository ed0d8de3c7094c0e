"""Composable preprocessing, the ``Preprocessing[A, B]`` analogue (port
of ``feature/common.py``; stdlib and numpy only).

A Preprocessing maps one sample to another; chains compose with ``>>``
(``.then``).  They run on the host, feeding the device input pipeline.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List

import numpy as np


class Preprocessing:
    def apply(self, sample: Any) -> Any:
        raise NotImplementedError

    def __call__(self, sample: Any) -> Any:
        return self.apply(sample)

    def then(self, other: "Preprocessing") -> "ChainedPreprocessing":
        return ChainedPreprocessing([self, other])

    __rshift__ = then

    def apply_all(self, samples: Iterable[Any]) -> List[Any]:
        return [self.apply(s) for s in samples]


class ChainedPreprocessing(Preprocessing):
    def __init__(self, stages: List[Preprocessing]):
        self.stages = []
        for s in stages:
            if isinstance(s, ChainedPreprocessing):
                self.stages.extend(s.stages)
            else:
                self.stages.append(s)

    def apply(self, sample):
        for s in self.stages:
            sample = s.apply(sample)
        return sample


class FnPreprocessing(Preprocessing):
    def __init__(self, fn: Callable):
        self.fn = fn

    def apply(self, sample):
        return self.fn(sample)


class SplitColumns(Preprocessing):
    """Split a packed ``(n, sum(sizes))`` feature matrix into a LIST of
    ``(n, size_i)`` blocks, the bridge from one packed feature column to
    a multi-input model."""

    def __init__(self, sizes):
        self.sizes = [int(s) for s in sizes]

    def apply(self, sample):
        m = np.asarray(sample)
        if sum(self.sizes) != m.shape[-1]:
            raise ValueError(
                f"SplitColumns sizes {self.sizes} sum to "
                f"{sum(self.sizes)} but the packed matrix has "
                f"{m.shape[-1]} columns")
        out, lo = [], 0
        for s in self.sizes:
            out.append(m[..., lo:lo + s])
            lo += s
        return out
