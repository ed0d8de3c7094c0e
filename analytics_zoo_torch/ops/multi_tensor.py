"""The leaf table of the multi-tensor optimizer kernels
(``csrc/fused_adam.cu``, ``csrc/fused_sgd.cu``; the format is
``csrc/multi_tensor.cuh``'s, whose constants this module mirrors).

One launch updates every leaf of a step.  Its table holds one int64 row a
leaf: the leaf's operand pointers (Adam: p, g, m, v; SGD: p, g, and the
trace or 0), its element count, its first chunk in a prefix over chunks
of ``CHUNK`` elements (from 0 in every launch), and 1 where every pointer
is 16-byte aligned.  Empty leaves are left out.  A launch takes at most
``MAX_LEAVES`` rows; a longer leaf set splits into as few launches as fit.
The kernel's block ``c`` takes chunk ``c``: ``chunk_range`` is its
search, in Python.

``LeafSet`` keeps the tables of one leaf set whose parameters and
moments stay where they lie from step to step (the fused update works in
place): built and checked once, it takes only each step's gradient
pointers.  ``TableCache`` keeps the last ``LeafSet``, keyed by the
pointers and shapes of the parameters and moments.
"""

from __future__ import annotations

import itertools
import operator
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

CHUNK = 2048          # mt::CHUNK: the elements a block takes
MAX_LEAVES = 512      # mt::LARGE: the rows a launch takes at most
GRAD = 1              # the gradient's column: filled every step

_shape = operator.attrgetter("shape")


def leaf_tables(addresses: Sequence[Sequence[int]], numels: Sequence[int],
                max_leaves: int = MAX_LEAVES
                ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The launches' tables for leaves with operand ``addresses`` (one
    sequence a leaf, 0 for an absent operand) and element counts
    ``numels``: a list of ``(rows, leaf indices)``, one a launch, at least
    one (an empty table when no leaf holds an element)."""
    n = np.asarray(numels, dtype=np.int64).reshape(-1)
    addr = np.asarray(addresses, dtype=np.int64).reshape(len(n), -1)
    nptr = addr.shape[1]
    keep = np.flatnonzero(n > 0)
    out = []
    for start in range(0, len(keep), max_leaves) or [0]:
        idx = keep[start:start + max_leaves]
        rows = np.zeros((len(idx), nptr + 3), dtype=np.int64)
        rows[:, :nptr] = addr[idx]
        rows[:, nptr] = n[idx]
        chunks = -(-n[idx] // CHUNK)
        rows[1:, nptr + 1] = np.cumsum(chunks)[:-1]
        rows[:, nptr + 2] = (np.bitwise_or.reduce(addr[idx], axis=1,
                                                  initial=0) & 15) == 0
        out.append((rows, idx))
    return out


def table_chunks(rows: np.ndarray) -> int:
    """The chunks (blocks) of one launch's table."""
    if not len(rows):
        return 0
    return int(rows[-1, -2] + -(-rows[-1, -3] // CHUNK))


def chunk_range(rows: np.ndarray, c: int) -> Tuple[int, int, int]:
    """``(row, lo, hi)``: chunk ``c`` of a table covers elements
    ``[lo, hi)`` of the leaf in ``row``; the kernel's block ``c`` finds
    it by the same binary search."""
    first, n = rows[:, -2], rows[:, -3]
    i = int(np.searchsorted(first, c, side="right")) - 1
    lo = (c - int(first[i])) * CHUNK
    return i, lo, min(lo + CHUNK, int(n[i]))


def _check_leaf_set(columns, shapes) -> torch.device:
    devices = set()
    for col, tensors in enumerate(columns):
        if col == GRAD or tensors is None:
            continue
        for t, shape in zip(tensors, shapes):
            if t.shape != shape:
                raise ValueError(f"multi-tensor update: operand {col} shape "
                                 f"{tuple(t.shape)} != p shape {tuple(shape)}")
            if t.dtype != torch.float32:
                raise ValueError("multi-tensor update: the kernel takes "
                                 f"float32, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError("multi-tensor update: operands must be "
                                 "contiguous (the kernel updates in place)")
            devices.add(t.device)
    if len(devices) != 1:
        raise ValueError(f"multi-tensor update: leaves on devices {devices}")
    return devices.pop()


def leaf_set_key(columns) -> tuple:
    """What a ``LeafSet`` is keyed by: every parameter's and moment's
    pointer, and the parameters' shapes."""
    ptrs = tuple(map(torch.Tensor.data_ptr, itertools.chain.from_iterable(
        ts for col, ts in enumerate(columns)
        if col != GRAD and ts is not None)))
    return ptrs, tuple(map(_shape, columns[0]))


class LeafSet:
    """The tables of one leaf set.  ``columns`` holds one list of tensors
    an operand in the kernel's order (column ``GRAD`` None: the gradients
    come with each step; a None column is an absent operand, 0 in every
    row).  Every tensor is float32, contiguous, on one device, with its
    parameter's shape (the caller launches only for a CUDA device)."""

    def __init__(self, columns, max_leaves: int = MAX_LEAVES):
        self.shapes = [p.shape for p in columns[0]]
        self.device = _check_leaf_set(columns, self.shapes)
        self.key = leaf_set_key(columns)
        count = len(self.shapes)
        addresses = np.zeros((count, len(columns)), dtype=np.int64)
        for col, tensors in enumerate(columns):
            if col != GRAD and tensors is not None:
                addresses[:, col] = [t.data_ptr() for t in tensors]
        self.tables = leaf_tables(addresses,
                                  [p.numel() for p in columns[0]],
                                  max_leaves)
        # alignment of the fixed operands; each step ands in the gradient's
        self._aligned = [rows[:, -1].copy() for rows, _ in self.tables]
        self._launches = [(rows.ctypes.data, len(rows))
                          for rows, _ in self.tables]

    def fill(self, grads) -> List[Tuple[int, int]]:
        """Check this step's gradients (shape, float32, contiguous, the
        device) and put their pointers in the tables; returns ``(table
        address, rows)`` a launch."""
        if len(grads) != len(self.shapes):
            raise ValueError(f"multi-tensor update: {len(grads)} gradients "
                             f"for {len(self.shapes)} leaves")
        dev = self.device
        for g, shape in zip(grads, self.shapes):
            if g.shape != shape or g.dtype != torch.float32 or \
                    g.device != dev or not g.is_contiguous():
                raise ValueError(
                    "multi-tensor update: a gradient must be a contiguous "
                    f"float32 tensor on {dev} shaped {tuple(shape)}, got "
                    f"{g.dtype} {tuple(g.shape)} on {g.device}, contiguous "
                    f"{g.is_contiguous()}")
        ptrs = np.fromiter((g.data_ptr() for g in grads), dtype=np.int64,
                           count=len(grads))
        for (rows, idx), aligned in zip(self.tables, self._aligned):
            g = ptrs[idx]
            rows[:, GRAD] = g
            rows[:, -1] = aligned & ((g & 15) == 0)
        return self._launches


class TableCache:
    """The ``LeafSet`` of the last leaf set updated, rebuilt when its key
    (``leaf_set_key``) changes."""

    def __init__(self, max_leaves: int = MAX_LEAVES):
        self.max_leaves = max_leaves
        self._set: Optional[LeafSet] = None

    def get(self, columns) -> LeafSet:
        if self._set is None or self._set.key != leaf_set_key(columns):
            self._set = LeafSet(columns, self.max_leaves)
        return self._set
