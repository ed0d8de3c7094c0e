"""Data sources — random-access record stores feeding the pipeline (port
of the JAX package's ``data/source.py``: numpy and the stdlib).

Reference: the FeatureSet/DataSet backends (zoo/feature/FeatureSet.scala
partition caches; pyzoo tf_dataset.py factory matrix).  A ``Source`` is a
finite, indexable store whose row order NEVER changes, so a (seed,
epoch, step) triple fully determines every batch — the property the
checkpointable :class:`~analytics_zoo_torch.data.pipeline.DataPipeline`
is built on.

Contract::

    len(source)          -> number of records
    source[i]            -> one sample tree (row i)
    source.gather(idx)   -> batched tree for an int array of rows
                            (columnar sources override with a single
                            vectorised take; the default stacks rows)

Samples are ``(x, y)`` tuples (``y`` may be ``None``) or any tree of
dicts, lists and tuples of arrays a model's step accepts; ``gather``
returns the same structure with a leading batch axis on every leaf.
``None`` is an empty subtree, as in the reference's pytrees.  A columnar
gather is ``np.take`` per leaf: the reference's native ``gather_rows``
is an accelerator over the same bytes.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts/lists/tuples (and the
    matching leaves of ``rest``); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*vals)
        return type(tree)(vals)
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves, dict keys sorted (the reference's pytree order);
    ``None`` contributes none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _tree_rows(tree) -> int:
    leaves = tree_leaves(tree)
    return len(leaves[0]) if leaves else 0


def _stack(*leaves):
    return np.stack([np.asarray(leaf) for leaf in leaves])


def _tree_take(tree, idx: np.ndarray):
    def take(a):
        if isinstance(a, np.ndarray) and a.ndim >= 1:
            return np.take(a, idx, axis=0)
        return a[idx]
    return tree_map(take, tree)


class Source:
    """Base class / protocol for random-access record stores."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, i: int):
        raise NotImplementedError

    def gather(self, idx: np.ndarray):
        """Batched row gather — default stacks per-row samples."""
        rows = [self[int(i)] for i in idx]
        return tree_map(_stack, *rows)


class ArraySource(Source):
    """Columnar in-memory (or memory-mapped) source: ``x``/``y`` are
    numpy trees with a shared leading sample axis — a minibatch is one
    vectorised take per leaf."""

    def __init__(self, x, y=None):
        self.x = tree_map(np.asarray, x)
        self.y = tree_map(np.asarray, y)
        self._n = _tree_rows(self.x)
        if self.y is not None and _tree_rows(self.y) != self._n:
            raise ValueError(
                f"x has {self._n} rows, y has {_tree_rows(self.y)}")

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int):
        def take(t):
            return tree_map(lambda a: a[i], t)
        return (take(self.x), take(self.y) if self.y is not None else None)

    def gather(self, idx: np.ndarray):
        return (_tree_take(self.x, idx),
                _tree_take(self.y, idx) if self.y is not None else None)

    def nbytes(self) -> int:
        return sum(a.nbytes for a in tree_leaves((self.x, self.y)))


class NpyDirSource(ArraySource):
    """``x.npy`` (+ optional ``y.npy``) directory, memory-mapped by
    default so bigger-than-RAM data pages on demand — the PMEM tier of
    the reference's cache hierarchy (FeatureSet.scala:585-662)."""

    def __init__(self, path: str, memory_map: bool = True):
        mmap = "r" if memory_map else None
        x = np.load(os.path.join(path, "x.npy"), mmap_mode=mmap)
        ypath = os.path.join(path, "y.npy")
        y = np.load(ypath, mmap_mode=mmap) if os.path.exists(ypath) \
            else None
        super().__init__(x, y)
        self.path = path


class TFRecordSource(Source):
    """TFRecord-backed source with random access by byte offset.

    One sequential header scan (``index_tfrecord`` — lengths + crc
    checks only, no payload parse) builds a ``(file, offset)`` index;
    ``__getitem__`` then seeks straight to a record, so a shuffled epoch
    costs one seek+read per record instead of a full-file decode pass.

    ``decode`` maps the raw record bytes to a sample; the default
    parses a ``tf.train.Example`` into a feature dict
    (``feature/tfrecord.py``).
    """

    def __init__(self, paths, decode: Optional[Callable[[bytes], Any]]
                 = None, check_crc: bool = True):
        import glob as _glob
        import threading
        from analytics_zoo_torch.feature.tfrecord import (
            index_tfrecord, parse_example)
        if isinstance(paths, (str, os.PathLike)):
            paths = sorted(_glob.glob(str(paths))) or [str(paths)]
        self.paths: List[str] = [str(p) for p in paths]
        self.decode = decode if decode is not None else parse_example
        self.check_crc = check_crc
        self._index: List[tuple] = []   # (path_idx, offset, length)
        for pi, p in enumerate(self.paths):
            for off, length in index_tfrecord(p, check_crc=check_crc):
                self._index.append((pi, off, length))
        # handles are PER THREAD: reads are seek+read on a shared
        # position, so one handle used from the WorkerPool's threads
        # would interleave seeks and hand records across offsets
        self._local = threading.local()
        self._all_handles: List[Any] = []
        self._handles_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._index)

    def _file(self, pi: int):
        handles: Dict[int, Any] = getattr(self._local, "handles", None)
        if handles is None:
            handles = self._local.handles = {}
        f = handles.get(pi)
        if f is None or f.closed:
            f = open(self.paths[pi], "rb")
            handles[pi] = f
            with self._handles_lock:
                self._all_handles.append(f)
        return f

    def read_record(self, i: int) -> bytes:
        from analytics_zoo_torch.feature.tfrecord import read_record_at
        pi, off, _length = self._index[i]
        return read_record_at(self._file(pi), off,
                              check_crc=self.check_crc,
                              path=self.paths[pi])

    def __getitem__(self, i: int):
        return self.decode(self.read_record(i))

    def close(self) -> None:
        with self._handles_lock:
            handles, self._all_handles = self._all_handles, []
        for f in handles:
            try:
                f.close()
            except OSError:
                pass

    def __del__(self):  # best-effort handle cleanup
        if hasattr(self, "_handles_lock"):   # a failed index has none
            self.close()


def as_source(data, y=None) -> Source:
    """Coerce ndarrays / trees / an existing Source into a Source."""
    if isinstance(data, Source):
        return data
    return ArraySource(data, y)
