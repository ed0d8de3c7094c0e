"""Checkpoint serialization (port of the JAX package's
``utils/serialization.py``).

Reference checkpointing (SURVEY.md §5): timestamped ``model.<ts>`` +
``optimMethod-<name>.<ts>`` snapshot files with latest-file resume
(Topology.scala:1293-1306, getLatestFile :1519).  The JAX package keeps
the same latest-snapshot directory contract with payloads in flax's
msgpack state-dict layout, written atomically.  The port writes and reads
that layout itself (``utils/msgpack_codec.py``, no flax and no msgpack),
so a file either package writes loads into the other.

State-dict rules, as flax's ``to_state_dict``/``from_state_dict``: dict
keys become ``str``, a namedtuple is a map of its fields, a tuple or list
a map keyed ``"0"``, ``"1"``, ...; restoring follows the target ``like``:
its structure, and for every tensor leaf its shape, dtype and device.
Unlike flax, a missing or extra key, a shape or a dtype that differs
raises ``ValueError`` (flax ignores extra keys and takes any array).
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Optional

import torch

from analytics_zoo_torch.common.fsutil import \
    atomic_write_bytes as _atomic_write
from analytics_zoo_torch.utils import msgpack_codec as codec

log = logging.getLogger("analytics_zoo_torch")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_state_dict(tree) -> Any:
    """flax's state dict of ``tree``."""
    if isinstance(tree, dict):
        out = {str(k): to_state_dict(v) for k, v in tree.items()}
        if len(out) != len(tree):
            raise ValueError("Dict keys do not have a unique string "
                             f"representation: {list(tree)}")
        return out
    if _is_namedtuple(tree):
        return {f: to_state_dict(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def _keys_match(like_keys, state, path: str) -> None:
    if not isinstance(state, dict):
        raise ValueError(f"checkpoint {path or '/'}: expected a map, got "
                         f"{type(state).__name__}")
    want = set(like_keys)
    missing, extra = sorted(want - state.keys()), sorted(
        set(map(str, state)) - want)
    if missing or extra:
        raise ValueError(f"checkpoint {path or '/'}: the target's keys "
                         f"differ (missing {missing}, extra {extra})")


def _leaf(like, state, path: str):
    if isinstance(like, torch.Tensor):
        if not isinstance(state, codec.RawArray):
            raise ValueError(f"checkpoint {path}: expected an array, got "
                             f"{type(state).__name__}")
        if tuple(state.shape) != tuple(like.shape) or \
                state.dtype != like.dtype:
            raise ValueError(
                f"checkpoint {path}: {tuple(state.shape)} {state.dtype} "
                f"does not match the target's {tuple(like.shape)} "
                f"{like.dtype}")
        return state.tensor(like.device)
    # a scalar, None or str leaf: the stored value, as flax returns it
    if isinstance(state, codec.RawArray):
        return state.tensor("cpu")
    return state


def _restore(like, state, path: str):
    if isinstance(like, dict):
        _keys_match([str(k) for k in like], state, path)
        return {k: _restore(v, state[str(k)], f"{path}/{k}")
                for k, v in like.items()}
    if _is_namedtuple(like):
        _keys_match(like._fields, state, path)
        return type(like)(**{f: _restore(getattr(like, f), state[f],
                                         f"{path}/{f}")
                             for f in like._fields})
    if isinstance(like, (list, tuple)):
        _keys_match([str(i) for i in range(len(like))], state, path)
        return type(like)(_restore(v, state[str(i)], f"{path}/{i}")
                          for i, v in enumerate(like))
    return _leaf(like, state, path)


def from_state_dict(like, state):
    """``like`` with its leaves from ``state`` (a state dict whose arrays
    are :class:`~msgpack_codec.RawArray` views, as ``unpackb`` without a
    device returns them)."""
    return _restore(like, state, "")


def to_bytes(tree) -> bytes:
    """flax's ``to_bytes``: the msgpack bytes of ``tree``'s state dict."""
    return codec.packb(to_state_dict(tree))


def from_bytes(like, data):
    """flax's ``from_bytes``, strict: ``like``'s structure with the
    leaves in ``data``, each tensor on its ``like`` leaf's device."""
    return from_state_dict(like, codec.unpackb(data))


def save_variables(path: str, variables: Any, over_write: bool = True
                   ) -> None:
    from analytics_zoo_torch.utils import file_io
    if file_io.is_remote(path):
        # remote stores (gs://, s3://, hdfs://...) — the reference's
        # File.saveBytes role; object stores commit on close
        if not over_write and file_io.exists(path):
            raise FileExistsError(path)
        file_io.write_bytes(path, to_bytes(variables))
        return
    if os.path.exists(path) and not over_write:
        raise FileExistsError(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _atomic_write(path, to_bytes(variables))


def load_variables(path: str, like: Any) -> Any:
    """Load a tree saved by ``save_variables`` (by either package).

    The primary path matches by structure (layer names).  If names
    differ — e.g. the model was rebuilt in the same process so
    auto-names shifted (``dense_1`` → ``dense_3``) — it falls back to
    positional matching (leaves in sorted-key order, as the reference's
    ``jax.tree_util`` flattening) with a strict shape and dtype check;
    where that fails too, the first error is raised."""
    from analytics_zoo_torch.pipeline.api.keras.topology import (
        tree_leaves, tree_replace)
    from analytics_zoo_torch.utils import file_io
    raw = codec.unpackb(file_io.read_bytes(path))
    try:
        return from_state_dict(like, raw)
    except ValueError:
        raw_leaves = tree_leaves(raw)
        like_leaves = tree_leaves(like)
        if len(raw_leaves) != len(like_leaves) or not all(
                isinstance(r, codec.RawArray) and
                isinstance(t, torch.Tensor) and
                tuple(r.shape) == tuple(t.shape) and r.dtype == t.dtype
                for r, t in zip(raw_leaves, like_leaves)):
            raise
    log.warning("checkpoint %s: layer names differ from target; matched "
                "%d arrays positionally", path, len(raw_leaves))
    return tree_replace(like, [r.tensor(t.device)
                               for r, t in zip(raw_leaves, like_leaves)])


class Checkpoint:
    """Timestamped snapshot dir with latest-resume and retention."""

    PATTERN = re.compile(r"snapshot\.(\d+)\.ckpt$")

    def __init__(self, directory: str, keep: Optional[int] = None):
        from analytics_zoo_torch.common.config import get_config
        self.directory = directory
        self.keep = keep if keep is not None \
            else int(get_config().get("checkpoint.keep"))
        os.makedirs(directory, exist_ok=True)

    def save(self, payload: Any, step: int) -> str:
        path = os.path.join(self.directory, f"snapshot.{step}.ckpt")
        _atomic_write(path, to_bytes(payload))
        self._retain()
        return path

    def latest_path(self) -> Optional[str]:
        best, best_step = None, -1
        for name in os.listdir(self.directory):
            m = self.PATTERN.match(name)
            if m and int(m.group(1)) > best_step:
                best_step = int(m.group(1))
                best = os.path.join(self.directory, name)
        return best

    def restore_latest(self, like: Any) -> Optional[Any]:
        """The latest snapshot restored into ``like``; None when the
        directory holds none.  A snapshot that cannot be read, or does
        not match ``like``, raises."""
        from analytics_zoo_torch.utils import file_io
        path = self.latest_path()
        if path is None:
            return None
        return from_bytes(like, file_io.read_bytes(path))

    def _retain(self) -> None:
        snaps = sorted(
            (int(self.PATTERN.match(n).group(1)), n)
            for n in os.listdir(self.directory) if self.PATTERN.match(n))
        while len(snaps) > self.keep:
            _, name = snaps.pop(0)
            try:
                os.remove(os.path.join(self.directory, name))
            except OSError:
                pass
