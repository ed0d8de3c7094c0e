"""The msgpack layout of the JAX package's checkpoint files, in the
standard library.

The JAX package writes its checkpoints with ``flax.serialization``:
``msgpack.packb(state_dict, default=_msgpack_ext_pack,
strict_types=True)``.  This module writes and reads the same bytes with
``struct`` alone, so the port needs neither flax nor msgpack:

* nil, bool, int (the smallest width msgpack picks), float (float64),
  str, bin, array (a list) and map (a dict, in its key order);
* ext 1, an array: a packed ``(shape, dtype name, C-order bytes)``
  triple.  A ``torch.Tensor`` is written from its bytes (a CPU copy;
  bfloat16 through an int16 view) and a ``numpy.ndarray`` likewise;
* ext 3, a numpy scalar, packed as a 0-d array;
* an array leaf of more than ``MAX_CHUNK_SIZE`` bytes that is the tree
  itself or a value of maps within maps is written as flax's chunked map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
  "chunks": {"0": flat part, ...}}`` and joined again on read.

With ``strict_types``, as flax packs, only exact ``dict``, ``list``,
``int``, ``float``, ``str``, ``bytes`` and ``bool`` are msgpack's own
types: a tuple, a namedtuple or an ``int`` subclass is refused here as
msgpack refuses it (``serialization.to_state_dict`` turns namedtuples,
tuples and lists into maps first, as flax's does).

``packb(tree)`` is byte-identical to ``flax.serialization.
msgpack_serialize(tree, in_place=True)`` for a tree of the same key
order.  ``unpackb(data, device)`` decodes to the same tree with torch
tensors on ``device`` (flax's ``msgpack_restore``); ``unpackb(data)``
without a device leaves each array a :class:`RawArray`, a view of the
bytes that becomes a tensor where its destination is known.  Truncated
or malformed bytes raise ``ValueError``.
"""

from __future__ import annotations

import math
import struct
import warnings
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: msgpack holds at most 2**31 - 1
# bytes in one object; flax leaves a margin.  Read at each call, so a
# test can lower it.
MAX_CHUNK_SIZE = 2 ** 30

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"

# dtype name as numpy (and flax) writes it -> (torch dtype, numpy dtype
# of the stored bytes)
_DTYPES = {
    "bool": (torch.bool, np.dtype(np.bool_)),
    "uint8": (torch.uint8, np.dtype(np.uint8)),
    "int8": (torch.int8, np.dtype(np.int8)),
    "int16": (torch.int16, np.dtype(np.int16)),
    "int32": (torch.int32, np.dtype(np.int32)),
    "int64": (torch.int64, np.dtype(np.int64)),
    "float16": (torch.float16, np.dtype(np.float16)),
    "float32": (torch.float32, np.dtype(np.float32)),
    "float64": (torch.float64, np.dtype(np.float64)),
    "complex64": (torch.complex64, np.dtype(np.complex64)),
    "complex128": (torch.complex128, np.dtype(np.complex128)),
    # numpy has no bfloat16: its bytes go through int16
    "bfloat16": (torch.bfloat16, np.dtype(np.int16)),
}
_TORCH_NAMES = {t: name for name, (t, _) in _DTYPES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """The name numpy (and flax) writes for a torch dtype."""
    try:
        return _TORCH_NAMES[dtype]
    except KeyError:
        raise TypeError(f"no checkpoint dtype for {dtype}") from None


# ----------------------------------------------------------------- encoder
def _int(v: int) -> bytes:
    # msgpack's choice: positive fixint, else the smallest unsigned
    # width; negative fixint, else the smallest signed width
    if v >= 0:
        if v < 0x80:
            return struct.pack("B", v)
        if v < 0x100:
            return struct.pack(">BB", 0xCC, v)
        if v < 0x10000:
            return struct.pack(">BH", 0xCD, v)
        if v < 0x100000000:
            return struct.pack(">BI", 0xCE, v)
        if v < 0x10000000000000000:
            return struct.pack(">BQ", 0xCF, v)
    else:
        if v >= -32:
            return struct.pack("b", v)
        if v >= -0x80:
            return struct.pack(">Bb", 0xD0, v)
        if v >= -0x8000:
            return struct.pack(">Bh", 0xD1, v)
        if v >= -0x80000000:
            return struct.pack(">Bi", 0xD2, v)
        if v >= -0x8000000000000000:
            return struct.pack(">Bq", 0xD3, v)
    raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")


def _sized(n: int, fix: Optional[Tuple[int, int]], codes) -> bytes:
    """Header of a str/bin/array/map of ``n`` items: a fix form below
    ``fix[1]``, else the 8/16/32-bit forms in ``codes`` (None: absent)."""
    if fix is not None and n < fix[1]:
        return struct.pack("B", fix[0] | n)
    c8, c16, c32 = codes
    if c8 is not None and n < 0x100:
        return struct.pack(">BB", c8, n)
    if n < 0x10000:
        return struct.pack(">BH", c16, n)
    if n < 0x100000000:
        return struct.pack(">BI", c32, n)
    raise ValueError(f"msgpack object of {n} items or bytes")


def _str_header(n: int) -> bytes:
    return _sized(n, (0xA0, 32), (0xD9, 0xDA, 0xDB))


def _bin_header(n: int) -> bytes:
    return _sized(n, None, (0xC4, 0xC5, 0xC6))


def _array_header(n: int) -> bytes:
    return _sized(n, (0x90, 16), (None, 0xDC, 0xDD))


def _map_header(n: int) -> bytes:
    return _sized(n, (0x80, 16), (None, 0xDE, 0xDF))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return struct.pack(">Bb", fixed[n], code)
    if n < 0x100:
        return struct.pack(">BBb", 0xC7, n, code)
    if n < 0x10000:
        return struct.pack(">BHb", 0xC8, n, code)
    if n < 0x100000000:
        return struct.pack(">BIb", 0xC9, n, code)
    raise ValueError(f"msgpack ext of {n} bytes")


def _array_bytes(x) -> Tuple[Tuple[int, ...], str, Any]:
    """(shape, dtype name, a 1-D uint8 buffer of the C-order bytes)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        name = dtype_name(t.dtype)
        shape = tuple(int(d) for d in t.shape)
        t = t.to("cpu").contiguous().reshape(-1)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.numpy()
    else:
        arr = np.asarray(x)
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("Object and structured dtypes not supported "
                             "for serialization of ndarrays.")
        name, shape = arr.dtype.name, tuple(int(d) for d in arr.shape)
        arr = np.ascontiguousarray(arr).reshape(-1)
    return shape, name, arr.view(np.uint8)


def _pack_array(parts: List, code: int, x) -> None:
    shape, name, data = _array_bytes(x)
    inner = [_array_header(3), _array_header(len(shape))]
    inner += [_int(d) for d in shape]
    encoded = name.encode("utf-8")
    inner += [_str_header(len(encoded)), encoded, _bin_header(data.nbytes)]
    head = b"".join(inner)
    parts.append(_ext_header(code, len(head) + data.nbytes) + head)
    if data.nbytes:
        parts.append(memoryview(data))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunked(x) -> dict:
    """flax's ``_chunk``: the flat array in parts of at most
    ``MAX_CHUNK_SIZE`` bytes."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) \
        else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in
                       enumerate(range(0, n, size))}}


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _pack(parts: List, x, chunk: bool) -> None:
    """``chunk``: an oversized array here is chunked (the tree itself, or a
    value of maps within maps, where flax's
    ``_chunk_array_leaves_in_place`` looks)."""
    t = type(x)
    if x is None:
        parts.append(b"\xc0")
    elif t is bool:
        parts.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        parts.append(_int(x))
    elif t is float:
        parts.append(struct.pack(">Bd", 0xCB, x))
    elif t is str:
        encoded = x.encode("utf-8")
        parts.append(_str_header(len(encoded)))
        parts.append(encoded)
    elif t is bytes or t is bytearray:
        parts.append(_bin_header(len(x)))
        parts.append(bytes(x))
    elif t is dict:
        parts.append(_map_header(len(x)))
        for k, v in x.items():
            _pack(parts, k, False)
            _pack(parts, v, chunk)
    elif t is list:
        parts.append(_array_header(len(x)))
        for v in x:
            _pack(parts, v, False)
    elif _is_array(x):
        if chunk and _nbytes(x) > MAX_CHUNK_SIZE:
            _pack(parts, _chunked(x), False)
        else:
            _pack_array(parts, EXT_NDARRAY, x)
    elif isinstance(x, np.generic):
        _pack_array(parts, EXT_NPSCALAR, np.asarray(x))
    else:
        raise TypeError(f"can not serialize {type(x).__name__!r} object")


def packb(tree) -> bytes:
    """msgpack bytes of ``tree`` in flax's layout: one join of the headers
    and the arrays' bytes."""
    parts: List = []
    _pack(parts, tree, True)
    return b"".join(parts)


# ----------------------------------------------------------------- decoder
class RawArray:
    """An array read from the bytes and not yet a tensor: its torch dtype,
    shape and the views of its bytes (one, or a chunked array's parts)."""

    __slots__ = ("dtype", "shape", "parts", "_np")

    def __init__(self, dtype: torch.dtype, shape: Tuple[int, ...],
                 parts: List[memoryview], np_dtype: np.dtype):
        self.dtype, self.shape, self.parts, self._np = (
            dtype, shape, parts, np_dtype)

    def tensor(self, device="cpu") -> torch.Tensor:
        """A new tensor on ``device`` holding the bytes (one copy a part,
        straight to the device)."""
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        flat = out.view(-1)
        if self.dtype == torch.bfloat16:
            flat = flat.view(torch.int16)
        at = 0
        with warnings.catch_warnings():
            # a view of read-only bytes is only ever the copy's source
            warnings.simplefilter("ignore", UserWarning)
            for part in self.parts:
                src = torch.from_numpy(np.frombuffer(part, self._np))
                flat[at:at + src.numel()].copy_(src)
                at += src.numel()
        return out


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack data truncated at byte {self.pos}: "
                             f"{n} more wanted, {len(self.buf) - self.pos} "
                             "left")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED_EXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _read(r: _Reader, raw_str: bool = False):
    b = r.unpack("B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r, raw_str) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r.take(b & 0x1F), raw_str)
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b in (0xC4, 0xC5, 0xC6):
        n = r.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
        return bytes(r.take(n))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        return _ext(r.unpack("b"), r.take(n))
    if b == 0xCA:
        return r.unpack(">f")
    if b == 0xCB:
        return r.unpack(">d")
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in ints:
        return r.unpack(ints[b])
    if b in _FIXED_EXT:
        code = r.unpack("b")
        return _ext(code, r.take(_FIXED_EXT[b]))
    if b in (0xD9, 0xDA, 0xDB):
        n = r.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
        return _str(r.take(n), raw_str)
    if b in (0xDC, 0xDD):
        n = r.unpack(">H" if b == 0xDC else ">I")
        return [_read(r, raw_str) for _ in range(n)]
    if b in (0xDE, 0xDF):
        return _read_map(r, r.unpack(">H" if b == 0xDE else ">I"))
    raise ValueError(f"not msgpack: byte 0x{b:02x} at {r.pos - 1}")


def _str(view: memoryview, raw: bool):
    if raw:
        return bytes(view)
    try:
        return str(view, "utf-8")
    except UnicodeDecodeError as e:
        raise ValueError(f"msgpack str is not utf-8: {e}") from None


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        if isinstance(k, (list, dict)):
            raise ValueError("msgpack map key is an array or a map")
        out[k] = _read(r)
    return out


def _raw_array(data: memoryview) -> RawArray:
    """The ``(shape, dtype name, bytes)`` triple of ext 1 and 3, its bytes
    kept a view of ``data``."""
    r = _Reader(data)
    if r.unpack("B") != 0x93:
        raise ValueError("malformed array in msgpack ext 1/3")
    shape, name = _read(r), _read(r, raw_str=True)
    if not isinstance(shape, list) or \
            not all(type(d) is int and d >= 0 for d in shape):
        raise ValueError(f"malformed array shape {shape!r}")
    if not isinstance(name, bytes):
        raise ValueError(f"malformed array dtype {name!r}")
    name = name.decode("utf-8", "replace")
    if name not in _DTYPES:
        raise ValueError(f"unsupported array dtype {name!r}")
    dtype, np_dtype = _DTYPES[name]
    b = r.unpack("B")
    if b not in (0xC4, 0xC5, 0xC6, 0xD9, 0xDA, 0xDB) and \
            not 0xA0 <= b <= 0xBF:
        raise ValueError("malformed array bytes in msgpack ext 1/3")
    n = b & 0x1F if 0xA0 <= b <= 0xBF else r.unpack(
        {0xC4: ">B", 0xD9: ">B", 0xC5: ">H", 0xDA: ">H"}.get(b, ">I"))
    nbytes = math.prod(shape) * np_dtype.itemsize
    if n != nbytes:
        raise ValueError(f"array of shape {tuple(shape)} {name} holds "
                         f"{n} bytes, not {nbytes}")
    view = r.take(n)
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes in msgpack ext 1/3")
    return RawArray(dtype, tuple(shape), [view], np_dtype)


def _ext(code: int, data: memoryview):
    if code == EXT_NDARRAY:
        return _raw_array(data)
    if code == EXT_NPSCALAR:
        raw = _raw_array(data)
        if raw.dtype == torch.bfloat16:
            return raw.tensor().reshape(())
        return np.frombuffer(raw.parts[0], raw._np).reshape(())[()]
    raise ValueError(f"unknown msgpack ext type {code}")


def _unchunk(d: dict) -> RawArray:
    try:
        shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    except (KeyError, TypeError):
        raise ValueError("malformed chunked array map") from None
    if not chunks or not all(isinstance(c, RawArray) and
                             c.dtype == chunks[0].dtype for c in chunks):
        raise ValueError("chunked array map without arrays of one dtype")
    parts = [p for c in chunks for p in c.parts]
    if sum(len(p) for p in parts) != \
            math.prod(shape) * chunks[0]._np.itemsize:
        raise ValueError(f"chunked array's parts do not fill {shape}")
    return RawArray(chunks[0].dtype, shape, parts, chunks[0]._np)


def _unchunk_leaves(d):
    """flax's ``_unchunk_array_leaves_in_place``: the tree itself, or
    maps within maps."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if CHUNKED in v else _unchunk_leaves(v)
    return d


def _materialize(tree, device):
    if isinstance(tree, RawArray):
        return tree.tensor(device)
    if isinstance(tree, dict):
        return {k: _materialize(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_materialize(v, device) for v in tree]
    return tree


def unpackb(data, device=None):
    """The tree in ``data`` (msgpack arrays as lists), chunked arrays
    joined.  With ``device``, each array a tensor there; without, a
    :class:`RawArray` view of ``data``."""
    r = _Reader(data)
    tree = _read(r)
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack data has {len(r.buf) - r.pos} bytes "
                         "after its object")
    tree = _unchunk_leaves(tree)
    return tree if device is None else _materialize(tree, device)
