"""Minimal pure-Python protobuf wire-format codec (port of the JAX
package's ``utils/pbwire.py``, the same code: stdlib only).

The reference carries it for its ONNX and Caffe importers and for the
``tf.train.Example`` schema of ``feature/tfrecord.py``; the port uses it
for the latter.  Schema-driven: a message class lists its fields once;
decode/encode are generic.  Handles varint / 32-bit / 64-bit /
length-delimited wire types and packed repeated scalars (proto3 default
packs them; proto2 writers emit them one record per element — both forms
are accepted).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

WT_VARINT = 0
WT_FIXED64 = 1
WT_BYTES = 2
WT_FIXED32 = 5


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long (corrupt stream)")


def write_varint(value: int) -> bytes:
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement 64-bit, per protobuf
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag_decode(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _signed64(v: int) -> int:
    """Interpret a decoded varint as a signed 64-bit int."""
    if v >= 1 << 63:
        v -= 1 << 64
    return v


class Field:
    """One field of a message schema."""

    __slots__ = ("number", "name", "kind", "repeated", "msg_cls")

    def __init__(self, number: int, name: str, kind: str,
                 repeated: bool = False, msg_cls=None):
        # kind: int64 | uint64 | sint64 | bool | enum | float | double |
        #       bytes | string | msg
        self.number = number
        self.name = name
        self.kind = kind
        self.repeated = repeated
        self.msg_cls = msg_cls


class Message:
    """Base class for schema-declared messages.

    Subclasses set ``FIELDS = [Field(...), ...]``.  Decoded instances get
    one attribute per field (repeated -> list, scalar -> value or default).
    Unknown fields are skipped on decode and dropped on encode.
    """

    FIELDS: List[Field] = []
    _by_number: Dict[int, Field]

    def __init__(self, **kwargs):
        for f in self.FIELDS:
            if f.repeated:
                setattr(self, f.name, list(kwargs.get(f.name, [])))
            else:
                setattr(self, f.name, kwargs.get(f.name, _default(f)))
        bad = set(kwargs) - {f.name for f in self.FIELDS}
        if bad:
            raise TypeError(f"{type(self).__name__}: unknown fields {bad}")

    # ------------------------------------------------------------- decoding
    @classmethod
    def decode(cls, buf: bytes) -> "Message":
        by_num = getattr(cls, "_by_number_cache", None)
        if by_num is None:
            by_num = {f.number: f for f in cls.FIELDS}
            cls._by_number_cache = by_num
        msg = cls()
        pos, end = 0, len(buf)
        while pos < end:
            tag, pos = read_varint(buf, pos)
            field_num, wt = tag >> 3, tag & 0x7
            f = by_num.get(field_num)
            if wt == WT_VARINT:
                raw, pos = read_varint(buf, pos)
                if f is not None:
                    _store(msg, f, _conv_varint(raw, f.kind))
            elif wt == WT_FIXED64:
                raw = buf[pos:pos + 8]
                pos += 8
                if f is not None:
                    val = (struct.unpack("<d", raw)[0]
                           if f.kind == "double"
                           else struct.unpack("<q", raw)[0])
                    _store(msg, f, val)
            elif wt == WT_FIXED32:
                raw = buf[pos:pos + 4]
                pos += 4
                if f is not None:
                    val = (struct.unpack("<f", raw)[0]
                           if f.kind == "float"
                           else struct.unpack("<i", raw)[0])
                    _store(msg, f, val)
            elif wt == WT_BYTES:
                ln, pos = read_varint(buf, pos)
                chunk = buf[pos:pos + ln]
                pos += ln
                if f is None:
                    continue
                if f.kind == "msg":
                    _store(msg, f, f.msg_cls.decode(chunk))
                elif f.kind == "string":
                    _store(msg, f, chunk.decode("utf-8", "replace"))
                elif f.kind == "bytes":
                    _store(msg, f, bytes(chunk))
                else:
                    # packed repeated scalars
                    for v in _unpack_packed(chunk, f.kind):
                        _store(msg, f, v)
            else:
                raise ValueError(f"unsupported wire type {wt}")
        return msg

    # ------------------------------------------------------------- encoding
    def encode(self) -> bytes:
        out = bytearray()
        for f in self.FIELDS:
            val = getattr(self, f.name)
            if f.repeated:
                if not val:
                    continue
                if f.kind in ("msg", "string", "bytes"):
                    for v in val:
                        out += _encode_len_delim(f, v)
                else:
                    # pack scalars
                    body = bytearray()
                    for v in val:
                        body += _encode_scalar_raw(f.kind, v)
                    out += write_varint((f.number << 3) | WT_BYTES)
                    out += write_varint(len(body))
                    out += body
            else:
                if val is None or (val == _default(f) and f.kind != "msg"):
                    continue
                if f.kind in ("msg", "string", "bytes"):
                    out += _encode_len_delim(f, val)
                elif f.kind == "float":
                    out += write_varint((f.number << 3) | WT_FIXED32)
                    out += struct.pack("<f", val)
                elif f.kind == "double":
                    out += write_varint((f.number << 3) | WT_FIXED64)
                    out += struct.pack("<d", val)
                else:
                    out += write_varint((f.number << 3) | WT_VARINT)
                    out += _encode_varint_kind(f.kind, val)
        return bytes(out)

    def __repr__(self):
        parts = []
        for f in self.FIELDS:
            v = getattr(self, f.name)
            if v in (None, [], "", b"", 0, 0.0):
                continue
            parts.append(f"{f.name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


def _default(f: Field):
    if f.kind in ("int64", "uint64", "sint64", "enum"):
        return 0
    if f.kind == "bool":
        return False
    if f.kind in ("float", "double"):
        return 0.0
    if f.kind == "string":
        return ""
    if f.kind == "bytes":
        return b""
    return None  # msg


def _conv_varint(raw: int, kind: str):
    if kind == "bool":
        return bool(raw)
    if kind == "sint64":
        return _zigzag_decode(raw)
    if kind == "int64":
        return _signed64(raw)
    return raw  # uint64 / enum


def _store(msg: Message, f: Field, val: Any):
    if f.repeated:
        getattr(msg, f.name).append(val)
    else:
        setattr(msg, f.name, val)


def _unpack_packed(chunk: bytes, kind: str) -> List[Any]:
    vals: List[Any] = []
    if kind == "float":
        n = len(chunk) // 4
        return list(struct.unpack(f"<{n}f", chunk[:4 * n]))
    if kind == "double":
        n = len(chunk) // 8
        return list(struct.unpack(f"<{n}d", chunk[:8 * n]))
    pos = 0
    while pos < len(chunk):
        raw, pos = read_varint(chunk, pos)
        vals.append(_conv_varint(raw, kind))
    return vals


def _encode_varint_kind(kind: str, val) -> bytes:
    if kind == "bool":
        return write_varint(1 if val else 0)
    if kind == "sint64":
        return write_varint((val << 1) ^ (val >> 63))
    return write_varint(int(val))


def _encode_scalar_raw(kind: str, val) -> bytes:
    if kind == "float":
        return struct.pack("<f", val)
    if kind == "double":
        return struct.pack("<d", val)
    return _encode_varint_kind(kind, val)


def _encode_len_delim(f: Field, val) -> bytes:
    if f.kind == "msg":
        body = val.encode()
    elif f.kind == "string":
        body = val.encode("utf-8")
    else:
        body = bytes(val)
    return (write_varint((f.number << 3) | WT_BYTES)
            + write_varint(len(body)) + body)
