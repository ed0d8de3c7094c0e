"""TensorBoard event-file writer, dependency-free.

Reference parity: the reference ships a pure-Scala TensorBoard writer
(tensorboard/FileWriter.scala:32, EventWriter.scala:32, CRC-framed
records in RecordWriter.scala:30, Summary.scala:31).  This is the same
thing in pure Python: hand-encoded ``Event`` protobufs in the TFRecord
framing (length + masked-crc32c), so standard TensorBoard can read the
logs without TF in the dependency chain.

Wire format per record:
    uint64 length | uint32 masked_crc32c(length) | bytes data |
    uint32 masked_crc32c(data)
Event proto fields used: wall_time(1, double), step(2, int64),
file_version(3, string), summary(5, message) with
Summary.Value{tag(1, string), simple_value(2, float)}.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# one CRC-32C for the TensorBoard writer and the TFRecord codec
from analytics_zoo_torch.utils.crc32c import crc32c, masked_crc32c  # noqa: F401


# ------------------------------------------------------- proto primitives
def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _f_string(field: int, v: str) -> bytes:
    return _f_bytes(field, v.encode())


def encode_scalar_event(tag: str, value: float, step: int,
                        wall_time: Optional[float] = None) -> bytes:
    summary_value = _f_string(1, tag) + _f_float(2, float(value))
    summary = _f_bytes(1, summary_value)
    return (_f_double(1, wall_time if wall_time is not None
                      else time.time()) +
            _f_int64(2, int(step)) +
            _f_bytes(5, summary))


def encode_file_version(wall_time: Optional[float] = None) -> bytes:
    return (_f_double(1, wall_time if wall_time is not None
                      else time.time()) +
            _f_string(3, "brain.Event:2"))


def frame_record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) +
            data + struct.pack("<I", masked_crc32c(data)))


class TBEventWriter:
    """Append-only tfevents file TensorBoard can load."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._f.write(frame_record(encode_file_version()))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(frame_record(
            encode_scalar_event(tag, value, step)))
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()
