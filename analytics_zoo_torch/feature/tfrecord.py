"""Pure-Python TFRecord reader/writer + tf.train.Example codec (port of
the JAX package's ``feature/tfrecord.py``: numpy and the stdlib).

Reference: ``TFDataset.from_tfrecord_file`` (pyzoo tf_dataset.py:479)
reads TFRecords through the tensorflow-hadoop input format; SURVEY.md
§2.9 calls for a pure-Python reader here (no TF dependency).

TFRecord framing (tensorflow/core/lib/io/record_writer.h):

    uint64 length            (little-endian)
    uint32 masked_crc32c(length bytes)
    byte   data[length]
    uint32 masked_crc32c(data)

CRC is CRC-32C (Castagnoli), masked with the rot-15 + magic recipe.
``Example`` parsing uses the in-house protobuf wire codec
(utils/pbwire.py) — schema from tensorflow/core/example/{example,
feature}.proto.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from analytics_zoo_torch.utils.pbwire import Field, Message

# one CRC-32C for this codec and the TensorBoard writer
from analytics_zoo_torch.utils.crc32c import (  # noqa: F401
    crc32c, masked_crc32c)


class CorruptRecordError(IOError):
    """A TFRecord frame failed validation: truncated header/payload or
    a crc mismatch.  Carries the file path and the BYTE OFFSET of the
    bad frame so a corrupt shard can be repaired / resharded without a
    hex-dump hunt."""

    def __init__(self, path: str, offset: int, reason: str):
        super().__init__(f"{path}: corrupt TFRecord at byte offset "
                         f"{offset}: {reason}")
        self.path = path
        self.offset = offset
        self.reason = reason


# ----------------------------------------------------------------- framing

def _read_frame(f, offset: int, path: str, check_crc: bool):
    """Read one framed record at ``offset`` (file position must already
    be there).  Returns the payload bytes, or None at clean EOF.

    The length-crc is ALWAYS verified before the length field is
    trusted: a corrupt 8-byte length would otherwise drive a
    multi-gigabyte read (or a bogus "truncated" report) from 12 bytes
    of garbage.  ``check_crc`` gates only the payload crc, whose cost
    scales with the data.
    """
    header = f.read(12)
    if not header:
        return None
    if len(header) < 12:
        raise CorruptRecordError(
            path, offset,
            f"truncated header ({len(header)} of 12 bytes)")
    length, length_crc = struct.unpack("<QI", header)
    if masked_crc32c(header[:8]) != length_crc:
        raise CorruptRecordError(path, offset, "length crc mismatch")
    data = f.read(length)
    if len(data) < length:
        raise CorruptRecordError(
            path, offset,
            f"truncated payload ({len(data)} of {length} bytes)")
    crc_bytes = f.read(4)
    if len(crc_bytes) < 4:
        raise CorruptRecordError(
            path, offset,
            f"truncated payload crc ({len(crc_bytes)} of 4 bytes)")
    if check_crc:
        (data_crc,) = struct.unpack("<I", crc_bytes)
        if masked_crc32c(data) != data_crc:
            raise CorruptRecordError(path, offset, "payload crc mismatch")
    return data


def read_tfrecord(path: str, check_crc: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads from one TFRecord file."""
    with open(path, "rb") as f:
        offset = 0
        while True:
            data = _read_frame(f, offset, path, check_crc)
            if data is None:
                return
            offset += 12 + len(data) + 4
            yield data


def index_tfrecord(path: str, check_crc: bool = True
                   ) -> Iterator[tuple]:
    """Yield ``(offset, length)`` for every frame in one file — the
    random-access index for ``data.source.TFRecordSource``.  Walks the
    framing by seeking over payloads, so indexing cost is header IO
    only; with ``check_crc`` the payloads are read and verified too
    (one up-front integrity pass instead of a mid-epoch crash)."""
    with open(path, "rb") as f:
        offset = 0
        size = os.fstat(f.fileno()).st_size
        while True:
            if check_crc:
                data = _read_frame(f, offset, path, True)
                if data is None:
                    return
                length = len(data)
            else:
                header = f.read(12)
                if not header:
                    return
                if len(header) < 12:
                    raise CorruptRecordError(
                        path, offset,
                        f"truncated header ({len(header)} of 12 bytes)")
                length, length_crc = struct.unpack("<QI", header)
                if masked_crc32c(header[:8]) != length_crc:
                    raise CorruptRecordError(path, offset,
                                             "length crc mismatch")
                end = f.seek(length + 4, os.SEEK_CUR)
                if end > size:
                    raise CorruptRecordError(
                        path, offset,
                        f"truncated payload (frame ends at {end}, file "
                        f"is {size} bytes)")
            yield offset, length
            offset += 12 + length + 4


def read_record_at(f, offset: int, check_crc: bool = True,
                   path: str = "<tfrecord>") -> bytes:
    """Random-access read of one frame at a known ``offset`` from an
    open binary file handle."""
    f.seek(offset)
    data = _read_frame(f, offset, path, check_crc)
    if data is None:
        raise CorruptRecordError(path, offset, "offset is at/past EOF")
    return data


def write_tfrecord(path: str, records: Sequence[bytes]) -> None:
    with open(path, "wb") as f:
        for data in records:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(data)
            f.write(struct.pack("<I", masked_crc32c(data)))


# ----------------------------------------- tf.train.Example proto schema

class BytesList(Message):
    FIELDS = [Field(1, "value", "bytes", repeated=True)]


class FloatList(Message):
    FIELDS = [Field(1, "value", "float", repeated=True)]


class Int64List(Message):
    FIELDS = [Field(1, "value", "int64", repeated=True)]


class Feature(Message):
    FIELDS = [
        Field(1, "bytes_list", "msg", msg_cls=BytesList),
        Field(2, "float_list", "msg", msg_cls=FloatList),
        Field(3, "int64_list", "msg", msg_cls=Int64List),
    ]


class FeatureEntry(Message):
    """map<string, Feature> entry."""
    FIELDS = [
        Field(1, "key", "string"),
        Field(2, "value", "msg", msg_cls=Feature),
    ]


class Features(Message):
    FIELDS = [Field(1, "feature", "msg", repeated=True,
                    msg_cls=FeatureEntry)]


class Example(Message):
    FIELDS = [Field(1, "features", "msg", msg_cls=Features)]


def parse_example(data: bytes) -> Dict[str, np.ndarray]:
    """Decode one serialized tf.train.Example into name → ndarray."""
    ex = Example.decode(data)
    out: Dict[str, np.ndarray] = {}
    if ex.features is None:
        return out
    for entry in ex.features.feature:
        feat = entry.value
        if feat is None:
            continue
        if feat.int64_list is not None and feat.int64_list.value:
            out[entry.key] = np.asarray(feat.int64_list.value, np.int64)
        elif feat.float_list is not None and feat.float_list.value:
            out[entry.key] = np.asarray(feat.float_list.value, np.float32)
        elif feat.bytes_list is not None and feat.bytes_list.value:
            out[entry.key] = np.asarray(feat.bytes_list.value, object)
        else:
            out[entry.key] = np.asarray([], np.float32)
    return out


def make_example(features: Dict[str, object]) -> bytes:
    """Encode name → (ints | floats | bytes) into a tf.train.Example."""
    entries = []
    for name, value in features.items():
        arr = np.asarray(value)
        if arr.dtype.kind in "iu b".replace(" ", ""):
            feat = Feature(int64_list=Int64List(
                value=[int(v) for v in arr.ravel()]))
        elif arr.dtype.kind == "f":
            feat = Feature(float_list=FloatList(
                value=[float(v) for v in arr.ravel()]))
        else:
            vals = [v if isinstance(v, bytes) else str(v).encode()
                    for v in np.atleast_1d(arr)]
            feat = Feature(bytes_list=BytesList(value=vals))
        entries.append(FeatureEntry(key=name, value=feat))
    return Example(features=Features(feature=entries)).encode()


# -------------------------------------------------- dataset-level helpers

def read_examples(paths, check_crc: bool = True
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Iterate parsed Examples over one path, a glob, or a list."""
    import glob as _glob
    if isinstance(paths, (str, os.PathLike)):
        paths = sorted(_glob.glob(str(paths))) or [str(paths)]
    for p in paths:
        for rec in read_tfrecord(p, check_crc=check_crc):
            yield parse_example(rec)


def load_tfrecord_arrays(paths, feature_names: Optional[List[str]] = None
                         ) -> Dict[str, np.ndarray]:
    """Materialise TFRecord Examples into stacked arrays (fixed-shape
    features only) — the eager path feeding FeatureSet."""
    cols: Dict[str, List[np.ndarray]] = {}
    for ex in read_examples(paths):
        for k, v in ex.items():
            if feature_names is None or k in feature_names:
                cols.setdefault(k, []).append(v)
    return {k: np.stack(vs) for k, vs in cols.items()}
