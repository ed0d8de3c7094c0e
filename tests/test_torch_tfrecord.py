"""PyTorch port, TFRecord (``feature/tfrecord.py``, ``utils/pbwire.py``,
``utils/crc32c.py``, ``data.TFRecordSource``) against the JAX package:

- files written by either package are byte-identical and read by the
  other, with the same index offsets;
- ``tf.train.Example`` payloads encode and parse the same;
- corrupt and truncated records raise ``CorruptRecordError`` naming the
  same offset and reason in both;
- zero-length records round-trip;
- the CRC-32C is the reference's, one function shared with the
  TensorBoard writer;
- ``TFRecordSource`` samples and a shuffled pipeline's batches are
  equal."""

import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from analytics_zoo_tpu.data import DataPipeline as JDataPipeline
from analytics_zoo_tpu.data import TFRecordSource as JTFRecordSource
from analytics_zoo_tpu.feature import tfrecord as jtf
from analytics_zoo_tpu.native import crc32c as jcrc32c
from analytics_zoo_tpu.utils import pbwire as jpb

from analytics_zoo_torch.data import DataPipeline, TFRecordSource
from analytics_zoo_torch.feature import tfrecord as ttf
from analytics_zoo_torch.utils import crc32c as tcrc
from analytics_zoo_torch.utils import pbwire as tpb
from analytics_zoo_torch.utils import tb_writer


def _features(i):
    return {"id": np.array([i, -i, 1 << 40], np.int64),
            "v": np.linspace(0, 1, 5, dtype=np.float32) * i,
            "name": np.array([f"row-{i}".encode(), b"\x00\xff"],
                             dtype=object)}


def _records(n=9):
    return [ttf.make_example(_features(i)) for i in range(n)]


@settings(max_examples=40, deadline=None)
@given(st.binary(max_size=300))
def test_crc32c_is_the_references(data):
    assert tcrc.crc32c(data) == jcrc32c(data)
    assert tcrc.masked_crc32c(data) == jtf.masked_crc32c(data)


def test_one_crc_for_the_tensorboard_writer_and_tfrecord():
    assert tb_writer.crc32c is tcrc.crc32c is ttf.crc32c
    assert tb_writer.masked_crc32c is tcrc.masked_crc32c is \
        ttf.masked_crc32c


def test_examples_encode_and_parse_as_the_reference():
    for i in range(5):
        raw = ttf.make_example(_features(i))
        assert raw == jtf.make_example(_features(i))
        got, want = ttf.parse_example(raw), jtf.parse_example(raw)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            assert list(got[k]) == list(want[k])
    assert ttf.parse_example(b"") == jtf.parse_example(b"") == {}


def test_pbwire_messages_are_the_references():
    for t_cls, j_cls, kw in (
            (tpb.Message, jpb.Message, {}),
            (ttf.Int64List, jtf.Int64List, {"value": [0, -1, 1 << 62]}),
            (ttf.FloatList, jtf.FloatList, {"value": [0.5, -2.25]}),
            (ttf.BytesList, jtf.BytesList, {"value": [b"", b"ab"]})):
        raw = t_cls(**kw).encode()
        assert raw == j_cls(**kw).encode()
        assert t_cls.decode(raw).encode() == raw
    assert tpb.write_varint(-1) == jpb.write_varint(-1)
    assert tpb.read_varint(b"\xac\x02", 0) == jpb.read_varint(b"\xac\x02", 0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_are_byte_identical_and_read_by_the_other(writer, tmp_path):
    recs = _records()
    a, b = str(tmp_path / "a.tfrecord"), str(tmp_path / "b.tfrecord")
    (ttf if writer == "port" else jtf).write_tfrecord(a, recs)
    (jtf if writer == "port" else ttf).write_tfrecord(b, recs)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert list(ttf.read_tfrecord(a)) == list(jtf.read_tfrecord(a)) == recs
    for check in (True, False):
        assert list(ttf.index_tfrecord(a, check_crc=check)) == \
            list(jtf.index_tfrecord(a, check_crc=check))
    offsets = list(ttf.index_tfrecord(a))
    with open(a, "rb") as f:
        for i, (off, length) in enumerate(offsets):
            assert ttf.read_record_at(f, off) == recs[i]
            assert len(recs[i]) == length
    got = ttf.load_tfrecord_arrays(a, ["id", "v"])
    want = jtf.load_tfrecord_arrays(a, ["id", "v"])
    for k in ("id", "v"):
        assert got[k].tobytes() == want[k].tobytes()


def _corrupt(path, how):
    raw = bytearray(open(path, "rb").read())
    if how == "truncate_crc":
        raw = raw[:-3]
    elif how == "truncate_payload":
        raw = raw[:12 + 4 + 4 + 12 + 2]
    elif how == "truncate_header":
        raw = raw[:12 + 4 + 4 + 5]
    elif how == "length":
        raw[0] ^= 0xFF
    elif how == "payload":
        raw[12 + 4 + 4 + 12 + 1] ^= 0x01
    open(path, "wb").write(bytes(raw))


@pytest.mark.parametrize("how", ["truncate_crc", "truncate_payload",
                                 "truncate_header", "length", "payload"])
def test_corrupt_records_name_the_same_offset(how, tmp_path):
    path = str(tmp_path / "t.tfrecord")
    ttf.write_tfrecord(path, [b"aaaa", b"bbbb"])
    _corrupt(path, how)
    for reader in ("index", "read", "index_nocrc", "source"):
        errors = []
        for mod, source in ((ttf, TFRecordSource), (jtf, JTFRecordSource)):
            try:
                if reader == "index":
                    list(mod.index_tfrecord(path))
                elif reader == "index_nocrc":
                    list(mod.index_tfrecord(path, check_crc=False))
                elif reader == "read":
                    list(mod.read_tfrecord(path))
                else:
                    source(path)
            except mod.CorruptRecordError as e:
                errors.append((e.offset, e.reason, str(e)))
            else:
                errors.append(None)
        assert errors[0] == errors[1], (reader, errors)
        if how != "payload" or reader != "index_nocrc":
            assert errors[0] is not None, reader
    if how == "payload":
        # the payload's crc is checked only when asked
        assert list(ttf.read_tfrecord(path, check_crc=False))[1] != b"bbbb"
        with pytest.raises(ttf.CorruptRecordError, match="payload crc") as e:
            list(ttf.read_tfrecord(path))
        assert e.value.offset == 12 + 4 + 4
    with open(path, "rb") as f, pytest.raises(ttf.CorruptRecordError,
                                              match="past EOF"):
        ttf.read_record_at(f, 1 << 20)


def test_zero_length_records_round_trip(tmp_path):
    path = str(tmp_path / "z.tfrecord")
    ttf.write_tfrecord(path, [b"", b"x", b""])
    assert list(ttf.read_tfrecord(path)) == [b"", b"x", b""]
    assert list(jtf.read_tfrecord(path)) == [b"", b"x", b""]
    assert [l for _o, l in ttf.index_tfrecord(path)] == [0, 1, 0]
    assert list(ttf.index_tfrecord(path)) == list(jtf.index_tfrecord(path))


def test_tfrecord_source_and_pipeline_match(tmp_path):
    paths = []
    for part in range(2):
        p = str(tmp_path / f"part-{part}.tfrecord")
        ttf.write_tfrecord(p, [ttf.make_example(
            {"v": np.array([10 * part + i], np.int64),
             "f": np.arange(3, dtype=np.float32) + i})
            for i in range(7)])
        paths.append(p)
    glob = str(tmp_path / "part-*.tfrecord")
    t, j = TFRecordSource(glob), JTFRecordSource(glob)
    assert len(t) == len(j) == 14
    for i in range(14):
        assert t.read_record(i) == j.read_record(i)
        assert t[i]["v"].tobytes() == j[i]["v"].tobytes()
    tp = DataPipeline(t, batch_size=4, seed=2, num_workers=2)
    jp = JDataPipeline(j, batch_size=4, seed=2, num_workers=2)
    try:
        for _ in range(2):
            for a, b in zip(tp, jp):
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].tobytes() == b[k].tobytes()
    finally:
        tp.close()
        jp.close()
        t.close()
        j.close()
    assert os.path.exists(paths[0])
