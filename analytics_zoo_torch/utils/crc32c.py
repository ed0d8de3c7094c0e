"""CRC-32C (Castagnoli), the checksum of the TFRecord framing, shared by
the TensorBoard event writer (``utils/tb_writer.py``) and the TFRecord
codec (``feature/tfrecord.py``).

The JAX package computes it in its native data-path library
(``native/__init__.py``) with this table loop as the fallback; the port
keeps only the loop, byte at a time in Python.  Stdlib only.
"""

from __future__ import annotations

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78        # reversed Castagnoli polynomial
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        # benign race: the table build is deterministic and the rebind
        # is atomic, so concurrent first calls at worst build it twice
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C of ``data``, continuing from ``crc``."""
    table = _crc_table()
    crc = crc ^ 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """The TFRecord framing's masked CRC: rotate right by 15, add a
    constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF
