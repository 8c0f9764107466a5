"""LEB128 varint primitives.

The port's copy of geomesa_tpu/io/varint.py's two the write-ahead log's
record framing reads (streaming/wal.py); the zigzag pair waits for the
binary codecs that use it (Avro, TWKB)."""

from __future__ import annotations


def append_uvarint(out: bytearray, v: int) -> None:
    """LEB128-encode a non-negative value (truncated to 64 bits)."""
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def read_uvarint(data: bytes, pos: int) -> tuple[int, int]:
    """(value, new_pos): the inverse of append_uvarint."""
    shift = 0
    v = 0
    while True:
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7
