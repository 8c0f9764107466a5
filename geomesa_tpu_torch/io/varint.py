"""Shared zigzag + LEB128 varint primitives.

The port's copy of geomesa_tpu/io/varint.py: the write-ahead log's record
framing (streaming/wal.py) reads the LEB128 pair. One definition for the
binary codecs that use zigzag varints — Avro
(io/avro.py container files) and TWKB (io/twkb.py geometries) — so the
bit-twiddling can't drift between them."""

from __future__ import annotations


def zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def append_uvarint(out: bytearray, v: int) -> None:
    """LEB128-encode a (already zigzagged, non-negative) value."""
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
    """(value, new_pos) — inverse of append_uvarint."""
    shift = 0
    v = 0
    while True:
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7
