"""TWKB ("tiny well-known binary") geometry codec.

Reference: geomesa-features TwkbSerialization (
geomesa-features/geomesa-feature-common/src/main/scala/org/locationtech/
geomesa/features/serialization/TwkbSerialization.scala) — GeoMesa's
compact on-disk geometry encoding. Implemented from the public TWKB
format description: a type+precision header byte (zigzag precision in
the high nibble), a metadata byte, then coordinates as zigzag varint
*deltas* of the scaled integer coordinates. Integer deltas make
serialized tracks/polygons a fraction of WKB's fixed 8-byte doubles.

Supports the geometry kinds of geomesa_tpu_torch.geometry; bbox/size/id-list
metadata flags are not written (and rejected on read, like unknown WKB
variants — the reference likewise writes plain TWKB)."""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch import geometry as geo

_EMPTY = 0x10

_TYPE_CODES = {
    geo.Point: 1,
    geo.LineString: 2,
    geo.Polygon: 3,
    geo.MultiPoint: 4,
    geo.MultiLineString: 5,
    geo.MultiPolygon: 6,
}


from geomesa_tpu_torch.io.varint import (
    append_uvarint as _write_varint,
    read_uvarint as _read_varint,
    unzigzag as _unzigzag,
    zigzag as _zigzag,
)


class _CoordWriter:
    """Delta state shared across all rings of one geometry (per spec)."""

    def __init__(self, scale: float):
        self.scale = scale
        self.prev = np.zeros(2, dtype=np.int64)

    def write(self, out: bytearray, coords: np.ndarray) -> None:
        q = np.round(np.asarray(coords, dtype=np.float64) * self.scale).astype(
            np.int64
        )
        for row in q:
            for d in range(2):
                _write_varint(out, _zigzag(int(row[d] - self.prev[d])))
                self.prev[d] = row[d]


class _CoordReader:
    def __init__(self, scale: float):
        self.scale = scale
        self.prev = [0, 0]

    def read(self, data: bytes, pos: int, n: int) -> tuple[np.ndarray, int]:
        out = np.empty((n, 2), dtype=np.float64)
        for i in range(n):
            for d in range(2):
                zz, pos = _read_varint(data, pos)
                self.prev[d] += _unzigzag(zz)
                out[i, d] = self.prev[d] / self.scale
        return out, pos


def to_twkb(g: geo.Geometry, precision: int = 7) -> bytes:
    """Encode one geometry; ``precision`` decimal digits (zigzagged into
    the header's high nibble, range -8..7)."""
    if not -8 <= precision <= 7:
        raise ValueError("twkb precision must be in [-8, 7]")
    code = _TYPE_CODES.get(type(g))
    if code is None:
        raise ValueError(f"cannot twkb-encode {type(g).__name__}")
    out = bytearray()
    out.append((_zigzag(precision) << 4) | code)
    scale = 10.0 ** precision
    w = _CoordWriter(scale)
    if isinstance(g, geo.Point):
        out.append(0)
        w.write(out, np.array([[g.x, g.y]]))
    elif isinstance(g, geo.LineString):
        out.append(0)  # the LineString type requires >= 2 points
        _write_varint(out, len(g.coords))
        w.write(out, g.coords)
    elif isinstance(g, geo.Polygon):
        rings = [g.shell] + list(g.holes)
        out.append(0)
        _write_varint(out, len(rings))
        for r in rings:
            _write_varint(out, len(r))
            w.write(out, r)
    else:  # multi-geometries
        parts = list(g.parts)
        out.append(0 if parts else _EMPTY)
        if parts:
            _write_varint(out, len(parts))
            for p in parts:
                if isinstance(p, geo.Point):
                    w.write(out, np.array([[p.x, p.y]]))
                elif isinstance(p, geo.LineString):
                    _write_varint(out, len(p.coords))
                    w.write(out, p.coords)
                else:
                    rings = [p.shell] + list(p.holes)
                    _write_varint(out, len(rings))
                    for r in rings:
                        _write_varint(out, len(r))
                        w.write(out, r)
    return bytes(out)


def from_twkb(data: bytes) -> geo.Geometry:
    """Decode one TWKB geometry."""
    code = data[0] & 0x0F
    precision = _unzigzag(data[0] >> 4)
    meta = data[1]
    if meta & ~_EMPTY:
        raise ValueError(f"unsupported twkb metadata flags: {meta:#x}")
    if meta & _EMPTY and code not in (4, 5, 6):
        # the geometry model has no empty scalar geometries (LineString
        # requires >= 2 points etc.) — reject e.g. POINT EMPTY cleanly
        raise ValueError(f"empty twkb geometry (type {code}) not supported")
    pos = 2
    scale = 10.0 ** precision
    r = _CoordReader(scale)
    if code == 1:
        c, pos = r.read(data, pos, 1)
        return geo.Point(c[0, 0], c[0, 1])
    if code == 2:
        n, pos = _read_varint(data, pos)
        c, pos = r.read(data, pos, n)
        return geo.LineString(c)
    if code == 3:
        nrings, pos = _read_varint(data, pos)
        rings = []
        for _ in range(nrings):
            n, pos = _read_varint(data, pos)
            c, pos = r.read(data, pos, n)
            rings.append(c)
        return geo.Polygon(rings[0], rings[1:])
    if code in (4, 5, 6):
        cls = {4: geo.MultiPoint, 5: geo.MultiLineString, 6: geo.MultiPolygon}[code]
        if meta & _EMPTY:
            return cls([])
        nparts, pos = _read_varint(data, pos)
        parts = []
        for _ in range(nparts):
            if code == 4:
                c, pos = r.read(data, pos, 1)
                parts.append(geo.Point(c[0, 0], c[0, 1]))
            elif code == 5:
                n, pos = _read_varint(data, pos)
                c, pos = r.read(data, pos, n)
                parts.append(geo.LineString(c))
            else:
                nrings, pos = _read_varint(data, pos)
                rings = []
                for _ in range(nrings):
                    n, pos = _read_varint(data, pos)
                    c, pos = r.read(data, pos, n)
                    rings.append(c)
                parts.append(geo.Polygon(rings[0], rings[1:]))
        return cls(parts)
    raise ValueError(f"unknown twkb type code {code}")
