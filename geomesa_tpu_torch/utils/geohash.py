"""Geohash codec: base-32 cell encoding of (lon, lat).

Reference: geomesa-utils geohash (geomesa-utils-parent/
geomesa-utils/src/main/scala/org/locationtech/geomesa/utils/geohash/
GeoHash.scala, GeohashUtils.scala) — used there for polygon decomposition
and interop. Re-derived from the public geohash construction: interleaved
lon/lat bisection bits, 5 bits per base-32 character. Vectorized over
numpy arrays; the bit interleave reuses the same Morton structure as the
Z2 curve (curve/zorder.py) — a geohash IS a z-curve prefix with a
different alphabet.

The port's copy of geomesa_tpu/utils/geohash.py,
held to it by the CPU parity tests.
"""

from __future__ import annotations

import numpy as np

_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"
_DECODE = {c: i for i, c in enumerate(_BASE32)}


def _interleave(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Morton word whose MSB-first reading alternates x, y (x first).

    Z2.index(a, b) puts a's bits at even positions from bit 0; passing
    (y, x) puts x at the odd (higher) positions, so the word read from
    the top starts with x — the geohash bit order."""
    from geomesa_tpu_torch.curve.zorder import Z2

    return Z2.index(y.astype(np.uint64), x.astype(np.uint64))


def encode(lon, lat, precision: int = 12) -> np.ndarray:
    """Geohash strings ([n] or scalar) at ``precision`` characters."""
    if not 1 <= precision <= 12:
        raise ValueError("geohash precision must be in [1, 12]")
    scalar = np.isscalar(lon)
    lon = np.atleast_1d(np.asarray(lon, dtype=np.float64))
    lat = np.atleast_1d(np.asarray(lat, dtype=np.float64))
    nbits = precision * 5
    xbits = (nbits + 1) // 2  # lon gets the extra bit at odd precisions
    ybits = nbits // 2
    xq = np.clip(
        ((lon + 180.0) / 360.0 * (1 << xbits)).astype(np.int64), 0, (1 << xbits) - 1
    ).astype(np.uint64)
    yq = np.clip(
        ((lat + 90.0) / 180.0 * (1 << ybits)).astype(np.int64), 0, (1 << ybits) - 1
    ).astype(np.uint64)
    if xbits > ybits:  # align widths: pad lat with one low zero bit
        z = _interleave(xq, yq << np.uint64(1)) >> np.uint64(1)
    else:
        z = _interleave(xq, yq)
    # z now holds nbits of alternating lon/lat from the top of nbits
    chars = np.empty((len(lon), precision), dtype="U1")
    for c in range(precision):
        shift = np.uint64(nbits - 5 * (c + 1))
        idx = ((z >> shift) & np.uint64(31)).astype(np.int64)
        chars[:, c] = np.array(list(_BASE32))[idx]
    out = np.array(["".join(row) for row in chars])
    return out[0] if scalar else out


def decode(geohash: str) -> tuple[float, float]:
    """Center (lon, lat) of a geohash cell."""
    x0, y0, x1, y1 = bbox(geohash)
    return (x0 + x1) / 2.0, (y0 + y1) / 2.0


def bbox(geohash: str) -> tuple[float, float, float, float]:
    """(lon_min, lat_min, lon_max, lat_max) of a geohash cell."""
    lon_lo, lon_hi = -180.0, 180.0
    lat_lo, lat_hi = -90.0, 90.0
    even = True  # lon bit first
    for ch in geohash.lower():
        v = _DECODE[ch]
        for b in (16, 8, 4, 2, 1):
            mid_on = v & b
            if even:
                m = (lon_lo + lon_hi) / 2.0
                if mid_on:
                    lon_lo = m
                else:
                    lon_hi = m
            else:
                m = (lat_lo + lat_hi) / 2.0
                if mid_on:
                    lat_lo = m
                else:
                    lat_hi = m
            even = not even
    return lon_lo, lat_lo, lon_hi, lat_hi


def neighbors(geohash: str) -> list[str]:
    """The 8 adjacent cells at the same precision (clipped at the poles;
    wraps across the antimeridian)."""
    x0, y0, x1, y1 = bbox(geohash)
    w, h = x1 - x0, y1 - y0
    cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
    out = []
    for dy in (-h, 0.0, h):
        for dx in (-w, 0.0, w):
            if dx == 0.0 and dy == 0.0:
                continue
            ny = cy + dy
            if ny < -90.0 or ny > 90.0:
                continue
            nx = cx + dx
            if nx < -180.0:
                nx += 360.0
            elif nx > 180.0:
                nx -= 360.0
            out.append(str(encode(nx, ny, precision=len(geohash))))
    return out
