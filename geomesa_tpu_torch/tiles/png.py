"""Deterministic stdlib PNG encoding for tile rasters.

No imaging dependency: a PNG is a signature + IHDR + (optional PLTE) +
one zlib-compressed IDAT of filter-0 scanlines + IEND, all assembled
with ``struct`` + ``zlib``. Everything here is bit-deterministic in the
input grid — same counts in, same bytes out — which is what lets a
served tile be compared with its from-scratch oracle by raw byte
equality.

Renderings (one per tile kind, docs/tiles.md):

- ``count``: linear grayscale — pixel 255 is the tile's own max count;
- ``density``: log-scaled grayscale (``log1p``), the long-tail-friendly
  view the reference's DensityScan heatmaps feed;
- ``heat``: the same log scale through a fixed 256-entry black->blue->
  red->yellow->white palette (color type 3).

The port's copy of geomesa_tpu/tiles/png.py,
held to it by the CPU parity tests.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

#: the tile kinds the serving tier accepts
KINDS = ("density", "count", "heat")

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return (
        struct.pack(">I", len(data))
        + body
        + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)
    )


def encode_png(img, palette=None) -> bytes:
    """PNG bytes for a ``(h, w)`` uint8 grayscale image, a ``(h, w, 3)``
    uint8 RGB image, or — with ``palette`` (a ``(n<=256, 3)`` uint8
    array) — a ``(h, w)`` uint8 index image (color type 3)."""
    a = np.ascontiguousarray(img, np.uint8)
    if palette is not None:
        if a.ndim != 2:
            raise ValueError("palette images must be 2-D index arrays")
        h, w = a.shape
        color_type = 3
    elif a.ndim == 2:
        h, w = a.shape
        color_type = 0
    elif a.ndim == 3 and a.shape[2] == 3:
        h, w = a.shape[:2]
        color_type = 2
    else:
        raise ValueError(f"unsupported image shape {a.shape}")
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = bytearray()
    for r in range(h):
        raw.append(0)  # filter type 0 per scanline
        raw += a[r].tobytes()
    out = [_SIG, _chunk(b"IHDR", ihdr)]
    if palette is not None:
        p = np.ascontiguousarray(palette, np.uint8)
        out.append(_chunk(b"PLTE", p.tobytes()))
    out.append(_chunk(b"IDAT", zlib.compress(bytes(raw), 6)))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def _heat_palette() -> np.ndarray:
    """Fixed 256-entry ramp: black -> blue -> red -> yellow -> white,
    piecewise-linear over four equal segments (pure integer arithmetic,
    platform-independent)."""
    p = np.zeros((256, 3), np.uint8)
    idx = np.arange(256)
    seg, t = idx // 64, (idx % 64) * 4  # t in [0, 252]
    t = np.minimum(t + (t > 0) * 3, 255)  # stretch each segment to 255
    p[seg == 0] = np.stack(
        [np.zeros(64, int), np.zeros(64, int), t[seg == 0]], axis=1
    ).astype(np.uint8)
    p[seg == 1] = np.stack(
        [t[seg == 1], np.zeros(64, int), 255 - t[seg == 1]], axis=1
    ).astype(np.uint8)
    p[seg == 2] = np.stack(
        [np.full(64, 255, int), t[seg == 2], np.zeros(64, int)], axis=1
    ).astype(np.uint8)
    p[seg == 3] = np.stack(
        [np.full(64, 255, int), np.full(64, 255, int), t[seg == 3]], axis=1
    ).astype(np.uint8)
    return p


_HEAT = _heat_palette()


def _scaled(grid: np.ndarray, log: bool) -> np.ndarray:
    g = np.asarray(grid, np.float64)
    gmax = float(g.max()) if g.size else 0.0
    if gmax <= 0.0:
        return np.zeros(g.shape, np.uint8)
    if log:
        v = np.log1p(g) * (255.0 / np.log1p(gmax))
    else:
        v = g * (255.0 / gmax)
    return np.floor(v + 0.5).astype(np.uint8)


def render(kind: str, grid) -> bytes:
    """Deterministic PNG bytes for one composed tile grid (row 0 =
    north). ``kind`` is one of :data:`KINDS`."""
    if kind == "count":
        return encode_png(_scaled(grid, log=False))
    if kind == "density":
        return encode_png(_scaled(grid, log=True))
    if kind == "heat":
        return encode_png(_scaled(grid, log=True), palette=_HEAT)
    raise ValueError(f"unknown tile kind {kind!r} (one of {KINDS})")
