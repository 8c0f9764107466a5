"""Vectorized string/value hashing for the sketches.

The port's copy of geomesa_tpu/utils/hashing.py.

The FNV-style fold runs over the full fixed-width UTF-32 view of a string
column, skipping zero (padding) words so a value hashes identically
regardless of the column's declared width (a U1 scalar probe must match
the same value observed in a U16 column).
"""

from __future__ import annotations

import numpy as np

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = np.uint64(0x100000001B3)


def fnv_fold(col: np.ndarray) -> np.ndarray:
    """u64 hash per element of a string (or stringable) column."""
    c = col if col.dtype.kind == "U" else col.astype(str)
    width = max(1, c.dtype.itemsize // 4)
    b = np.frombuffer(c.tobytes(), dtype=np.uint32).reshape(len(c), width).astype(np.uint64)
    h = np.full(len(c), FNV_OFFSET, dtype=np.uint64)
    for j in range(b.shape[1]):
        w = b[:, j]
        h = np.where(w != 0, (h ^ w) * FNV_PRIME, h)
    return h
