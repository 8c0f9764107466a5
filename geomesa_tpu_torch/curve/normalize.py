"""Dimension normalization: double in [min,max] -> int in [0, 2^precision).

The port's copy of geomesa_tpu/curve/normalize.py (reference geomesa-z3
NormalizedDimension.scala:56-78): floor-binning with clamp at the top,
denormalize to bin centers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class NormalizedDimension:
    """Bit-normalized dimension (reference BitNormalizedDimension)."""

    min: float
    max: float
    precision: int  # bits

    def __post_init__(self):
        if not (0 < self.precision <= 31):
            raise ValueError(f"precision must be in (0, 31]: {self.precision}")

    @property
    def bins(self) -> int:
        return 1 << self.precision

    @property
    def max_index(self) -> int:
        return self.bins - 1

    @property
    def _normalizer(self) -> float:
        return self.bins / (self.max - self.min)

    @property
    def _denormalizer(self) -> float:
        return (self.max - self.min) / self.bins

    def normalize(self, d):
        """Map value(s) to bin ordinals, clamping to [0, max_index]."""
        d = np.asarray(d, dtype=np.float64)
        i = np.floor((d - self.min) * self._normalizer).astype(np.int64)
        return np.clip(i, 0, self.max_index)

    def denormalize(self, i):
        """Map bin ordinal(s) to the bin-center value."""
        i = np.asarray(i, dtype=np.float64)
        return self.min + (i + 0.5) * self._denormalizer

    # Inclusive value bounds of a bin: does a curve cell lie fully inside
    # the query window?
    def bin_min(self, i):
        i = np.asarray(i, dtype=np.float64)
        return self.min + i * self._denormalizer

    def bin_max(self, i):
        i = np.asarray(i, dtype=np.float64)
        return self.min + (i + 1.0) * self._denormalizer


def NormalizedLon(precision: int) -> NormalizedDimension:
    return NormalizedDimension(-180.0, 180.0, precision)


def NormalizedLat(precision: int) -> NormalizedDimension:
    return NormalizedDimension(-90.0, 90.0, precision)


def NormalizedTime(precision: int, max_offset: float) -> NormalizedDimension:
    """Time offset within a bin, [0, max_offset] (reference NormalizedTime)."""
    return NormalizedDimension(0.0, max_offset, precision)
