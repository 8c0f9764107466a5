"""Epoch-binned time: timestamp -> (short bin, long offset-into-bin).

The port's copy of geomesa_tpu/curve/binnedtime.py (reference
geomesa-z3 BinnedTime.scala:16-65): day bins carry millisecond offsets,
week and month bins seconds, year bins minutes. Vectorized over numpy
int64 epoch milliseconds.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

MILLIS_PER_DAY = 86_400_000
SECONDS_PER_WEEK = 604_800


class TimePeriod(enum.Enum):
    DAY = "day"
    WEEK = "week"
    MONTH = "month"
    YEAR = "year"

    @staticmethod
    def parse(s: "str | TimePeriod") -> "TimePeriod":
        if isinstance(s, TimePeriod):
            return s
        return TimePeriod(s.lower())


# Max offset value within a bin, per period (reference BinnedTime.maxOffset):
# day -> millis/day, week -> seconds/week, month -> seconds in a 31-day month,
# year -> minutes in a 366-day year.
MAX_OFFSET = {
    TimePeriod.DAY: MILLIS_PER_DAY - 1,
    TimePeriod.WEEK: SECONDS_PER_WEEK - 1,
    TimePeriod.MONTH: 31 * 24 * 60 * 60 - 1,
    TimePeriod.YEAR: 366 * 24 * 60 - 1,
}

# Largest representable date per period: bins are int16, so the max bin is
# 2^15 - 1 (reference BinnedTime.maxDate). We only need the bin arithmetic.
MAX_BIN = (1 << 15) - 1


@dataclass(frozen=True)
class BinnedValue:
    bin: np.ndarray  # int16-valued (held as int32 for safe arithmetic)
    offset: np.ndarray  # int64


class BinnedTime:
    """Vectorized epoch-millis <-> (bin, offset) codec for one period."""

    def __init__(self, period: "TimePeriod | str"):
        self.period = TimePeriod.parse(period)

    @property
    def max_offset(self) -> int:
        return MAX_OFFSET[self.period]

    def to_binned(self, millis) -> BinnedValue:
        """Epoch millis -> (bin, offset). Reference: timeToBinnedTime (:73).

        Out-of-range instants (pre-epoch, or past the max representable bin)
        raise, mirroring the reference's require checks
        (BinnedTime.scala:202-204) — silent clamping would alias distinct
        instants onto boundary bins and corrupt query results.
        """
        ms = np.asarray(millis, dtype=np.int64)
        if np.any(ms < 0):
            raise ValueError(
                f"pre-epoch timestamp(s) not supported by period {self.period.value}: "
                f"min={int(np.min(ms))}ms"
            )
        p = self.period
        if p is TimePeriod.DAY:
            b = np.floor_divide(ms, MILLIS_PER_DAY)
            off = ms - b * MILLIS_PER_DAY
        elif p is TimePeriod.WEEK:
            b = np.floor_divide(ms, MILLIS_PER_DAY * 7)
            off = np.floor_divide(ms - b * (MILLIS_PER_DAY * 7), 1000)
        elif p is TimePeriod.MONTH:
            dt = ms.astype("datetime64[ms]")
            months = dt.astype("datetime64[M]")
            b = months.astype(np.int64)
            off = np.floor_divide((dt - months).astype("timedelta64[ms]").astype(np.int64), 1000)
        else:  # YEAR
            dt = ms.astype("datetime64[ms]")
            years = dt.astype("datetime64[Y]")
            b = years.astype(np.int64)
            off = np.floor_divide((dt - years).astype("timedelta64[ms]").astype(np.int64), 60_000)
        if np.any(b > MAX_BIN):
            raise ValueError(
                f"timestamp(s) past the max representable date for period "
                f"{self.period.value} (bin {int(np.max(b))} > {MAX_BIN})"
            )
        return BinnedValue(bin=b.astype(np.int32), offset=off.astype(np.int64))

    def from_binned(self, bin, offset) -> np.ndarray:
        """(bin, offset) -> epoch millis (start-of-offset instant)."""
        b = np.asarray(bin, dtype=np.int64)
        off = np.asarray(offset, dtype=np.int64)
        p = self.period
        if p is TimePeriod.DAY:
            return b * MILLIS_PER_DAY + off
        if p is TimePeriod.WEEK:
            return b * (MILLIS_PER_DAY * 7) + off * 1000
        if p is TimePeriod.MONTH:
            base = b.astype("datetime64[M]").astype("datetime64[ms]").astype(np.int64)
            return base + off * 1000
        base = b.astype("datetime64[Y]").astype("datetime64[ms]").astype(np.int64)
        return base + off * 60_000

    def bin_start_millis(self, bin) -> np.ndarray:
        return self.from_binned(bin, 0)

    def bins_for_interval(self, lo_millis: int, hi_millis: int):
        """All (bin, lo_offset, hi_offset) triples covering [lo, hi] millis.

        The analogue of the reference's BinnedTime.timesByBin logic used by
        Z3IndexKeySpace (Z3IndexKeySpace.scala:132-158): a long interval is
        tiled per time bin; interior bins cover the whole offset range.
        Returns (bins int32[n], lo int64[n], hi int64[n]) with inclusive
        offsets.

        Query-side semantics: endpoints extending past the representable
        range are *clamped* into it (a query reaching before the epoch or
        past the max bin is still answerable over its in-range portion) —
        only ingest (`to_binned`) rejects out-of-range instants.
        """
        if lo_millis > hi_millis:
            raise ValueError(f"inverted interval: {lo_millis} > {hi_millis}")
        # last true millisecond of bin MAX_BIN: MAX_OFFSET over-states short
        # months/non-leap years, so derive the ceiling from the next bin start
        max_millis = int(self.from_binned(MAX_BIN + 1, 0)) - 1
        lo_millis = min(max(int(lo_millis), 0), max_millis)
        hi_millis = min(max(int(hi_millis), 0), max_millis)
        lo_b = self.to_binned(lo_millis)
        hi_b = self.to_binned(hi_millis)
        b0 = int(lo_b.bin)
        b1 = int(hi_b.bin)
        bins = np.arange(b0, b1 + 1, dtype=np.int32)
        lo = np.zeros(len(bins), dtype=np.int64)
        hi = np.full(len(bins), self.max_offset, dtype=np.int64)
        lo[0] = int(lo_b.offset)
        hi[-1] = int(hi_b.offset)
        return bins, lo, hi
