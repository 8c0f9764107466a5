"""Stats: the Stat DSL's sketches (the port's copy of geomesa_tpu/stats,
without the sketch store behind ``estimate_count``)."""

from geomesa_tpu_torch.stats.sketches import (
    CountStat,
    DescriptiveStats,
    Frequency,
    Histogram,
    MinMax,
    TopK,
    Z3Frequency,
    Z3Histogram,
)

__all__ = [
    "CountStat",
    "DescriptiveStats",
    "Frequency",
    "Histogram",
    "MinMax",
    "TopK",
    "Z3Frequency",
    "Z3Histogram",
]
