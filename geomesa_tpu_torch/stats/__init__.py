"""Stats: the Stat DSL's sketches and the per-schema sketch store behind
``estimate_count`` and the planner's row estimates (the port's copy of
geomesa_tpu/stats)."""

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
from geomesa_tpu_torch.stats.store import StatsStore

__all__ = [
    "CountStat",
    "DescriptiveStats",
    "Frequency",
    "Histogram",
    "MinMax",
    "TopK",
    "Z3Frequency",
    "Z3Histogram",
    "StatsStore",
]
