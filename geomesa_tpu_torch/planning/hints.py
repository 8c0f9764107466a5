"""Per-query hints: the reference's QueryHints tier.

The port's copy of geomesa_tpu/planning/hints.py (reference
QueryHints.scala: SAMPLING, LOOSE_BBOX, plus GeoTools-level
transforms/sort/limit). Hints are one typed dataclass handed to
DataStore.query. The ``cache`` field steers the result cache of a store
with a cache tier (``DataStore(cache=True)``): the planner's
``_execute_or_cached`` reads it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


@dataclass
class QueryHints:
    """Options applied around the core scan.

    - ``transforms``: attribute-name projection of the result columns
      (reference query transforms / relational projection)
    - ``sort_by``: attribute to sort results by; prefix ``-`` for
      descending (reference SORT_FIELDS hint)
    - ``sample``: keep roughly this fraction of hits, (0, 1]; applied as a
      deterministic stride after refinement (reference SamplingIterator)
    - ``sample_by``: stratify sampling per value of this attribute
      (reference SAMPLE_BY hint)
    - ``loose``: accept the widened device mask without exact host
      refinement of spatial/temporal predicates — the reference's
      LOOSE_BBOX fast path. Non-indexed predicates are still applied.
    - ``offset``: skip this many results after sorting (reference
      GeoTools Query.startIndex paging; pair with the query ``limit`` for
      stable pages under a ``sort_by``)
    - ``timeout``: wall-clock budget in seconds for this query; checked at
      stage boundaries, raises QueryTimeout when exceeded (reference
      per-plan timeouts + ThreadManagement scan registration). Overrides
      the store-level ``query_timeout`` default.
    - ``cache``: per-query result-cache control (stores configured with a
      cache tier; docs/caching.md). ``None`` = normal probe/populate;
      ``"bypass"`` = skip the cache entirely (probe AND populate — for
      one-off queries that must not pollute it); ``"pin"`` = cache this
      result regardless of the cost-admission threshold and exempt it
      from LRU eviction (dashboards' hottest queries). Pinned entries are
      still invalidated by mutations and TTL.
    """

    transforms: Optional[Sequence[str]] = None
    sort_by: Optional[str] = None
    offset: Optional[int] = None
    sample: Optional[float] = None
    sample_by: Optional[str] = None
    loose: bool = False
    timeout: Optional[float] = None
    # reproject result geometries from the store-native EPSG:4326 to this
    # CRS (reference QueryPlanner.scala:292 reprojection hints); applied
    # after refinement, before transforms. Unsupported CRSs raise.
    reproject: Optional[str] = None
    cache: Optional[str] = None  # None | "bypass" | "pin"

    def validate(self) -> None:
        if self.cache not in (None, "bypass", "pin"):
            raise ValueError(
                f"cache hint must be None, 'bypass' or 'pin', got {self.cache!r}"
            )
        if self.reproject is not None:
            from geomesa_tpu_torch.crs import normalize_crs

            normalize_crs(self.reproject)  # raises on unsupported
        if self.sample is not None and not (0.0 < self.sample <= 1.0):
            raise ValueError(f"sample must be in (0, 1], got {self.sample}")
        if self.timeout is not None and self.timeout <= 0:
            raise ValueError(f"timeout must be positive, got {self.timeout}")
        if self.offset is not None and (
            not isinstance(self.offset, (int, np.integer)) or self.offset < 0
        ):
            raise ValueError(f"offset must be a non-negative int, got {self.offset!r}")
