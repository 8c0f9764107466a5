"""geomesa_tpu_torch.cache: the query and aggregation cache tier.

The port's copy of geomesa_tpu/cache (a GeoBlocks-style read-path cache;
arXiv:1908.07753). It is host bookkeeping around the store's device
paths: a hit serves a materialized result without launching a kernel, a
miss runs the normal path.

- :class:`ResultCache`: materialized query results keyed by canonical
  fingerprints, LRU + TTL + cost-aware admission + single-flight;
- :class:`TileAggregateCache`: per-SFC-tile partial aggregates composed
  into bbox count/bounds answers (cached interior + fresh edges);
- :class:`GenerationTracker`: per-(schema, key-range) generations bumped
  by every mutation path; lookups validate, so stale entries cannot be
  served;
- :class:`QueryCache`: the facade a DataStore owns (``DataStore(cache=
  True)``), wiring the three together with the conf knobs.

The reference's package also leaks ``field`` (its ``dataclasses.field``
import, not API); this one does not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from geomesa_tpu_torch.cache.fingerprint import (
    fingerprint, fingerprint_plan, hints_token, schema_signature,
)
from geomesa_tpu_torch.cache.generations import (
    BUCKET_MS, GenerationTracker, KeyRange, key_range_of, mutation_range,
)
from geomesa_tpu_torch.cache.result import (
    ResultCache, ResultCacheConf, collection_nbytes,
)
from geomesa_tpu_torch.cache.tiles import (
    TileAggregateCache, TileCacheConf, TileComposition,
)

__all__ = [
    "CacheConfig", "QueryCache", "ResultCache", "TileAggregateCache",
    "GenerationTracker", "KeyRange", "TileComposition",
    "fingerprint", "fingerprint_plan", "schema_signature", "key_range_of",
    "mutation_range", "hints_token",
    "collection_nbytes", "BUCKET_MS",
]


@dataclass
class CacheConfig:
    """All cache knobs; defaults resolve from the conf property tier
    (environment-overridable)."""

    max_bytes: int = 256 << 20
    ttl_s: Optional[float] = None
    min_cost_s: float = 0.0
    ttl_jitter: float = 0.0
    tile_bits: int = 6
    tile_max_entries: int = 65_536
    max_tiles_per_query: int = 1024

    @staticmethod
    def from_properties() -> "CacheConfig":
        from geomesa_tpu_torch import conf

        return CacheConfig(
            max_bytes=conf.CACHE_MAX_BYTES.get(),
            ttl_s=conf.CACHE_TTL.get(),
            min_cost_s=conf.CACHE_MIN_COST.get(),
            ttl_jitter=conf.CACHE_TTL_JITTER.get(),
            tile_bits=conf.CACHE_TILE_BITS.get(),
            tile_max_entries=conf.CACHE_TILE_MAX.get(),
            max_tiles_per_query=conf.CACHE_TILES_PER_QUERY.get(),
        )


class QueryCache:
    """The store-facing cache tier: result cache + tile-aggregate cache
    over one shared GenerationTracker. May outlive a DataStore: pass an
    existing instance to ``persist.load(root, cache=...)`` to carry the
    tracker (and its invalidation history) across a reload. A reload
    counts as a mutation over everything it loads (the on-disk state may
    be older than what cached entries saw), so entries overlapping loaded
    data fill again rather than serve warm, and quarantined partitions
    are swept eagerly."""

    def __init__(self, conf: "CacheConfig | None" = None, metrics=None):
        from geomesa_tpu_torch.metrics import resolve

        self.conf = conf or CacheConfig.from_properties()
        self.metrics = resolve(metrics)
        self.generations = GenerationTracker()
        self.result = ResultCache(
            ResultCacheConf(
                max_bytes=self.conf.max_bytes,
                ttl_s=self.conf.ttl_s,
                min_cost_s=self.conf.min_cost_s,
                ttl_jitter=self.conf.ttl_jitter,
            ),
            self.generations,
            metrics=self.metrics,
        )
        #: the tile pyramid's composition seam (tiles.TilePyramid attaches
        #: itself), so every mutation's key range also reaches the
        #: pyramid's delta accounting
        self.pyramid = None
        self.tiles = TileAggregateCache(
            TileCacheConf(
                tile_bits=self.conf.tile_bits,
                max_entries=self.conf.tile_max_entries,
                max_tiles_per_query=self.conf.max_tiles_per_query,
            ),
            self.generations,
            metrics=self.metrics,
        )

    # -- planner hooks ---------------------------------------------------
    def fingerprint_plan(self, plan, hints, sft, auths) -> str:
        return fingerprint_plan(
            plan, hints, sft, auths,
            self.generations.schema_gen(plan.type_name),
        )

    def key_range(self, f, sft) -> KeyRange:
        return key_range_of(f, sft)

    # -- mutation hooks --------------------------------------------------
    def attach_pyramid(self, pyramid) -> None:
        """Register a TilePyramid for mutation forwarding (the flush and
        fold deltas reach it through the same per-slice on_mutation calls
        the scoped invalidation reads)."""
        self.pyramid = pyramid

    def on_mutation(self, type_name: str, fc=None) -> None:
        """A batch of rows was written, replaced or removed: bump the
        covered key range (``fc=None`` = unknown range, bump everything)."""
        bounds = time_range = None
        if fc is not None:
            bounds, time_range = mutation_range(fc)
        self.generations.bump(type_name, bounds=bounds, time_range=time_range)
        if self.pyramid is not None:
            self.pyramid.note_delta(type_name, bounds)

    def on_schema_dropped(self, type_name: str) -> None:
        self.generations.bump_schema(type_name)
        self.result.invalidate_type(type_name)
        self.tiles.invalidate_type(type_name)
        if self.pyramid is not None:
            self.pyramid.invalidate_type(type_name)

    def on_quarantine(self, type_name: str, time_range=None) -> int:
        """A loaded store quarantined a damaged partition: bump the
        partition's key range and eagerly drop overlapping entries
        (entries over the hole must not linger even unservable). Returns
        the entries dropped."""
        self.generations.bump(type_name, bounds=None, time_range=time_range)
        dropped = self.result.sweep(type_name) + self.tiles.invalidate_type(type_name)
        if self.pyramid is not None:
            dropped += self.pyramid.sweep(type_name)
        return dropped

    # -- introspection ---------------------------------------------------
    def stats(self) -> dict:
        out = {
            "result_entries": len(self.result),
            "result_bytes": self.result.bytes_resident,
            "tile_entries": len(self.tiles),
        }
        if self.pyramid is not None:
            out.update(self.pyramid.stats())
        return out
