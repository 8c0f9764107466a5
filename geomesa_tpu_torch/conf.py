"""Typed system properties the port reads.

The port's copy of the part of geomesa_tpu/conf.py its main path reads,
under the same names and defaults. Each property resolves, in order:
programmatic override (``prop.set``) -> environment variable -> default.
No property selects a kernel or a backend: the device of a tensor does.

Two of the reference's properties have no counterpart: ``PALLAS_MODE``
picks a backend, and ``DENSITY_VMEM_BUDGET`` sizes the TPU's VMEM.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

REGISTRY: dict[str, "SystemProperty"] = {}


@dataclass
class SystemProperty:
    """One typed, overridable configuration knob."""

    name: str  # dotted name, e.g. "geomesa.scan.ranges.target"
    default: object
    parser: Callable = int
    doc: str = ""
    _override: Optional[object] = field(default=None, repr=False)

    def __post_init__(self):
        REGISTRY[self.name] = self

    @property
    def env_key(self) -> str:
        return self.name.upper().replace(".", "_")

    def get(self):
        import os

        if self._override is not None:
            return self._override
        raw = os.environ.get(self.env_key)
        if raw is not None:
            try:
                return self.parser(raw)
            except (TypeError, ValueError):
                return self.default
        return self.default

    def set(self, value) -> None:
        """Programmatic override (takes precedence over the environment);
        ``clear()`` restores resolution."""
        self._override = None if value is None else self.parser(value)

    def clear(self) -> None:
        self._override = None


def _parse_bool(s) -> bool:
    if isinstance(s, bool):
        return s
    return str(s).strip().lower() in ("1", "true", "yes", "on")


SCAN_RANGES_TARGET = SystemProperty(
    "geomesa.scan.ranges.target", 2000, int,
    "max covering z-ranges per query (reference QueryProperties.ScanRangesTarget)",
)

COMPACT_MIN_ROWS = SystemProperty(
    "geomesa.tpu.compact.min.rows", 262_144, int,
    "delta rows before a minor compaction merges into the device table",
)
COMPACT_SPAN_ROWS = SystemProperty(
    "geomesa.tpu.compact.span.rows", 4_194_304, int,
    "bounded-buffer rows per gather span when a compaction streams sorted "
    "columns to the device (block-aligned; caps host scratch instead of "
    "materializing the whole sorted column set)",
)

# -- query deadlines and guards (planning.errors, planning.guards) ---------

QUERY_TIMEOUT = SystemProperty(
    "geomesa.query.timeout", None, float,
    "default per-query wall-clock budget in seconds (None = unbounded)",
)
GUARD_TEMPORAL_MAX = SystemProperty(
    "geomesa.guard.temporal.max.duration", 7 * 86_400_000, int,
    "ms cap on a query's temporal span for TemporalQueryGuard."
    "from_properties() (reference TemporalQueryGuard's property of the "
    "same name; default one week)",
)

# -- the incremental fold (DataStore.fold_upsert) --------------------------

STREAM_FOLD_SLICE_ROWS = SystemProperty(
    "geomesa.stream.fold.slice.rows", 65_536, int,
    "update-fold slice size: a fold batch larger than this splits into "
    "batch-contiguous slices, each published atomically on its own "
    "(readers see exact intermediate states), so the fold is no longer "
    "one O(table) pause; 0 folds monolithically",
)
STREAM_FOLD_DEVICE = SystemProperty(
    "geomesa.stream.fold.device", "auto", str,
    "device-side fold plan: 'on' builds a folded index table's columns on "
    "the table's device from the old table plus an O(touched) upload "
    "(removed positions, insert positions, the slice's sorted rows) "
    "instead of re-gathering and re-uploading the O(table) suffix; "
    "'auto' does so on a CUDA table and keeps the host gather on a CPU "
    "table; 'off' always takes the host gather. Both builds are "
    "bit-identical",
)

# -- the pipelined bulk ingest (ingest/) ------------------------------------

INGEST_WORKERS = SystemProperty(
    "geomesa.ingest.workers", 0, int,
    "worker count for the pipelined ingest's parse/key/sort stages "
    "(0 = one per host core)",
)
INGEST_QUEUE_DEPTH = SystemProperty(
    "geomesa.ingest.queue.depth", 4, int,
    "bounded admission window: chunks a producer may stage ahead of the "
    "ordered writer before put() blocks; overflow waits are counted by "
    "the geomesa.ingest.queue_full metric",
)
INGEST_CHUNK_ROWS = SystemProperty(
    "geomesa.ingest.chunk.rows", 1 << 20, int,
    "fixed-size sort shard rows: each chunk's (bin, z) keys radix-sort in "
    "shards of this many rows, in parallel, merged spanwise at finalize",
)
INGEST_MERGE_MIN_BINS = SystemProperty(
    "geomesa.ingest.merge.min.bins", 2, int,
    "distinct sort bins below which the ingest finalize (and a sharded "
    "sort's commit) falls back to the whole-batch LSD radix sort "
    "(spanwise merging has nothing to parallelize over few bins)",
)

# -- the streaming tier (streaming/) ----------------------------------------

STREAM_WORKERS = SystemProperty(
    "geomesa.stream.workers", 0, int,
    "worker count for the stream flusher's parse/key/shard-sort stages "
    "(0 = one per host core); the pool stays warm across flushes",
)
STREAM_CHUNK_ROWS = SystemProperty(
    "geomesa.stream.chunk.rows", 65_536, int,
    "rows per flush micro-chunk: the hot snapshot stages through the "
    "warm workers in chunks of this many rows (also the shard size of "
    "the per-chunk radix sorts)",
)
STREAM_QUEUE_DEPTH = SystemProperty(
    "geomesa.stream.queue.depth", 4, int,
    "bounded admission window: flush micro-chunks queued in the worker "
    "pool at once before staging blocks; overflow waits are counted by "
    "the geomesa.stream.queue_full metric",
)
STREAM_FOLD_ROWS = SystemProperty(
    "geomesa.stream.fold.rows", 131_072, int,
    "pending UPDATE rows before a micro-batch flush folds them into the "
    "cold tables: below it, updated ids stay resident in the hot overlay "
    "(reads remain exact through the hot-wins-by-id merge), so the "
    "steady-state flush pays O(batch) for appends instead of O(table); a "
    "full persist (persist_hot/checkpoint) always folds everything",
)
STREAM_FOLD_YIELD_MS = SystemProperty(
    "geomesa.stream.fold.yield.ms", 15.0, float,
    "cap on the between-slice scheduler yield: after each published fold "
    "slice the folding thread waits up to this long for the cold store's "
    "QueryScheduler admission queue to drain; an idle queue returns at "
    "once",
)
STREAM_FOLD_PRESTAGE = SystemProperty(
    "geomesa.stream.fold.prestage", True, _parse_bool,
    "parse and key-encode pending update rows through the warm flush "
    "workers at micro-flush time, so the eventual fold window pays only "
    "merge and publish; rows re-updated after staging re-stage at fold "
    "time. False defers all staging to the fold",
)
STREAM_WAL_SYNC = SystemProperty(
    "geomesa.stream.wal.sync", "always", str,
    "streaming WAL fsync policy: 'always' = every acknowledged write is "
    "fsync'd first (group-committed), 'interval' = fsync at most every "
    "geomesa.stream.wal.sync.interval.ms (bounded loss window), 'off' = "
    "never fsync (redo-from-checkpoint workloads)",
)
STREAM_WAL_SYNC_INTERVAL_MS = SystemProperty(
    "geomesa.stream.wal.sync.interval.ms", 50.0, float,
    "fsync cadence under geomesa.stream.wal.sync=interval: a hard kill "
    "loses at most the writes acknowledged since the last sync",
)
STREAM_WAL_SEGMENT_BYTES = SystemProperty(
    "geomesa.stream.wal.segment.bytes", 64 << 20, int,
    "streaming WAL segment size: the active log rotates past this many "
    "bytes; sealed segments retire only once a checkpoint watermark "
    "covers them (LambdaStore.checkpoint)",
)
STREAM_WAL_REPLAY_BATCH = SystemProperty(
    "geomesa.stream.wal.replay.batch.rows", 262_144, int,
    "recovery-side replay batching: contiguous WAL upsert records "
    "coalesce into one bulk hot-tier apply of up to this many rows "
    "(one lock hold, vectorised grid-index insert); 0 replays record "
    "at a time",
)
STREAM_INCREMENTAL = SystemProperty(
    "geomesa.stream.incremental", True, _parse_bool,
    "fold flushes into the cold tables incrementally "
    "(DataStore.fold_upsert: no whole-table re-sort, scoped cache "
    "invalidation); False = the legacy delete-and-rewrite upsert flush",
)

# -- standing queries: the inverted subscription index
# (streaming.standing) ---------------------------------------------------

STANDING_GRID_LEVEL = SystemProperty(
    "geomesa.standing.grid.level", 12, int,
    "Z2 routing-grid level of the SubscriptionIndex (2^level cells per "
    "axis): arriving points route to the subscriptions covering their "
    "cell; finer levels shrink candidate sets but grow each "
    "subscription's registered cell count",
)
STANDING_CLASSIFY_CELLS = SystemProperty(
    "geomesa.standing.classify.cells", 16384, int,
    "per-subscription cell budget for FULL/PARTIAL registration-time "
    "classification (the raster-interval machinery): geofences whose bbox "
    "window exceeds it register every bbox cell PARTIAL — a superset, "
    "never wrong, just no zero-geometry full-cell matches",
)
STANDING_FUSED_MIN_POINTS = SystemProperty(
    "geomesa.standing.fused.min.points", 64, int,
    "routed candidate rows a boundary geofence needs in one batch "
    "before it joins a fused block_scan_multi dispatch; sparser "
    "candidates take the vectorized host ray cast (<= 0 keeps "
    "everything on the host path)",
)
STANDING_RASTER_CELLS = SystemProperty(
    "geomesa.standing.raster.cells", 1_048_576, int,
    "per-subscription cell budget for the MATCH-TIME raster grid built "
    "for dense (>= 16-edge, non-rectangle) geofences at registration: "
    "each candidate point classifies by one cell lookup — FULL cells "
    "match, OUT cells miss, only the boundary residue pays the exact "
    "ray cast (the raster-interval economics, inverted); much "
    "finer than the routing grid, so jagged polygons' residue shrinks "
    "~10x; 0 disables (every boundary pair pays edges)",
)
STANDING_FUSED_GATE = SystemProperty(
    "geomesa.standing.fused.gate", True, _parse_bool,
    "measured-cost gate on the standing matcher's fused kernel path "
    "(the tile cache's adaptive-gate pattern): per-unit EWMAs of the "
    "host ray cast and the fused dispatch — seeded by one bounded "
    "probe chunk — keep each eligible geofence on whichever path "
    "measures cheaper on THIS host (counted by "
    "geomesa.standing.gate.host); false always fuses past "
    "geomesa.standing.fused.min.points (differential tests, kernel "
    "debugging)",
)
STANDING_QUEUE_MAX = SystemProperty(
    "geomesa.standing.queue.max", 65_536, int,
    "bounded alert-queue capacity: past it the OLDEST alerts drop "
    "(counted by geomesa.standing.dropped) — delivery never blocks the "
    "write ack path",
)
STANDING_WINDOW_PANES = SystemProperty(
    "geomesa.standing.window.panes", 512, int,
    "retained panes per continuous-window aggregate: panes older than "
    "the newest this-many drop (counted by "
    "geomesa.standing.window.dropped), bounding window state",
)


# -- replication: WAL shipping, read replicas, failover
# (streaming.replica) ----------------------------------------------------

REPLICA_SHIP_CHUNK_BYTES = SystemProperty(
    "geomesa.replica.ship.chunk.bytes", 256 << 10, int,
    "SegmentShipper transfer granularity: WAL segment bytes stream to "
    "followers in frames of at most this many payload bytes (each "
    "length-prefixed + checksummed), so one huge sealed segment never "
    "monopolizes the transport between staleness marks",
)
REPLICA_SHIP_INTERVAL_MS = SystemProperty(
    "geomesa.replica.ship.interval.ms", 25.0, float,
    "SegmentShipper pump cadence: every tick ships newly durable WAL "
    "bytes to each follower and broadcasts a staleness mark (the "
    "leader's applied horizon + wall clock) — the floor of follower "
    "staleness under an idle leader",
)
REPLICA_STALENESS_MAX_MS = SystemProperty(
    "geomesa.replica.staleness.max.ms", 5000.0, float,
    "follower health threshold: a ReplicaStore whose measured staleness "
    "watermark exceeds this degrades /health with a replica.staleness "
    "reason; 0 disables the check",
)
REPLICA_GIVEUP_S = SystemProperty(
    "geomesa.replica.giveup.s", 10.0, float,
    "SegmentShipper retry budget per pump, in seconds (fault."
    "with_retries max_elapsed_s): past it the shipper stops retrying "
    "that follower for the tick and trips the replica.ship.giveup "
    "/health reason instead of spinning in backoff forever",
)


# -- raster-interval polygon approximations (filter.raster) ---------------

RASTER_ENABLED = SystemProperty(
    "geomesa.raster.enabled", True, _parse_bool,
    "precompute raster-interval approximations (arXiv 2307.01716) for "
    "polygon queries: full/out cells resolve by integer interval checks, "
    "exact PIP runs only on the boundary residue",
)
RASTER_MAX_CELLS = SystemProperty(
    "geomesa.raster.max.cells", 16384, int,
    "cell budget of one polygon's Z2-aligned raster grid (the level is "
    "the finest whose bbox window fits this many cells)",
)
RASTER_MIN_EDGES = SystemProperty(
    "geomesa.raster.min.edges", 8, int,
    "polygons with fewer edges than this skip rasterization (the exact "
    "point-in-polygon leg is already cheap at tiny edge counts)",
)
RASTER_KERNEL_INTERVALS = SystemProperty(
    "geomesa.raster.kernel.intervals", 16, int,
    "cap on the per-query interval count shipped to the scan kernel "
    "(coalesced conservatively past it): the raster-derived z-ranges "
    "already prune at full resolution host-side, so a coarse in-kernel "
    "stack trades a slightly wider residue for a cheaper kernel leg",
)
RASTER_RESIDUE = SystemProperty(
    "geomesa.raster.residue", "host", str,
    "where the boundary-cell residue runs its exact even-odd PIP: 'host' "
    "(f64 refinement of the uncertain rows) or 'device' (the scan "
    "kernel's f32 point-in-polygon leg beside the raster leg)",
)

# -- spatial joins (sql.join, process.join) --------------------------------

JOIN_ADAPTIVE = SystemProperty(
    "geomesa.join.adaptive", True, _parse_bool,
    "pick the spatial-join strategy per partition from measured "
    "selectivity (arXiv 1802.09488) instead of one fixed plan",
)
JOIN_SAMPLE = SystemProperty(
    "geomesa.join.sample", 512, int,
    "candidate rows sampled per join partition to measure boundary-cell "
    "selectivity before picking a strategy",
)
JOIN_BROAD_FRACTION = SystemProperty(
    "geomesa.join.broad.fraction", 0.25, float,
    "indexed-join polygons whose candidate spans cover more than this "
    "fraction of the table skip the fused-scan probe and classify the "
    "whole point set against their raster on host",
)
JOIN_IN_SELECTIVITY = SystemProperty(
    "geomesa.join.in.selectivity", 0.5, float,
    "attribute-join IN push-down is skipped (host membership mask "
    "instead) when the sampled fraction of matching secondary rows "
    "exceeds this: the scan would return most rows anyway",
)

# -- the map-tile pyramid (tiles) ------------------------------------------

TILES_LEAF_ZOOM = SystemProperty(
    "geomesa.tiles.leaf.zoom", 3, int,
    "the pyramid's finest zoom: leaf tiles aggregate rows once at this "
    "level, every zoom above folds child partials",
)
TILES_PX = SystemProperty(
    "geomesa.tiles.px", 256, int,
    "tile raster edge in pixels (one tile is px x px)",
)
TILES_CACHE_MAX_BYTES = SystemProperty(
    "geomesa.tiles.cache.max.bytes", 128 << 20, int,
    "LRU byte budget for composed tile grids (the pyramid's own "
    "ResultCache instance; 0 recomposes every fetch)",
)
TILES_TTL = SystemProperty(
    "geomesa.tiles.ttl", None, float,
    "seconds a composed tile grid stays servable past its compose "
    "(None = until a generation bump invalidates it); spread by "
    "geomesa.cache.ttl.jitter like every cached result",
)
TILES_MAX_AGE_S = SystemProperty(
    "geomesa.tiles.max.age.s", 0.0, float,
    "Cache-Control of served tiles: > 0 allows clients to reuse a tile "
    "for N seconds without revalidating; 0 makes them revalidate "
    "through the generation-derived ETag",
)

# -- concurrent query serving (serving.scheduler) -------------------------

SERVING_WINDOW_MS = SystemProperty(
    "geomesa.serving.window_ms", 2.0, float,
    "micro-batch window CAP in milliseconds: the scheduler's adaptive "
    "window grows toward this under load (more fusion per dispatch) and "
    "shrinks to ~0 when idle (single queries pay ~no added latency)",
)
SERVING_QUEUE_MAX = SystemProperty(
    "geomesa.serving.queue.max", 1024, int,
    "bounded admission queue depth: a full queue blocks (backpressure) or "
    "sheds, never buffers unboundedly",
)
SERVING_BATCH_MAX = SystemProperty(
    "geomesa.serving.batch.max", 128, int,
    "max queries drained into one fused micro-batch dispatch",
)


# -- multi-tenant fairness (serving.tenancy) -------------------------------

TENANT_QUEUE_MAX = SystemProperty(
    "geomesa.tenant.queue.max", 256, int,
    "per-tenant admission quota: one tenant's queued queries past this "
    "shed while other tenants' queues stay open — the bound that keeps a "
    "flooding tenant from filling the shared queue",
)
TENANT_DEFAULT_WEIGHT = SystemProperty(
    "geomesa.tenant.default.weight", 1.0, float,
    "deficit-round-robin weight for tenants without an explicit "
    "TenantRegistry.configure() entry: each drained micro-batch takes "
    "from backlogged tenants in proportion to weight",
)
TENANT_SLO_P99_MS = SystemProperty(
    "geomesa.tenant.slo.p99.ms", 500.0, float,
    "per-tenant SLO objective: served-query wall p99 threshold for each "
    "tenant's own SloTracker window (0 disables per-tenant objectives)",
)


# -- observability: tracing and the slow-query log (obs.trace) ------------

OBS_TRACE_SAMPLE = SystemProperty(
    "geomesa.obs.trace.sample", 0, int,
    "structured-tracing sample rate: 0 disarms tracing entirely (span "
    "entry is a no-op thread-local check), 1 traces every root "
    "operation, N retains every Nth root's span tree in the trace "
    "buffer (slow queries are captured regardless — see "
    "geomesa.obs.slow.ms)",
)
OBS_TRACE_BUFFER = SystemProperty(
    "geomesa.obs.trace.buffer", 256, int,
    "bounded in-memory trace ring: completed sampled traces retained "
    "for DataStore.dump_trace (oldest evicted first)",
)
OBS_SLOW_MS = SystemProperty(
    "geomesa.obs.slow.ms", 1000.0, float,
    "always-on slow-query log threshold: a root operation slower than "
    "this captures its full span tree + plan fingerprint into the "
    "slow-query ring (DataStore.slow_queries); 0 disables the slow log "
    "(and, with geomesa.obs.trace.sample=0, disarms tracing outright)",
)
OBS_SLOW_MAX = SystemProperty(
    "geomesa.obs.slow.max", 64, int,
    "slow-query ring capacity (oldest captures evicted first)",
)


# -- SLO tracking (obs.slo) -------------------------------------------------

OBS_SLO_WINDOW_S = SystemProperty(
    "geomesa.obs.slo.window.s", 300.0, float,
    "sliding evaluation window for SLO objectives (DataStore.slo_report)",
)
OBS_SLO_SLICES = SystemProperty(
    "geomesa.obs.slo.slices", 30, int,
    "sub-slices per SLO window: observations rotate through this many "
    "interval sub-histograms, so the window slides with bounded memory "
    "and at most window/slices staleness",
)
OBS_SLO_QUERY_P99_MS = SystemProperty(
    "geomesa.obs.slo.query.p99.ms", 250.0, float,
    "default query-latency objective: geomesa.query.scan p99 over the "
    "sliding window must stay at or under this (0 drops the objective)",
)
OBS_SLO_FOLD_P99_MS = SystemProperty(
    "geomesa.obs.slo.fold.p99.ms", 150.0, float,
    "default fold-pause objective: geomesa.stream.fold.slice p99 must "
    "stay at or under this (0 drops it)",
)
OBS_SLO_WAL_P99_MS = SystemProperty(
    "geomesa.obs.slo.wal.p99.ms", 50.0, float,
    "default durability objective: geomesa.stream.wal.fsync p99 must "
    "stay at or under this (0 drops it)",
)
OBS_SLO_STANDING_P99_MS = SystemProperty(
    "geomesa.obs.slo.standing.p99.ms", 250.0, float,
    "default standing-query alert objective: geomesa.standing.latency "
    "p99 must stay at or under this (0 drops it)",
)
OBS_SLO_REPLICA_STALENESS_P99_MS = SystemProperty(
    "geomesa.obs.slo.replica.staleness.p99.ms", 2000.0, float,
    "default replication objective: geomesa.replica.staleness.ms p99 "
    "must stay at or under this (0 drops it)",
)
OBS_SLO_TILES_P99_MS = SystemProperty(
    "geomesa.obs.slo.tiles.p99.ms", 100.0, float,
    "default tile-serving objective: geomesa.tiles.fetch p99 must stay "
    "at or under this (0 drops it)",
)


# -- the ops plane: /health + /metrics endpoints, telemetry history
# (obs.ops) -----------------------------------------------------------------

OBS_OPS_HOST = SystemProperty(
    "geomesa.obs.ops.host", "127.0.0.1", str,
    "bind address of the ops endpoint (DataStore.serve_ops): loopback "
    "by default — exposing /metrics and /health beyond the host is an "
    "explicit operator decision",
)
OBS_OPS_SAMPLE_MS = SystemProperty(
    "geomesa.obs.ops.sample.ms", 1000.0, float,
    "TelemetryRecorder sampling cadence: every tick snapshots the "
    "metrics registry's gauges, counters and histogram p50/p99 into "
    "bounded time-series rings (/debug/vars)",
)
OBS_OPS_HISTORY = SystemProperty(
    "geomesa.obs.ops.history", 512, int,
    "points retained per telemetry ring (oldest evicted first): at the "
    "default 1 Hz cadence, ~8.5 minutes of history per series",
)


# -- lock-witness runtime (lockwitness) ------------------------------------

LOCK_WITNESS = SystemProperty(
    "geomesa.tpu.lock.witness", False, _parse_bool,
    "arm the dynamic lock witness: locks constructed AFTER arming wrap in "
    "an order-recording proxy; the observed acquisition graph must stay "
    "acyclic (resolves from GEOMESA_TPU_LOCK_WITNESS=1 like every knob)",
)
LOCK_WITNESS_ARTIFACT = SystemProperty(
    "geomesa.tpu.lock.witness.artifact", "/tmp/lock_witness.json", str,
    "where lockwitness.dump() writes the observed edge graph / blocking "
    "events so a failure is diagnosable from logs alone",
)


# -- query and aggregation cache tier (cache) ------------------------------

CACHE_MAX_BYTES = SystemProperty(
    "geomesa.cache.result.max.bytes", 256 << 20, int,
    "LRU byte budget for cached query results (0 disables the result cache)",
)
CACHE_TTL = SystemProperty(
    "geomesa.cache.ttl", None, float,
    "seconds a cached entry stays servable (None = until invalidated)",
)
CACHE_TTL_JITTER = SystemProperty(
    "geomesa.cache.ttl.jitter", 0.0, float,
    "deterministic per-key TTL spread as a fraction of the TTL (0..1): a "
    "burst of same-TTL entries admitted together expires staggered "
    "instead of stampeding the store in lockstep (0 = exact TTLs)",
)
CACHE_MIN_COST = SystemProperty(
    "geomesa.cache.min.cost", 0.0, float,
    "cost-aware admission: cache only results whose measured scan took at "
    "least this many seconds (0 = admit everything)",
)
CACHE_TILE_BITS = SystemProperty(
    "geomesa.cache.tile.bits", 6, int,
    "tile-aggregate cache resolution: the world splits into 2^bits x "
    "2^bits SFC-aligned tiles whose partial aggregates are memoized",
)
CACHE_TILE_MAX = SystemProperty(
    "geomesa.cache.tile.max.entries", 65_536, int,
    "max resident tile aggregates before LRU eviction (0 disables the "
    "tile cache)",
)
CACHE_TILES_PER_QUERY = SystemProperty(
    "geomesa.cache.tile.max.per.query", 1024, int,
    "bbox queries spanning more interior tiles than this skip tile "
    "composition (the per-tile bookkeeping would beat the scan)",
)


# -- planner estimate accountability (obs.accuracy) ------------------------

PLAN_ESTIMATE = SystemProperty(
    "geomesa.plan.estimate.enabled", True, _parse_bool,
    "record the stats-sketch row estimate on every plan and compare it "
    "against the rows the executed scan actually produced (the "
    "geomesa.plan.estimate.error histogram and the per-index accuracy "
    "windows); False skips the plan-time sketch probe entirely",
)
PLAN_ESTIMATE_STALE_P90 = SystemProperty(
    "geomesa.plan.estimate.stale.p90", 4.0, float,
    "misestimate threshold: when a (type, index)'s p90 estimate error "
    "factor exceeds this, the stats count as stale (and the auto-analyze "
    "hook may fire); 0 disables staleness detection",
)
PLAN_ESTIMATE_MIN_COUNT = SystemProperty(
    "geomesa.plan.estimate.min.count", 64, int,
    "recorded estimate-vs-actual samples a (type, index) window needs "
    "before its p90 can trip the staleness threshold (a handful of "
    "unlucky queries must not flag a whole store stale)",
)
PLAN_ESTIMATE_AUTO_ANALYZE = SystemProperty(
    "geomesa.plan.estimate.auto.analyze", False, _parse_bool,
    "when the staleness threshold trips, re-run DataStore.analyze_stats "
    "for the offending type automatically (once per trip; the accuracy "
    "window resets after). Off by default: a full re-sketch on a large "
    "store is a deliberate maintenance op",
)


# -- the data plane (serving.http) -----------------------------------------

SERVE_HOST = SystemProperty(
    "geomesa.serve.host", "127.0.0.1", str,
    "bind address for DataStore.serve(port) — loopback by default "
    "(laptop-friendly, the same posture as the ops plane)",
)
SERVE_PAGE_ROWS = SystemProperty(
    "geomesa.serve.page.rows", 4096, int,
    "rows per chunked-transfer page on the query endpoints: one big "
    "result streams as bounded pages instead of materializing the whole "
    "payload (one Arrow record batch per page on fmt=arrow)",
)
SERVE_MAX_BODY_BYTES = SystemProperty(
    "geomesa.serve.max.body.bytes", 64 << 20, int,
    "cap on an ingest request body; a larger Content-Length is refused "
    "with HTTP 413 before any bytes are read",
)
SERVE_RETRY_AFTER_MS = SystemProperty(
    "geomesa.serve.retry.after.ms", 50.0, float,
    "Retry-After hint (milliseconds, rendered as seconds) on a 429 shed "
    "or a 503 stale-replica read — the client backoff the admission "
    "layer suggests",
)

# -- the multi-host pod tier (pod) -----------------------------------------

POD_HOSTS = SystemProperty(
    "geomesa.pod.hosts", 0, int,
    "host-group size H for the pod tier (0 = one host per process under "
    "the distributed driver; the sim driver needs a count)",
)
POD_DEVICES_PER_HOST = SystemProperty(
    "geomesa.pod.devices.per.host", 0, int,
    "devices each host contributes to its shard mesh (0 = divide the "
    "given or visible devices evenly over the hosts)",
)
POD_DRIVER = SystemProperty(
    "geomesa.pod.driver", "auto", str,
    "host-group driver: 'distributed' (a torch.distributed world, one "
    "host per process), 'sim' (in-process per-host device slices), or "
    "'auto' (distributed in a world of more than one process, else sim)",
)
POD_LINK_PROBE = SystemProperty(
    "geomesa.pod.link.probe", False, _parse_bool,
    "measure each host's pull link at host-group construction and derive "
    "per-host fused slot caps from the probes (off = the compiled shapes "
    "on every host)",
)

# -- the self-tuning controller tier (tuning) ------------------------------

TUNING_ENABLED = SystemProperty(
    "geomesa.tuning.enabled", False, _parse_bool,
    "arm the self-tuning controller tier (plan-feedback index "
    "reweighting, knob auto-tuning, SLO-burn admission shedding); off "
    "is bit-identical to a store without the tier",
)
TUNING_INTERVAL = SystemProperty(
    "geomesa.tuning.interval", 64, int,
    "queries between adaptation pulses: the tuning loop piggybacks on "
    "the query path, so a busier store adapts faster and an idle one "
    "not at all",
)
TUNING_DECISIONS = SystemProperty(
    "geomesa.tuning.decisions", 128, int,
    "bounded length of the adaptation decision ring served by "
    "/debug/tuning and the CLI's tune command",
)
TUNING_PLAN_MAX_ADJUST = SystemProperty(
    "geomesa.tuning.plan.max.adjust", 4.0, float,
    "hard cap on the plan-feedback priority inflation for a "
    "chronically misestimating index: it can lose plans but never be "
    "exiled",
)
TUNING_PLAN_DEADBAND = SystemProperty(
    "geomesa.tuning.plan.deadband", 2.0, float,
    "p90 estimate-error factor at which plan reweighting engages; "
    "release happens at the midpoint back toward 1.0, and the band "
    "between holds (hysteresis: no plan flapping)",
)
TUNING_PLAN_MIN_COUNT = SystemProperty(
    "geomesa.tuning.plan.min.count", 8, int,
    "accuracy-window samples required per (type, index) before plan "
    "reweighting may act on its error factor",
)
TUNING_BURN_OBJECTIVE = SystemProperty(
    "geomesa.tuning.burn.objective", "query_p99", str,
    "SLO objective name whose burn rate drives admission shedding "
    "(must exist in the attached tracker's objective set)",
)
TUNING_BURN_THRESHOLD = SystemProperty(
    "geomesa.tuning.burn.threshold", 2.0, float,
    "burn rate above which the scheduler sheds below-max-weight "
    "tenant work before the queue is physically full",
)
TUNING_BURN_RELEASE = SystemProperty(
    "geomesa.tuning.burn.release", 1.0, float,
    "burn rate at or below which engaged burn shedding releases "
    "(hysteresis gap against admission flapping)",
)
SCAN_FUSED_SLOTS = SystemProperty(
    "geomesa.scan.fused.slots", 0, int,
    "pinned fused chunk slot count (power-of-two ladder rung); 0 = "
    "automatic (the link-probe constants, or the compiled default) — "
    "the knob the fused_chunk_slots controller writes",
)


def describe() -> str:
    """One line per registered property with its current value (the
    CLI's env command)."""
    out = []
    for name in sorted(REGISTRY):
        p = REGISTRY[name]
        out.append(f"{name} = {p.get()!r}  [{p.env_key}] {p.doc}")
    return "\n".join(out)
