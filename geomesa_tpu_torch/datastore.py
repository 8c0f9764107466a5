"""DataStore: schema lifecycle, ingest, and the query entry points.

The port of geomesa_tpu/datastore.py's main path (reference
GeoMesaDataStore): create_schema -> write -> query / query_many / count /
density / density_many / bounds / stats_query / explain, serve() for
concurrent callers, and the mutation surface: upsert, fold_upsert (the
incremental fold), delete_features, modify_features, age_off,
delete_schema, plus id_lookup / id_exists_mask over a per-chunk sorted
id index. Queries take the reference's controls: ``QueryHints`` (sort,
sample, offset, transforms, reprojection, ``loose``, ``timeout``),
guards and interceptors (``apply_guards`` / ``apply_interceptors``), a
store-wide ``query_timeout``, and the observability core: every executed
plan is recorded in the optional MetricsRegistry and AuditWriter
(``record_query``), and armed tracing keeps span trees
(``dump_trace``, ``slow_queries``).

Each write sketches its batch (stats.StatsStore: counts, min/max,
histograms, top-k, the z-prefix sketch) and merges it onto the type's
sketch; ``stats_for`` returns it, ``estimate_count`` answers from it
without a scan, ``analyze_stats`` sketches the stored rows afresh, and
every executed plan's estimate is held against the rows it matched
(``accuracy``, obs.accuracy). ``DataStore(auths=...)`` turns on
visibility (security): rows whose ``geomesa.vis.field`` label the auths
cannot satisfy are masked out of every result, and every device
aggregation (the count estimate, density and bounds kernels) steps aside
for the host path, since the scan mask cannot read a label.
``DataStore(cache=True)`` attaches the result and tile cache tier
(cache): every committed mutation bumps the generations over its key
range, so a cached answer is served only while nothing it covers has
changed. ``serve()`` attaches the serving scheduler, ``serve_ops()`` the
ops plane (``/metrics``, ``/health``), ``attach_slo()`` an SLO tracker
(``slo_report``); ``close()`` stops the first two, and the store stays
queryable.

Point schemas get a Z3 index (when a time attribute exists) and a Z2
index; extent schemas (polygons, lines, multi-geometries) an XZ3 and an
XZ2 index; both narrowed by the ``geomesa.indices.enabled`` user data.
Each index is a scan surface built by the store's adapter
(storage.adapter): by default a sorted IndexTable whose predicate
columns live on the store's device, or with ``mesh=`` a table sharded
over a parallel.Mesh (parallel.dtable) or cut host-major over a
pod.HostGroup (pod.table). The catalog (storage.metadata) keeps
each schema's spec, user data and index names; ``persist.save`` and
``persist.load`` (storage.persist) write a store to disk and read it
back, and ``store_health`` reports partitions quarantined at load.

The device is explicit: ``DataStore(device="cuda")`` (the default) raises
when no CUDA device is present; tests pass ``device="cpu"``, where every
kernel wrapper takes its plain PyTorch version. The first write builds
each index table; later writes stay in a host delta tier (storage.delta)
until it outgrows ``geomesa.tpu.compact.min.rows`` and an eighth of the
rows, when ``compact`` merges the delta into the tables. Writers
serialize on one lock; readers take none and see whole publishes.
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from geomesa_tpu_torch import conf, fault
from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.features import FeatureCollection, _date_to_millis
from geomesa_tpu_torch.filter.predicates import (
    INCLUDE, Cmp, Filter, IdFilter, Include, PointColumn,
)
from geomesa_tpu_torch.index import (
    AttributeIndex, S2Index, S3Index, XZ2Index, XZ3Index, Z2Index, Z3Index,
)
from geomesa_tpu_torch.index.api import WriteKeys
from geomesa_tpu_torch.lockwitness import witness
from geomesa_tpu_torch.planning.errors import check_deadline
from geomesa_tpu_torch.planning.explain import Explainer
from geomesa_tpu_torch.planning.planner import QueryPlanner, mask_decides_filter
from geomesa_tpu_torch.sft import FeatureType
from geomesa_tpu_torch.storage.delta import TieredTable, concat_keys
from geomesa_tpu_torch.storage.adapter import merge_applies
from geomesa_tpu_torch.storage.table import IndexTable
from geomesa_tpu_torch.timing import NULL_CLOCK

_EXPIRY_UNITS_MS = {
    "millisecond": 1, "second": 1000, "minute": 60_000, "hour": 3_600_000,
    "day": 86_400_000, "week": 7 * 86_400_000,
    # the short forms of scala.concurrent.duration ("7 d", "24 h",
    # "30 min", "90 s", "500 ms"); "m" means minutes, matched exactly
    # before the plural strip below so "ms" never collapses onto it
    "ms": 1, "s": 1000, "sec": 1000, "min": 60_000, "m": 60_000,
    "h": 3_600_000, "d": 86_400_000, "w": 7 * 86_400_000,
}


def parse_expiry_ms(spec: str, dtg_field: str | None = None) -> int:
    """``geomesa.feature.expiry``-style duration -> milliseconds: a plain
    integer (ms) or ``"<n> <unit>"`` with the long (``"7 days"``) or short
    (``"7 d"``, ``"30 min"``, ``"500 ms"``) units. An attribute prefix like
    ``"dtg(7 days)"`` is accepted only when it names the schema's time
    attribute (pass ``dtg_field`` to enforce): age-off always sweeps by
    that attribute, so honoring another attribute's expiry would delete
    the wrong rows."""
    s = spec.strip()
    m = re.fullmatch(r"(\w+)\(([^)]+)\)", s)
    if m:
        if dtg_field is not None and m.group(1) != dtg_field:
            raise ValueError(
                f"expiry attribute {m.group(1)!r} is not the time attribute "
                f"{dtg_field!r}; attribute-based expiry on other attributes "
                "is not supported"
            )
        s = m.group(2).strip()
    if re.fullmatch(r"\d+", s):
        return int(s)
    m = re.fullmatch(r"(\d+)\s*([a-zA-Z]+)", s)
    if m:
        unit = m.group(2).lower()
        # exact unit first ("ms", "min", "s"), then the plural long form
        if unit not in _EXPIRY_UNITS_MS and unit.endswith("s"):
            unit = unit[:-1]
        if unit in _EXPIRY_UNITS_MS:
            return int(m.group(1)) * _EXPIRY_UNITS_MS[unit]
    raise ValueError(f"unparseable expiry spec: {spec!r}")


def _slice_keys(keys: WriteKeys, start: int, stop: "int | None" = None) -> WriteKeys:
    """WriteKeys rows [start:stop] (the delta tier's view of a partly
    compacted part; the fold's batch-contiguous slices)."""
    if start == 0 and (stop is None or stop >= len(keys.bins)):
        return keys
    sl = slice(start, stop)
    return WriteKeys(
        bins=keys.bins[sl],
        zs=keys.zs[sl],
        device_cols={k: v[sl] for k, v in keys.device_cols.items()},
        sub=keys.sub[sl] if keys.sub is not None else None,
    )


def _pad_words(a: np.ndarray, b: np.ndarray) -> tuple:
    """Two secondary sort-word arrays zero-padded to one word count (0 is
    the right pad: a shorter string sorts before any extension)."""
    w = max(a.shape[1], b.shape[1])
    return tuple(np.pad(x, ((0, 0), (0, w - x.shape[1]))) for x in (a, b))


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "DataStore(device='cuda'): no CUDA device is available; pass "
            "device='cpu' to run on the plain PyTorch kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class DataStore:
    """In-process feature store whose index tables live on one device."""

    # the last fold's timing report: {"rows", "slices", "slice_s": [per
    # publish seconds]}; None until a fold runs
    last_fold_report = None

    # the attached QueryScheduler (serve()), OpsServer (serve_ops()) and
    # SloTracker (attach_slo()), or None; class-level defaults beside the
    # instance assignments in __init__
    scheduler = None
    ops = None
    slo = None

    # probe rows per searchsorted call in _id_find: numpy's string
    # searchsorted holds the GIL for the whole call, so slicing bounds
    # each hold for concurrent readers
    _ID_PROBE_SLICE = 8192

    def __init__(
        self,
        device="cuda",
        tile: int | None = None,
        block_full_table_scans: bool = False,
        guards: Sequence | None = None,
        interceptors: Sequence | None = None,
        audit=None,
        metrics=None,
        query_timeout: float | None = None,
        adapter=None,
        metadata=None,
        auths: Sequence[str] | None = None,
        cache=None,
        mesh=None,
    ):
        """``mesh``: a parallel.Mesh (or a pod.HostGroup) the index tables
        shard over (parallel.dtable, pod.table); its devices must be of
        ``device``'s type, and of ``device`` itself where that names an
        index. ``guards`` / ``interceptors``: planning.guards hooks; ``audit``
        an AuditWriter; ``metrics`` a MetricsRegistry. ``auths``: the
        visibility authorizations of every query (None turns security
        off; ``[]`` sees public rows only). ``cache``: the query and
        aggregation cache tier: ``True`` builds a cache.QueryCache from
        the conf knobs, a cache.CacheConfig builds one from that config,
        a QueryCache is used as given (shared across a reload through
        ``persist.load(root, cache=...)``); None attaches none.
        ``block_full_table_scans`` adds a FullTableScanGuard at query time.
        ``query_timeout``: default per-query wall-clock budget in seconds
        (QueryTimeout when exceeded; a QueryHints.timeout overrides it per
        query); None reads ``geomesa.query.timeout``. ``adapter``: a
        storage.adapter.IndexAdapter backend (default: InProcessAdapter
        on ``device``; an InProcessAdapter without a device takes this
        store's). ``metadata``: a storage.metadata catalog backend
        (default: an in-memory catalog behind a read cache)."""
        from geomesa_tpu_torch.storage.adapter import InProcessAdapter
        from geomesa_tpu_torch.storage.metadata import CachedMetadata, InMemoryMetadata
        from geomesa_tpu_torch.storage.persist import StoreHealth

        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            devs = {torch.device(d) for d in mesh.devices}
            if {d.type for d in devs} != {self.device.type} or (
                self.device.index is not None and self.device not in devs
            ):
                raise ValueError(
                    f"mesh devices {sorted(map(str, devs))} disagree with device={self.device}"
                )
        self.tile = tile
        self.block_full_table_scans = block_full_table_scans
        self.guards = list(guards or [])
        self.interceptors = list(interceptors or [])
        self.audit = audit
        self.metrics = metrics
        if query_timeout is None:
            query_timeout = conf.QUERY_TIMEOUT.get()
        self.query_timeout = query_timeout
        self._schemas: dict[str, FeatureType] = {}
        self._chunks: dict[str, list[FeatureCollection]] = {}
        # per-type stats sketches (stats.StatsStore), merged per write
        self._stats: dict[str, object] = {}
        # None = security off; [] = public rows only (reference
        # AuthorizationsProvider semantics)
        self.auths = auths
        self._full: dict[str, FeatureCollection | None] = {}
        self._indexes: dict[str, list] = {}
        self._tables: dict[tuple[str, str], IndexTable] = {}
        # per-index write keys, one part per write; rows past _main_rows
        # are the delta tier
        self._key_chunks: dict[tuple[str, str], list[WriteKeys]] = {}
        self._main_rows: dict[str, int] = {}
        # id lookup: per-chunk sorted id columns, built lazily and
        # validated by chunk identity (_id_index)
        self._id_sorted: dict[str, list | None] = {}
        # writers (write, compact, every mutation) serialize on this lock
        # so a reader never observes half-updated chunk or table state;
        # readers take no lock
        self._write_lock = witness(threading.RLock(), "DataStore._write_lock")
        # serializes only the id-index entry cache
        self._id_lock = witness(threading.Lock(), "DataStore._id_lock")
        # seqlock of the fold's publishes: odd while the assignment-only
        # swap of tables and chunks is in flight, so pin_scan_state's
        # lock-free readers capture a consistent (table, chunks) pair
        self._publish_seq = 0  # guarded-by: _write_lock
        # sliced-fold progress (type -> (published, total) slices)
        self._fold_progress: dict[str, tuple] = {}  # guarded-by: _write_lock
        # backend seam and catalog tier
        if adapter is None:
            adapter = InProcessAdapter(tile=tile, device=self.device, mesh=mesh)
        elif isinstance(adapter, InProcessAdapter) and adapter.device is None:
            adapter.device = self.device
        self.adapter = adapter
        self.metadata = metadata if metadata is not None else CachedMetadata(InMemoryMetadata())
        # damage accounting: persist.load replaces it with the outcome of
        # its verification; a store with quarantined partitions answers
        # queries degraded (a warning on every plan and a counter)
        self.health = StoreHealth()
        self.planner = QueryPlanner(self)
        # estimate accountability: per-(type, index) estimate-vs-actual
        # windows fed by record_query
        from geomesa_tpu_torch.obs.accuracy import EstimateAccuracy

        self.accuracy = EstimateAccuracy()
        # the query and aggregation cache tier
        self.cache = None
        if cache is not None and cache is not False:
            self.attach_cache(cache)
        # per-phase timing of the scan path (timing.PhaseClock), or the
        # clock that records nothing
        self.clock = NULL_CLOCK
        # the serving tier (serve()), the ops plane (serve_ops()) and the
        # SLO tracker (attach_slo())
        self.scheduler = None
        self.ops = None
        self.slo = None
        # the network data plane (serve(port=...))
        self.server = None
        # the self-tuning controller tier (attach_tuning()); None and a
        # disarmed manager keep every hook path as without the tier
        self.tuning = None

    def attach_cache(self, cache) -> None:
        """Install (or replace) the cache tier: ``True`` or a CacheConfig
        build a fresh QueryCache; an existing QueryCache attaches as
        given; ``None`` detaches. Wires the adapter's generation hook, so
        table rebuilds (compactions) bump generations too."""
        from geomesa_tpu_torch.cache import CacheConfig, QueryCache

        if cache is True:
            cache = QueryCache(metrics=self.metrics)
        elif isinstance(cache, CacheConfig):
            cache = QueryCache(cache, metrics=self.metrics)
        self.cache = cache
        generations = cache.generations if cache is not None else None
        try:
            self.adapter.generations = generations
        except AttributeError:  # adapters without the hook still work
            pass

    def _bump_cache(self, type_name: str, fc=None) -> None:
        """Generation bump for one committed mutation (invalidates
        overlapping cached entries). Runs after the mutation is visible to
        readers, so a racing fill that read the old state lands with an
        older tick and is dropped, never served. Every mutation path
        lands here, so this is also where the planner's scan-config memo
        drops: scan_config clamps time bins to the index's bin_range,
        which grows with writes."""
        self.planner.invalidate_config_memo()
        if self.cache is not None:
            self.cache.on_mutation(type_name, fc)

    # -- schema lifecycle ------------------------------------------------
    def create_schema(self, sft: "FeatureType | str", spec: str | None = None) -> FeatureType:
        """Register a feature type. Accepts a FeatureType or (name, spec)."""
        if isinstance(sft, str):
            if spec is None:
                raise ValueError("create_schema(name, spec) needs a spec string")
            sft = FeatureType.from_spec(sft, spec)
        if sft.name in self._schemas:
            raise ValueError(f"schema {sft.name!r} already exists")
        if sft.geom_field is None:
            raise ValueError(f"schema {sft.name!r} has no geometry attribute")
        self._schemas[sft.name] = sft
        self._indexes[sft.name] = self._choose_indexes(sft)
        self._chunks[sft.name] = []
        self._full[sft.name] = None
        self._main_rows[sft.name] = 0
        self._id_sorted[sft.name] = None
        # catalog entries (reference MetadataBackedDataStore.createSchema)
        self.metadata.insert(f"{sft.name}~schema", sft.to_spec())
        self.metadata.insert(
            f"{sft.name}~user_data",
            json.dumps({str(k): str(v) for k, v in sft.user_data.items()}),
        )
        self.metadata.insert(
            f"{sft.name}~indices", ",".join(i.name for i in self._indexes[sft.name])
        )
        return sft

    @staticmethod
    def _choose_indexes(sft: FeatureType) -> list:
        indexes: list = []
        extras: list = []  # opt-in only (the reference gates S2/S3 the same way)
        if sft.is_points:
            if sft.dtg_field is not None:
                indexes.append(Z3Index(sft))
                extras.append(S3Index(sft))
            indexes.append(Z2Index(sft))
            extras.append(S2Index(sft))
        else:
            if sft.dtg_field is not None:
                indexes.append(XZ3Index(sft))
            indexes.append(XZ2Index(sft))
        for attr in sft.indexed_attributes():
            indexes.append(AttributeIndex(sft, attr))
        # reference `geomesa.indices.enabled` user-data hint; "attr"
        # enables every attribute index (the reference names them all "attr")
        enabled = sft.user_data.get("geomesa.indices.enabled")
        if enabled:
            names = {s.strip() for s in str(enabled).split(",")}
            indexes = [
                i for i in indexes + extras
                if i.name in names or i.name.split("_")[0] in names
            ]
            if not indexes:
                raise ValueError(f"no supported index in {enabled!r}")
        return indexes

    @property
    def store_health(self):
        """This store's storage.persist.StoreHealth: ``status`` is ``"ok"``
        or ``"degraded"`` (partitions quarantined at load); ``damage``
        lists the quarantine records."""
        return self.health

    def get_schema(self, type_name: str) -> FeatureType:
        return self._schemas[type_name]

    def type_names(self) -> list[str]:
        return sorted(self._schemas)

    def delete_schema(self, type_name: str) -> None:
        """Drop a schema and all its data (reference removeSchema)."""
        with self._write_lock:
            self._schemas.pop(type_name)
            self._chunks.pop(type_name, None)
            self._full.pop(type_name, None)
            self._main_rows.pop(type_name, None)
            self._id_sorted.pop(type_name, None)
            self._stats.pop(type_name, None)
            for idx in self._indexes.pop(type_name, []):
                table = self._tables.pop((type_name, idx.name), None)
                if table is not None:
                    self.adapter.delete_table(table)
                self._key_chunks.pop((type_name, idx.name), None)
            for key in (f"{type_name}~schema", f"{type_name}~user_data", f"{type_name}~indices"):
                self.metadata.remove(key)
            self.planner.invalidate_config_memo()
            if self.cache is not None:
                self.cache.on_schema_dropped(type_name)

    def indexes(self, type_name: str) -> list:
        return self._indexes[type_name]

    # -- ingest ----------------------------------------------------------
    def write(
        self,
        type_name: str,
        features: "FeatureCollection | Sequence[Mapping]",
        check_ids: bool = True,
    ) -> int:
        """Append a batch of features. The first write builds every index
        table; a later batch stays in the host delta tier until the delta
        exceeds ``max(geomesa.tpu.compact.min.rows, total // 8)`` rows,
        when :meth:`compact` runs (the JAX package's commit rule).
        ``check_ids=False`` skips the duplicate id check for bulk loads
        with known-unique ids."""
        features, new_keys, batch_stats = self._encode_batch(type_name, features)
        if len(features) == 0:
            return 0
        return self._commit_batch(
            type_name, features, new_keys, batch_stats, check_ids=check_ids
        )

    def _encode_batch(self, type_name: str, features):
        """The pure half of a write: the batch's stats sketch and every
        index's write keys, built before any store state mutates, so a
        failing encoder leaves the store untouched. Returns (features,
        {index name -> WriteKeys}, StatsStore | None)."""
        from geomesa_tpu_torch.stats.store import StatsStore

        sft = self._schemas[type_name]
        if not isinstance(features, FeatureCollection):
            features = FeatureCollection.from_rows(sft, features)
        if len(features) == 0:
            return features, {}, None
        batch_stats = StatsStore.build(sft, features)
        new_keys: dict = {}
        sketch_index = _sketch_index(self._indexes[type_name])
        for idx in self._indexes[type_name]:
            keys = idx.write_keys(features)
            new_keys[idx.name] = keys
            if idx.name == sketch_index and len(keys.zs):
                # the sketch sees the batch only (the store-level sketch
                # accumulates); cells are codec-defined, so they align
                _observe_sketch(batch_stats, idx, keys)
        return features, new_keys, batch_stats

    def _commit_batch(self, type_name: str, features: FeatureCollection,
                      new_keys: Mapping, batch_stats, check_ids: bool = True) -> int:
        """The serialized half of a write: the id check, the stats merge
        and the commit are one critical section, so two racing writers
        can neither both pass the id check nor both merge onto the same
        prior sketch."""
        with self._write_lock:
            if check_ids:
                self._check_ids(type_name, np.asarray(features.ids))
            self._merge_stats(type_name, batch_stats)
            self._widen_bin_ranges(type_name, new_keys)
            self._chunks[type_name].append(features)
            self._full[type_name] = None
            for name, keys in new_keys.items():
                self._key_chunks.setdefault((type_name, name), []).append(keys)
            total = self.row_count(type_name)
            main_rows = self._main_rows[type_name]
            if main_rows == 0 or total - main_rows > max(conf.COMPACT_MIN_ROWS.get(), total // 8):
                self.compact(type_name)
            self._bump_cache(type_name, features)
        return len(features)

    def _merge_stats(self, type_name: str, stats) -> None:
        """Merge a batch sketch onto the type's sketch (write lock held):
        the first batch's sketch becomes the type's, later ones merge
        onto it in place."""
        if stats is None:
            return
        prev = self._stats.get(type_name)
        self._stats[type_name] = prev.merge(stats) if prev is not None else stats

    def _bulk_commit(
        self,
        type_name: str,
        fcs: Sequence[FeatureCollection],
        keys_by_index: Mapping,
        stats_list: Sequence,
        check_ids: bool = True,
        presorted: "Mapping | None" = None,
    ) -> int:
        """Atomic multi-chunk publish (the pipelined bulk ingest,
        ingest.BulkLoader, and ``persist.load``): one write-lock section
        appends every chunk, folds the chunks' stats sketches in chunk
        order (the left fold the sequential write path makes, so
        histograms bin alike) and compacts once. ``keys_by_index`` holds
        one WriteKeys per index covering all chunks, in chunk order;
        ``presorted`` optionally maps index names to the full stable
        (bin, z) argsort of those keys, so the compaction skips its radix
        sort. Nothing is visible until this returns."""
        fcs = [fc for fc in fcs if len(fc)]
        total_new = sum(len(fc) for fc in fcs)
        if total_new == 0:
            return 0
        with self._write_lock:
            if check_ids:
                self._check_ids(type_name, np.concatenate([np.asarray(fc.ids) for fc in fcs]))
            for st in stats_list:
                self._merge_stats(type_name, st)
            self._widen_bin_ranges(type_name, keys_by_index)
            total_before = sum(len(c) for c in self._chunks[type_name])
            self._chunks[type_name].extend(fcs)
            self._full[type_name] = None
            for name, keys in keys_by_index.items():
                self._key_chunks.setdefault((type_name, name), []).append(keys)
            # a presorted perm is ordinal-aligned only when the new rows
            # are the whole table (a bulk load into an empty type)
            self.compact(type_name, presorted=presorted if total_before == 0 else None)
            self._bump_cache(type_name)
        return total_new

    def delete_features(self, type_name: str, f: "Filter | str") -> int:
        """Remove the features matching a filter; returns the count removed
        (reference GeoTools removeFeatures). Rebuilds the chunks and index
        tables without the removed rows (a major compaction); the stats
        are sketched afresh from the survivors, since sketches cannot
        subtract."""
        with self._write_lock:
            return self._delete_features_locked(type_name, f)

    def upsert(self, type_name: str, features: "FeatureCollection | Sequence[Mapping]") -> int:
        """Write a batch, replacing any existing features with the same ids
        (reference FeatureWriter update semantics): a delete-and-rewrite
        maintenance op, since replaced rows must leave every sorted index.
        Returns the number of features written."""
        sft = self._schemas[type_name]
        if not isinstance(features, FeatureCollection):
            features = FeatureCollection.from_rows(sft, features)
        if len(features) == 0:
            return 0
        self._validate_replacement(type_name, features)
        with self._write_lock:
            ids = tuple(np.asarray(features.ids).tolist())
            # the delete returns the removed rows so that a write failure
            # past the validation (a device out of memory, say) restores
            # them instead of losing the replaced rows
            existing = self._delete_features_locked(type_name, IdFilter(ids), return_removed=True)
            try:
                return self.write(type_name, features)
            except BaseException:
                if len(existing):
                    self.write(type_name, existing)  # best-effort rollback
                raise

    def fold_upsert(
        self,
        type_name: str,
        features: "FeatureCollection | Sequence[Mapping]",
        keys: "Mapping | None" = None,
        stats=None,
        presorted: "Mapping | None" = None,
        slice_rows: "int | None" = None,
        pacer=None,
        on_slice=None,
    ) -> int:
        """Incremental :meth:`upsert`: replace existing ids and append the
        rest without the whole-table rebuild of the delete-and-rewrite
        path. Results are bit-identical to :meth:`upsert`: survivors keep
        their sorted order, the batch sorts alone and two-run merges in
        (storage.table.folded_table), and only device blocks past the
        first touched sorted row change; with the device fold plan
        (``geomesa.stream.fold.device``) only the batch's rows go to the
        device at all.

        ``keys`` / ``stats``: the batch's pre-encoded write keys and stats
        sketch; ``presorted`` maps index names to the batch's stable
        (bin, z) argsort, so the fold skips its batch sort.

        A batch larger than ``slice_rows`` (default
        ``geomesa.stream.fold.slice.rows``; 0 disables) folds in
        batch-contiguous slices, each published atomically: every
        intermediate state is the fold of the applied prefix, and the
        final state is bit-identical to the monolithic fold. Between
        slices the fold calls ``pacer()``; ``on_slice(ids)`` fires after
        each publish with the ids that just became resident. The write
        lock is held across all slices; readers never take it.

        Cache invalidation is scoped to the replaced rows' key range plus
        the batch's own (per slice, in the sliced form), unlike a
        compaction's whole-type bump. The stats accumulate the batch
        sketch (sketches cannot subtract the replaced rows): the drift
        :meth:`analyze_stats` restores."""
        sft = self._schemas[type_name]
        if not isinstance(features, FeatureCollection):
            features = FeatureCollection.from_rows(sft, features)
        if len(features) == 0:
            return 0
        ids = np.asarray(features.ids)
        if len(np.unique(ids)) != len(ids):
            raise ValueError("duplicate feature ids in replacement batch")
        if keys is None:
            features, keys, stats = self._encode_batch(type_name, features)
        with self._write_lock:
            # one id probe for the whole batch: per-slice ordinals derive
            # from it by subtracting earlier slices' removals
            found = self._id_find(type_name, ids)
            replaced = found[found >= 0]
            if not len(replaced):
                # nothing to replace: a plain append rides the delta tier
                n = self._commit_batch(type_name, features, keys, stats, check_ids=False)
                if on_slice is not None:
                    on_slice([str(i) for i in ids.tolist()])
                return n
            # the fold works on a fully compacted prefix: merge any
            # outstanding delta first, so sorted rows are table rows
            # (ordinals survive: the compaction keeps ordinal order)
            if self._main_rows.get(type_name, 0) != self.row_count(type_name):
                self.compact(type_name)
            elif len(self._chunks[type_name]) > 1:
                # collapse earlier folds' chunk splits (no re-sort) so the
                # replaced ordinals land in chunk 0
                self._chunks[type_name] = [self.features(type_name)]
            n_batch = len(features)
            sr = slice_rows if slice_rows is not None else conf.STREAM_FOLD_SLICE_ROWS.get()
            if not (sr and 0 < sr < n_batch) or not self._fold_sliceable(type_name, keys):
                t0 = time.perf_counter()
                self._fold_slice_locked(type_name, features, keys, replaced, stats, presorted)
                self.last_fold_report = {
                    "rows": n_batch, "slices": 1, "slice_s": [time.perf_counter() - t0],
                }
                if on_slice is not None:
                    on_slice([str(i) for i in ids.tolist()])
                return n_batch
            self._fold_sliced_locked(
                type_name, features, keys, stats, presorted, found, sr, pacer, on_slice,
            )
        return len(features)

    def _fold_sliceable(self, type_name: str, keys: Mapping) -> bool:
        """Whether every index of ``type_name`` takes the incremental fold
        (a built one-device table and the batch's keys, no secondary sort
        words, no mesh): a fold whose indexes rebuild outright would pay a
        full build per slice, so it stays monolithic."""
        if (
            getattr(self.adapter, "fold_table", None) is None
            or getattr(self.adapter, "mesh", None) is not None
        ):
            return False
        for idx in self._indexes[type_name]:
            k = keys.get(idx.name)
            if k is None or k.sub is not None:
                return False
            old = self._tables.get((type_name, idx.name))
            if (
                not isinstance(old, IndexTable)
                or type(old)._place_cols is not IndexTable._place_cols
            ):
                return False
            parts = self._key_chunks.get((type_name, idx.name)) or []
            if any(p.sub is not None for p in parts):
                return False
        return True

    def _fold_sliced_locked(
        self, type_name, features, keys, stats, presorted, found, sr, pacer, on_slice,
    ) -> None:
        """The sliced fold loop (write lock held; see :meth:`fold_upsert`).
        Slices are batch-contiguous, so the final chunk layout (survivors,
        then the batch's rows in batch order) equals the monolithic
        fold's. ``found`` is the whole-batch id probe against the pre-fold
        table; each slice's current ordinals subtract the rank of the
        ordinals earlier slices removed (replaced ids are pre-fold rows,
        so removals only land in the surviving first chunk)."""
        from geomesa_tpu_torch.metrics import resolve
        from geomesa_tpu_torch.obs.trace import span as _ospan

        metrics = resolve(self.metrics)
        n_batch = len(features)
        n_slices = -(-n_batch // sr)
        self._fold_progress[type_name] = (0, n_slices)
        metrics.gauge("geomesa.stream.fold.progress", 0.0)
        removed_cum = np.zeros(0, dtype=np.int64)  # sorted pre-fold ordinals
        ids = np.asarray(features.ids)
        slice_s: list[float] = []
        try:
            for si, s in enumerate(range(0, n_batch, sr)):
                e = min(s + sr, n_batch)
                fault.fault_point("stream.fold.slice")
                t0 = time.perf_counter()
                with _ospan("fold.slice", index=si, rows=e - s):
                    sub_fc = features.take(np.arange(s, e, dtype=np.int64))
                    sub_keys = {name: _slice_keys(k, s, stop=e) for name, k in keys.items()}
                    sub_pre = None
                    if presorted:
                        sub_pre = {}
                        for name, perm in presorted.items():
                            perm = np.asarray(perm)
                            sel = (perm >= s) & (perm < e)
                            sub_pre[name] = perm[sel] - s
                    sub_found = found[s:e]
                    rep = np.sort(sub_found[sub_found >= 0])
                    # pre-fold ordinal -> current ordinal: subtract the rank
                    # of earlier slices' removals (appends land after the
                    # first chunk and never shift it)
                    cur = rep - np.searchsorted(removed_cum, rep, side="left")
                    # the batch sketch merges once, with the last slice,
                    # as the monolithic fold merges it
                    self._fold_slice_locked(
                        type_name, sub_fc, sub_keys, cur,
                        stats if e == n_batch else None, sub_pre,
                    )
                    removed_cum = np.union1d(removed_cum, rep)
                    self._fold_progress[type_name] = (si + 1, n_slices)
                    metrics.gauge("geomesa.stream.fold.progress", (si + 1) / n_slices)
                    metrics.counter("geomesa.stream.fold.slices")
                    slice_s.append(time.perf_counter() - t0)
                    # the per-slice pause as a live histogram
                    metrics.observe("geomesa.stream.fold.slice", slice_s[-1])
                    if on_slice is not None:
                        on_slice([str(i) for i in ids[s:e].tolist()])
                if pacer is not None and e < n_batch:
                    pacer()
        finally:
            self._fold_progress.pop(type_name, None)
            metrics.gauge("geomesa.stream.fold.progress", 0.0)
            self.last_fold_report = {"rows": n_batch, "slices": n_slices, "slice_s": slice_s}

    def _fold_slice_locked(self, type_name, features, keys, replaced, stats, presorted) -> None:
        """Fold one batch (or batch slice) whose ``replaced`` current
        ordinals all lie in chunk 0, and publish it atomically (write lock
        held; a seqlock-bracketed, assignment-only swap). Removals only
        touch the surviving first chunk, so the sliced loop never
        re-concatenates the appended slices."""
        chunks = self._chunks[type_name]
        main = chunks[0]
        n0 = len(main)
        n = sum(len(c) for c in chunks)
        keep0 = np.ones(n0, dtype=bool)
        keep0[replaced] = False
        keep_ordinal = (
            np.concatenate([keep0, np.ones(n - n0, dtype=bool)]) if n > n0 else keep0
        )
        # old ordinal -> post-delete ordinal (valid at kept rows)
        ordinal_map = np.cumsum(keep_ordinal, dtype=np.int64) - 1
        removed = main.take(replaced)
        survivors0 = main.mask(keep0)
        nk = int(keep_ordinal.sum())

        def mask_concat(old_col, new_col):
            """survivors ++ batch in one output allocation."""
            out = np.empty((nk + len(new_col),) + old_col.shape[1:], dtype=old_col.dtype)
            np.compress(keep_ordinal, old_col, axis=0, out=out[:nk])
            out[nk:] = new_col
            return out

        # build every index's merged keys and folded table before any
        # store state mutates: the publish below is assignment-only, so a
        # failure mid-build leaves the store untouched
        fold = getattr(self.adapter, "fold_table", None)
        staged: list = []  # (index, merged keys, new table, old table)
        for idx in self._indexes[type_name]:
            parts = self._key_chunks.get((type_name, idx.name)) or []
            dk = keys[idx.name]
            if parts:
                old_keys = concat_keys(parts)
                merged = WriteKeys(
                    bins=mask_concat(old_keys.bins, dk.bins),
                    zs=mask_concat(old_keys.zs, dk.zs),
                    device_cols={
                        k: mask_concat(v, dk.device_cols[k])
                        for k, v in old_keys.device_cols.items()
                    },
                    sub=(
                        mask_concat(*_pad_words(old_keys.sub, dk.sub))
                        if old_keys.sub is not None else None
                    ),
                )
            else:
                merged = dk
            old_table = self._tables.get((type_name, idx.name))
            new_table = None
            if fold is not None and old_table is not None:
                dperm = presorted.get(idx.name) if presorted else None
                new_table = fold(
                    idx, old_table, merged, keep_ordinal, ordinal_map, dk, delta_perm=dperm,
                )
            if new_table is None:
                new_table = self.adapter.create_table(idx, merged)
            staged.append((idx, merged, new_table, old_table))
        fault.fault_point("stream.fold.publish")
        # -- publish: assignment-only, seqlock-bracketed --------------------
        self._widen_bin_ranges(type_name, keys)
        self._publish_seq += 1  # odd: the swap is in flight
        for idx, merged, new_table, _ in staged:
            self._key_chunks[(type_name, idx.name)] = [merged]
            self._tables[(type_name, idx.name)] = new_table
        self._chunks[type_name] = (
            ([survivors0] if len(survivors0) else []) + list(chunks[1:]) + [features]
        )
        self._full[type_name] = None
        self._publish_seq += 1  # even: pinned readers may proceed
        for _, _, new_table, old_table in staged:
            if old_table is not None and old_table is not new_table:
                self.adapter.delete_table(old_table)
        self._merge_stats(type_name, stats)
        self._main_rows[type_name] = n - len(replaced) + len(features)
        # scoped invalidation: the replaced rows' range and the batch's
        # own range, not a whole-type bump
        self.planner.invalidate_config_memo()
        if self.cache is not None:
            if len(removed):
                self.cache.on_mutation(type_name, removed)
            self.cache.on_mutation(type_name, features)

    def _validate_replacement(self, type_name: str, features) -> None:
        """Fail before any row is deleted: a replacement batch that cannot
        be written (duplicate ids within it, unencodable keys) leaves the
        store untouched."""
        ids = np.asarray(features.ids)
        if len(np.unique(ids)) != len(ids):
            raise ValueError("duplicate feature ids in replacement batch")
        for idx in self._indexes[type_name]:
            idx.write_keys(features)  # dry-run encode; raises on bad data

    def modify_features(self, type_name: str, updates: Mapping,
                        f: "Filter | str" = INCLUDE) -> int:
        """Set attribute values on every feature matching ``f`` (reference
        FeatureStore.modifyFeatures). ``updates`` maps attribute name ->
        new value (a scalar, or a geometry for the geometry attribute).
        Index keys are derived again, so geometry and time updates move
        rows to their new index cells. Returns the modified count."""
        sft = self._schemas[type_name]
        # the lock spans query, delete and write, so the matched snapshot
        # cannot go stale under a racing writer
        with self._write_lock:
            matched = self.query(type_name, f)
            n = len(matched)
            if n == 0:
                return 0
            cols = dict(matched.columns)
            for name, value in updates.items():
                attr = sft.attr(name)  # raises KeyError on unknown names
                if attr.is_geometry:
                    # the column class follows the schema's geometry kind:
                    # a point schema stores a PointColumn, an extent schema
                    # a packed column
                    if sft.is_points:
                        if not isinstance(value, geo.Point):
                            kind = getattr(value, "geom_type", type(value).__name__)
                            raise TypeError(
                                f"{type_name!r} stores points; cannot set geometry to a {kind}"
                            )
                        cols[name] = PointColumn(np.full(n, value.x), np.full(n, value.y))
                    else:
                        cols[name] = geo.PackedGeometryColumn.from_geometries([value] * n)
                elif attr.type == "Date":
                    cols[name] = np.full(n, _date_to_millis(value), dtype=np.int64)
                else:
                    base = np.asarray(matched.columns[name])
                    if base.dtype == object:
                        cols[name] = np.array([value] * n, dtype=object)
                    elif base.dtype.kind in "US":
                        # natural width: np.full at the stored column's
                        # fixed width would truncate a longer value
                        cols[name] = np.full(n, str(value))
                    else:
                        # NaN is the store's null: None and NaN both null a
                        # float attribute (not a lossy cast)
                        if value is None and np.issubdtype(base.dtype, np.floating):
                            value = float("nan")
                        arr = np.full(n, value, dtype=base.dtype)
                        try:
                            nan_null = np.issubdtype(base.dtype, np.floating) and bool(
                                np.isnan(value)
                            )
                        except TypeError:
                            nan_null = False
                        if not (nan_null or np.all(arr == value)):
                            raise TypeError(  # lossy cast refused
                                f"value {value!r} does not fit attribute {name!r} ({base.dtype})"
                            )
                        cols[name] = arr
            updated = FeatureCollection(sft, matched.ids, cols)
            self._validate_replacement(type_name, updated)
            self.delete_features(type_name, IdFilter(tuple(np.asarray(matched.ids).tolist())))
            try:
                self.write(type_name, updated)
            except BaseException:
                # matched is the pre-delete snapshot: restore it so a write
                # failure past validation does not lose the rows
                self.write(type_name, matched)  # best-effort rollback
                raise
            return n

    def age_off(self, type_name: str, ttl_ms: int | None = None,
                now_ms: int | None = None) -> int:
        """Remove features older than ``ttl_ms`` by the schema's time
        attribute (reference AgeOffIterator compaction semantics). Returns
        the rows removed.

        ``ttl_ms=None`` reads the schema's ``geomesa.feature.expiry``
        user-data key (``"7 days"``, ``"24 hours"``, ``"30 min"``,
        ``"90 s"``, a plain millisecond count, or ``"dtg(7 days)"``).

        Deviation from the reference: GeoMesa's ``FeatureExpiration``
        treats a plain duration as ingest-time expiry (rows age out N ms
        after they were written) and only ``dtg(7 days)`` as
        attribute-based expiry. This store does not track ingest time, so
        both forms sweep by the time attribute: a feature written
        recently with an old ``dtg`` is removed here and kept by the
        reference until its ingest TTL lapses."""
        sft = self._schemas[type_name]
        if ttl_ms is None:
            spec = sft.user_data.get("geomesa.feature.expiry")
            if spec is None:
                raise ValueError(
                    f"{type_name!r}: no ttl_ms given and no "
                    "geomesa.feature.expiry user-data key on the schema"
                )
            ttl_ms = parse_expiry_ms(str(spec), dtg_field=sft.dtg_field)
        if sft.dtg_field is None:
            raise ValueError(f"{type_name!r} has no time attribute to age off")
        now = now_ms if now_ms is not None else int(time.time() * 1000)
        return self.delete_features(type_name, Cmp(sft.dtg_field, "<", now - ttl_ms))

    def _delete_features_locked(self, type_name: str, f: "Filter | str",
                                return_removed: bool = False):
        """``return_removed=True`` returns the removed rows (the rollback
        snapshot of compound ops: one scan, not two) instead of the
        count."""
        # the maintenance scan: the raw filter decides what is removed (no
        # interceptor rewrites it, no guard rejects it), past the result
        # cache (the bump below would invalidate the entry at once)
        from geomesa_tpu_torch.planning.hints import QueryHints

        plan = self.planner.plan(type_name, f, intercept=False)
        out = self.planner.execute(plan, hints=QueryHints(cache="bypass"))
        if len(out) == 0:
            return out if return_removed else 0
        ordinals = self.id_lookup(type_name, out.ids)
        full = self.features(type_name)
        keep = np.ones(len(full), dtype=bool)
        keep[ordinals] = False
        new_full = full.mask(keep)
        self._chunks[type_name] = [new_full] if len(new_full) else []
        self._full[type_name] = None
        for idx in self._indexes[type_name]:
            key = (type_name, idx.name)
            parts = self._key_chunks.get(key)
            if parts:
                keys = concat_keys(parts)
                self._key_chunks[key] = [WriteKeys(
                    bins=keys.bins[keep],
                    zs=keys.zs[keep],
                    device_cols={k: v[keep] for k, v in keys.device_cols.items()},
                    sub=keys.sub[keep] if keys.sub is not None else None,
                )]
        self._stats[type_name] = (
            self._build_stats_fresh(type_name, new_full) if len(new_full) else None
        )
        self._main_rows[type_name] = 0  # forces a full table rebuild
        self.compact(type_name)
        self._bump_cache(type_name, out)  # the removed rows' key range
        return out if return_removed else int((~keep).sum())

    def _build_stats_fresh(self, type_name: str, fc: FeatureCollection):
        from geomesa_tpu_torch.stats.store import StatsStore

        stats = StatsStore.build(self._schemas[type_name], fc)
        sketch_index = _sketch_index(self._indexes[type_name])
        for idx in self._indexes[type_name]:
            if idx.name == sketch_index and len(fc):
                _observe_sketch(stats, idx, idx.write_keys(fc))
        return stats

    def analyze_stats(self, type_name: str):
        """Sketch this type's stored rows afresh (reference geomesa-tools
        ``stats-analyze``: sketches accumulated across writes drift after
        deletes and updates; a full re-sketch restores them). Returns the
        fresh StatsStore."""
        with self._write_lock:
            fc = self.features(type_name)
            stats = self._build_stats_fresh(type_name, fc) if len(fc) else None
            self._stats[type_name] = stats
        return stats

    def stats_for(self, type_name: str):
        """The type's stats sketches (stats.StatsStore), or None before
        its first write."""
        return self._stats.get(type_name)

    def _vis_active(self, type_name: str) -> bool:
        """True when row-level visibility applies: auths configured and the
        schema names a visibility field. The device aggregations must
        then step aside: the scan mask cannot evaluate a label, so they
        would leak restricted rows into counts, grids and bounds."""
        from geomesa_tpu_torch.security import VIS_FIELD_KEY

        return self.auths is not None and bool(
            self._schemas[type_name].user_data.get(VIS_FIELD_KEY)
        )

    def _note_vis_fallback(self, explain, what: str) -> None:
        """Signal that row-level visibility disabled a device aggregation:
        a notice to the explain trail and the ``geomesa.query.vis_fallback``
        counter. Results are unchanged (the host path applies visibility
        exactly)."""
        msg = (
            f"{what} device fast path disabled: visibility filtering is "
            "active (store auths + schema visibility field); falling back "
            "to row scan + host-side aggregation"
        )
        if explain is not None:
            explain(msg)
        if self.metrics is not None:
            self.metrics.counter("geomesa.query.vis_fallback")

    def warmup(self, type_name: str) -> int:
        """Launch every scan-kernel shape of every index table once (M
        bucket ladder x predicate flags, and the fused chunk shapes), so
        the first queries pay no kernel-library load. Returns the total
        kernel calls issued."""
        total = 0
        for idx in self._indexes[type_name]:
            try:
                table = self.table(type_name, idx.name)
            except KeyError:
                continue
            main = getattr(table, "main", table)  # unwrap the delta tier
            total += main.warmup()
        return total

    def compact(self, type_name: str, presorted: "Mapping | None" = None) -> None:
        """Merge the delta tier into the index tables and collapse the
        feature chunks into one collection, every table built by the
        store's adapter. Where the old table holds exactly the compacted
        prefix, only the delta sorts and merges in
        (storage.table.merged_table: delta rows ahead of old rows with an
        equal key, device blocks before the first insertion reused);
        otherwise the old table is released and the table rebuilds from
        all rows. ``presorted`` optionally maps index names to the full
        stable (bin, z) argsort of that index's concatenated keys (the
        pipelined ingest's merged runs): the build then skips its sort.
        Adapters whose ``create_table`` takes no ``sorted_state`` are
        told apart by signature and get the plain call."""
        with self._write_lock:
            main_rows = self._main_rows[type_name]
            full = self.features(type_name)
            self._chunks[type_name] = [full] if len(full) else []
            for idx in self._indexes[type_name]:
                key = (type_name, idx.name)
                parts = self._key_chunks.get(key)
                if not parts:
                    continue
                keys = concat_keys(parts)
                self._key_chunks[key] = [keys]
                del parts  # no second copy of the key columns during the build
                old = self._tables.get(key)
                if old is not None and old.n == len(keys.zs) == main_rows:
                    continue  # empty delta: the table is current
                if old is not None and not merge_applies(old, main_rows, len(keys.zs)):
                    # release the old device columns before the rebuild uploads
                    self._tables.pop(key, None)
                    self.adapter.delete_table(old)
                    old = None
                sorted_state = None if presorted is None else presorted.get(idx.name)
                if sorted_state is not None and len(sorted_state) != len(keys.zs):
                    sorted_state = None
                if sorted_state is not None and self._adapter_takes_sorted_state():
                    table = self.adapter.create_table(
                        idx, keys, old=old, main_rows=main_rows, sorted_state=sorted_state,
                    )
                else:
                    table = self.adapter.create_table(idx, keys, old=old, main_rows=main_rows)
                if old is not None and old is not table:
                    self.adapter.delete_table(old)
                self._tables[key] = table
            self._main_rows[type_name] = len(full)

    def _adapter_takes_sorted_state(self) -> bool:
        """Whether this adapter's ``create_table`` accepts the optional
        ``sorted_state`` keyword (a custom adapter may predate it and only
        loses the skipped sort)."""
        cached = getattr(self, "_adapter_sorted_state_ok", None)
        if cached is None:
            import inspect

            try:
                params = inspect.signature(self.adapter.create_table).parameters
                cached = "sorted_state" in params or any(
                    p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
                )
            except (TypeError, ValueError):
                cached = False
            self._adapter_sorted_state_ok = cached
        return cached

    def _check_ids(self, type_name: str, ids: np.ndarray) -> None:
        """Reject duplicate ids within the batch or against the store,
        through the per-chunk id index."""
        if len(np.unique(ids)) != len(ids):
            raise ValueError("duplicate feature ids in write batch")
        for sorted_ids, _ in self._id_index(type_name):
            if not len(sorted_ids):
                continue
            probe = ids
            if probe.dtype.kind != sorted_ids.dtype.kind:
                if sorted_ids.dtype.kind in "US":
                    # natural-width cast: astype(sorted_ids.dtype) would
                    # truncate to the stored width ('12345' -> '123') and
                    # report false duplicates
                    probe = probe.astype(str)
                else:
                    try:
                        probe = probe.astype(sorted_ids.dtype)
                    except (ValueError, TypeError):
                        continue  # incomparable with this chunk only
            pos = np.searchsorted(sorted_ids, probe)
            pos = np.clip(pos, 0, len(sorted_ids) - 1)
            if np.any(sorted_ids[pos] == probe):
                raise ValueError("duplicate feature ids in write batch")

    def _id_index(self, type_name: str, chunks: "list | None" = None) -> list:
        """Per-chunk ``(sorted ids, global argsort order)`` pairs for id
        lookups, built lazily per chunk (no Python dict over every id),
        so an appended chunk sorts only itself. Each cached entry holds
        the chunk object it was built from and is rebuilt when the chunk
        at its position is another object: every mutation that renumbers
        ordinals replaces chunk objects, so no invalidation at the
        mutation sites can be missed. ``chunks``: a
        :meth:`chunk_snapshot` to resolve against."""
        if chunks is None:
            chunks = list(self._chunks.get(type_name, []))
        with self._id_lock:
            entries = self._id_sorted.get(type_name)
            if not isinstance(entries, list):
                entries = []
                self._id_sorted[type_name] = entries
            while len(entries) < len(chunks):
                entries.append(None)
            del entries[len(chunks):]  # collapsed chunks: drop the stale tail
            out = []
            base = 0
            for i, c in enumerate(chunks):
                e = entries[i]
                if e is None or e[0] is not c:
                    ids = np.asarray(c.ids)
                    order = np.argsort(ids, kind="stable")
                    e = (c, ids[order], order.astype(np.int64) + base)
                    entries[i] = e
                out.append((e[1], e[2]))
                base += len(c)
            return out

    def _widen_bin_ranges(self, type_name: str, new_keys: Mapping) -> None:
        """Widen each index's known time-bin range (open-ended temporal
        predicates clamp to it; see index.z3.clamp_bins)."""
        for idx in self._indexes[type_name]:
            keys = new_keys[idx.name]
            tb = keys.device_cols.get("tbin")
            if tb is None and "tw" in keys.device_cols:
                from geomesa_tpu_torch.index.z3 import unpack_tw

                tb = unpack_tw(keys.device_cols["tw"])[0]
            if tb is not None and len(tb):
                lo, hi = int(tb.min()), int(tb.max())
                p = idx.bin_range
                idx.bin_range = (lo, hi) if p is None else (min(p[0], lo), max(p[1], hi))

    # -- tables and rows -------------------------------------------------
    def table(self, type_name: str, index_name: str) -> "IndexTable | TieredTable":
        """The scan surface of one index: the device table, wrapped with
        the host delta tier while writes since the last compaction exist."""
        table = self._tables[(type_name, index_name)]
        main_rows = self._main_rows.get(type_name, 0)
        if self.row_count(type_name) <= main_rows:
            return table
        # the delta is the rows past the compacted prefix, found by walking
        # the key parts (their boundaries align with the feature chunks)
        delta, seen = [], 0
        for p in self._key_chunks[(type_name, index_name)]:
            n = len(p.zs)
            if seen + n > main_rows:
                delta.append(_slice_keys(p, max(main_rows - seen, 0)))
            seen += n
        return TieredTable(table, concat_keys(delta), main_rows)

    def features(self, type_name: str) -> FeatureCollection:
        chunks = self._chunks.get(type_name, [])
        if not chunks:
            return FeatureCollection.from_rows(self._schemas[type_name], [])
        if len(chunks) == 1:
            return chunks[0]
        full = self._full.get(type_name)
        if full is None or len(full) != sum(len(c) for c in chunks):
            full = FeatureCollection.concat(chunks)
            self._full[type_name] = full
        return full

    def row_count(self, type_name: str) -> int:
        return sum(len(c) for c in self._chunks.get(type_name, []))

    def pin_scan_state(self, type_name: str, index_name: str):
        """(scan table, chunk snapshot) captured consistently against the
        fold's publishes: the two reads retry while ``_publish_seq`` is
        odd or moved (the publish is an assignment-only swap, so retries
        are brief). A scan launched on the returned table gathers its
        ordinals against the returned snapshot however long the device
        work takes: publishes swap in fresh lists and never mutate a
        pinned one."""
        table = chunks = None
        for _ in range(64):
            s0 = self._publish_seq
            table = self.table(type_name, index_name)
            chunks = self.chunk_snapshot(type_name)
            if self._publish_seq == s0 and not (s0 & 1):
                break
        return table, chunks

    def chunk_snapshot(self, type_name: str) -> list:
        """A point-in-time copy of the chunk list, for ordinals resolved
        now and gathered later: renumbering mutations (delete, fold) swap
        in a new list and never mutate the old one."""
        return list(self._chunks.get(type_name, []))

    def gather(self, type_name: str, ordinals: np.ndarray,
               chunks: "list | None" = None) -> FeatureCollection:
        """Features at the given ordinals, in ``ordinals`` order, gathered
        per chunk without building the full concat. ``chunks``: the
        :meth:`chunk_snapshot` the ordinals were resolved against."""
        if chunks is None:
            chunks = self._chunks.get(type_name, [])
        if not chunks:
            return FeatureCollection.from_rows(self._schemas[type_name], [])
        if len(chunks) == 1:
            return chunks[0].take(ordinals)
        ordinals = np.asarray(ordinals, dtype=np.int64)
        bases = np.cumsum([0] + [len(c) for c in chunks])
        which = np.searchsorted(bases, ordinals, side="right") - 1
        parts, positions = [], []
        for ci in range(len(chunks)):
            sel = np.flatnonzero(which == ci)
            if len(sel):
                parts.append(chunks[ci].take(ordinals[sel] - bases[ci]))
                positions.append(sel)
        if not parts:
            return chunks[0].take(np.zeros(0, np.int64))
        if len(parts) == 1 and len(parts[0]) == len(ordinals):
            return parts[0]  # one chunk holds every hit: already in order
        cat = FeatureCollection.concat(parts)
        inv = np.empty(len(ordinals), np.int64)
        inv[np.concatenate(positions)] = np.arange(len(ordinals))
        return cat.take(inv)

    def _id_find(self, type_name: str, ids: Iterable, chunks: "list | None" = None) -> np.ndarray:
        """Per-input ordinal (or -1) of each requested id, probing every
        chunk's sorted index (ids are store-unique, so at most one chunk
        hits per input)."""
        want = np.asarray(list(ids))
        found = np.full(len(want), -1, dtype=np.int64)
        for sorted_ids, order in self._id_index(type_name, chunks=chunks):
            if not len(sorted_ids):
                continue
            probe = want
            if probe.dtype.kind != sorted_ids.dtype.kind:
                try:
                    probe = probe.astype(sorted_ids.dtype)
                except (ValueError, TypeError):
                    continue
            for s in range(0, len(probe), self._ID_PROBE_SLICE):
                sub = probe[s : s + self._ID_PROBE_SLICE]
                pos = np.searchsorted(sorted_ids, sub)
                pos = np.clip(pos, 0, len(sorted_ids) - 1)
                hit = sorted_ids[pos] == sub
                found[s : s + self._ID_PROBE_SLICE][hit] = order[pos[hit]]
        return found

    def id_lookup(self, type_name: str, ids: Iterable,
                  chunks: "list | None" = None) -> np.ndarray:
        """Ordinals of the stored ids among ``ids``, in ``ids`` order."""
        found = self._id_find(type_name, ids, chunks=chunks)
        return found[found >= 0]

    def id_exists_mask(self, type_name: str, ids: Iterable) -> np.ndarray:
        """Boolean mask aligned with ``ids``: which are in the store."""
        return self._id_find(type_name, ids) >= 0

    # -- query controls --------------------------------------------------
    def apply_interceptors(self, type_name: str, f: Filter) -> Filter:
        """Run filter-rewriting interceptors in order (reference
        QueryInterceptor SPI, hooked at QueryPlanner.scala:155). An
        interceptor may define ``applies_to(sft) -> bool`` to scope itself
        to matching schemas (AgeOffInterceptor skips types without its
        time attribute)."""
        sft = self._schemas.get(type_name)
        for ic in self.interceptors:
            applies = getattr(ic, "applies_to", None)
            if applies is not None and sft is not None and not applies(sft):
                continue
            f = ic.rewrite(type_name, f)
        return f

    def apply_guards(self, plan) -> None:
        """Run every configured guard over a finished plan; guards raise
        QueryGuardError to reject (reference planning/guard/). The
        ``block_full_table_scans`` flag is read at query time so it can be
        toggled on a live store."""
        from geomesa_tpu_torch.planning.guards import FullTableScanGuard

        sft = self._schemas[plan.type_name]
        guards = list(self.guards)
        if self.block_full_table_scans and not any(
            isinstance(g, FullTableScanGuard) for g in guards
        ):
            guards.append(FullTableScanGuard())
        for g in guards:
            g.guard(plan, sft)

    # -- queries ---------------------------------------------------------
    def query(
        self,
        type_name: str,
        f: "Filter | str" = INCLUDE,
        limit: Optional[int] = None,
        explain: Explainer | None = None,
        hints=None,
    ) -> FeatureCollection:
        """Run a query; returns the matching features as a collection.
        ``hints`` is an optional planning.hints.QueryHints.

        When tracing is armed the whole call is one trace (plan, scan and
        decode phases), retained per ``geomesa.obs.trace.sample``, captured
        into the slow-query ring past ``geomesa.obs.slow.ms``, and
        appended to ``explain`` as a per-phase breakdown."""
        from geomesa_tpu_torch.obs.trace import phase_breakdown, tracer

        with tracer().trace("query", type=type_name) as trace:
            plan = self.planner.plan(type_name, f, limit=limit, explain=explain)
            if trace is not None:
                trace.fingerprint = {
                    "type": type_name,
                    "strategy": plan.strategy,
                    "filter": str(plan.filter),
                }
            out = self.planner.execute(plan, explain=explain, hints=hints)
        if explain is not None and trace is not None:
            for line in phase_breakdown(trace):
                explain(line)
            explain.trace = trace
        return out

    def query_many(
        self,
        type_name: str,
        filters: "Sequence[Filter | str]",
        limit: Optional[int] = None,
        hints=None,
    ) -> list[FeatureCollection]:
        """Run several queries with every device scan launched before any
        result is pulled; index scans on one table fuse into one kernel
        launch per chunk. Per-query results equal sequential ``query``.
        ``hints``: one QueryHints for all, or one per filter."""
        plans = [self.planner.plan(type_name, f, limit=limit) for f in filters]
        return self.planner.execute_many(plans, hints=hints)

    def record_query(self, plan, hits: int, scan_s: float) -> None:
        """Audit and metrics sink for every executed plan: the planner
        calls it from execute(), and the aggregation fast paths call it
        directly, so density, count and bounds scans are recorded like row
        queries (reference AuditWriter covers all query types). The
        plan's sketch estimate is held against the rows it matched (not
        for cache hits, which scanned nothing); a misestimate past the
        staleness threshold checks the window and, with
        ``geomesa.plan.estimate.auto.analyze`` on, sketches the type
        afresh, once per trip. An armed tuning tier counts the query
        toward its next pulse."""
        if plan.estimated_rows is not None and plan.cache_status not in ("hit", "coalesced"):
            actual = plan.actual_rows if plan.actual_rows is not None else hits
            err = self.accuracy.record(plan.type_name, plan.index, plan.estimated_rows, actual)
            if self.metrics is not None:
                self.metrics.observe("geomesa.plan.estimate.error", err)
            if (
                err > float(conf.PLAN_ESTIMATE_STALE_P90.get() or 0)
                and conf.PLAN_ESTIMATE_AUTO_ANALYZE.get()
                and any(t == plan.type_name for t, _, _ in self.accuracy.stale())
                # one trip fires one analyze: concurrent threads past the
                # stale check race to this atomic claim, exactly one wins
                and self.accuracy.claim_analyze(plan.type_name)
            ):
                if self.metrics is not None:
                    self.metrics.counter("geomesa.plan.estimate.analyze")
                try:
                    self.analyze_stats(plan.type_name)
                finally:
                    # the fresh sketches earn their own record (this also
                    # releases the claim, even after a failed analyze)
                    self.accuracy.reset(plan.type_name)
        if self.metrics is not None:
            self.metrics.counter("geomesa.query.count")
            self.metrics.counter("geomesa.query.hits", max(hits, 0))
            if plan.warnings:
                # degraded-mode answer: results exclude quarantined data
                self.metrics.counter("geomesa.query.degraded")
            self.metrics.timer_update("geomesa.query.plan", plan.planning_s)
            # query latency as a live histogram (p50 / p99 off the registry)
            self.metrics.observe("geomesa.query.scan", scan_s)
            if self.cache is not None and plan.cache_status in (None, "miss"):
                # a scanned query feeds the tile tier's cost gate (hits
                # measure the cache, not the scan being replaced)
                self.cache.tiles.note_scan(plan.type_name, scan_s)
            if plan.queue_wait_s:
                # serving-tier attribution: the time queued behind the
                # micro-batch window, apart from the scan time
                self.metrics.observe("geomesa.serving.queue_wait", plan.queue_wait_s)
            if plan.cache_status is not None:
                # cache overhead, apart from the scan time
                self.metrics.timer_update("geomesa.query.cache_probe", plan.cache_probe_s)
        # self-tuning pacing: an armed tuning tier counts every recorded
        # query and runs one adaptation pulse per interval in this
        # caller's thread (no lock is held here; a disarmed or absent
        # manager costs one attribute read)
        tuning = self.tuning
        if tuning is not None and tuning.enabled:
            tuning.on_query()
        if self.audit is not None:
            from geomesa_tpu_torch.audit import AuditedEvent
            from geomesa_tpu_torch.obs.trace import tracer

            # cross-reference key: the active trace's id, shared with the
            # slow-query ring and the Chrome export (None when disarmed)
            cur = tracer().current()
            self.audit.write(
                AuditedEvent(
                    type_name=plan.type_name,
                    filter=str(plan.filter),
                    strategy=plan.strategy,
                    n_ranges=plan.config.n_ranges if plan.config is not None else 0,
                    hits=hits,
                    planning_ms=plan.planning_s * 1e3,
                    scanning_ms=scan_s * 1e3,
                    trace_id=cur.trace.trace_id if cur is not None else None,
                )
            )

    def dump_trace(self, path: str) -> str:
        """Write every retained trace (sampled buffer and slow-query ring)
        as Chrome trace-event JSON (chrome://tracing, Perfetto) and return
        the path. Tracing arms with ``geomesa.obs.trace.sample`` /
        ``geomesa.obs.slow.ms``."""
        from geomesa_tpu_torch.obs.trace import tracer

        return tracer().dump(path)

    def slow_queries(self, type_name: "str | None" = None) -> list:
        """The slow-query ring (newest last): operations over
        ``geomesa.obs.slow.ms``, each with wall time, plan fingerprint and
        span tree. ``type_name`` filters by the fingerprint's schema."""
        from geomesa_tpu_torch.obs.trace import tracer

        return tracer().slow_queries(type_name=type_name)

    def serve(self, config=None, port: "int | None" = None,
              host: "str | None" = None, **server_kwargs):
        """Attach (or return) the micro-batch serving tier: concurrent
        callers ``submit()`` through the returned, started QueryScheduler,
        and compatible index scans coalesce into fused launches. The
        scheduler counts into this store's registry (or the process-global
        one). ``config``: None or True builds a ServingConfig from the
        conf.py knobs; a ServingConfig is used as given. Returns the
        attached scheduler while it is open; a closed one is replaced.
        Thread-safe: the write lock keeps concurrent first callers from
        starting two schedulers. A TenantRegistry attaches as
        ``serve().tenants``.

        With ``port`` (0 = ephemeral), also mounts the network data plane
        and returns the started
        :class:`~geomesa_tpu_torch.serving.http.DataServer` instead: query,
        ingest, tile and ops endpoints over this store, multi-tenant
        admission through the scheduler. ``server_kwargs`` pass through to
        it."""
        from geomesa_tpu_torch.serving import QueryScheduler, ServingConfig

        if port is not None:
            from geomesa_tpu_torch.serving.http import DataServer

            with self._write_lock:
                srv = self.server
                if srv is not None and not srv.closed:
                    return srv
                self.server = DataServer(
                    self, host=host, port=port, config=config, **server_kwargs
                ).start()
                return self.server
        with self._write_lock:
            sched = self.scheduler
            if sched is not None and not sched.closed:
                return sched
            if config is None or config is True:
                config = ServingConfig()
            self.scheduler = QueryScheduler(self, config).start()
            # an armed tuning tier attached before serve(): wire its burn
            # gate onto the fresh scheduler
            tuning = self.tuning
            if tuning is not None and tuning.enabled:
                self.scheduler.burn_gate = tuning.burnshed
            return self.scheduler

    def serve_ops(self, port: int = 0, host: "str | None" = None, lam=None):
        """Attach (or return) the ops plane: a threaded HTTP endpoint
        serving ``/metrics``, the composite ``/health`` verdict, ``/stats``
        and the debug surfaces, with a TelemetryRecorder writing bounded
        history rings. ``port=0`` binds an ephemeral port (read it back
        from ``ds.ops.port``); ``host`` defaults to the
        ``geomesa.obs.ops.host`` knob (loopback). ``lam``: the LambdaStore
        whose hot tier and WAL join the health surface
        (``LambdaStore.serve_ops`` passes itself). Returns the attached
        server while it is open; a closed one is replaced."""
        from geomesa_tpu_torch.obs.ops import OpsServer

        with self._write_lock:
            ops = self.ops
            if ops is not None and not ops.closed:
                return ops
            self.ops = OpsServer(self, lam=lam, host=host, port=port).start()
            return self.ops

    def close(self) -> None:
        """Release the attached background services: the data plane
        (socket closed, serve thread joined), the serving scheduler
        (drained, its dispatcher joined) and the ops endpoint (socket
        closed, serve and telemetry threads joined, bounded), and save an
        attached tuning tier's learned state. Idempotent; the store
        itself stays queryable, and serve() / serve_ops() attach fresh
        ones."""
        srv = self.server
        if srv is not None:
            srv.close()
        sched = self.scheduler
        if sched is not None:
            sched.close()
        ops = self.ops
        if ops is not None:
            ops.close()
        tuning = self.tuning
        if tuning is not None:
            # learned state outlives the store handle: factors, controller
            # baselines, tuned knobs
            tuning.save()

    def attach_tuning(self, enabled=None, state_path=None, interval=None):
        """Attach the self-tuning controller tier: one
        :class:`~geomesa_tpu_torch.tuning.manager.TuningManager` closing
        the loop from this store's telemetry (estimate-accuracy windows,
        metric rings, SLO burn) to its knobs, plan weights and admission.
        ``enabled`` defaults to the ``geomesa.tuning.enabled`` knob; a
        disarmed manager reports state but never pulses, never installs
        the planner or scheduler hooks, and leaves behavior unchanged.
        ``state_path`` names a JSON file the learned state persists to on
        :meth:`close` and rehydrates from here. Re-attaching builds a
        fresh manager and re-wires the hooks. Returns the manager."""
        from geomesa_tpu_torch.metrics import MetricsRegistry
        from geomesa_tpu_torch.tuning import TuningManager

        if self.metrics is None:
            # the tier is telemetry-driven: without a registry there is
            # nothing to sense, so attach one (as attach_slo does)
            self.metrics = MetricsRegistry()
        manager = TuningManager(self, enabled=enabled, state_path=state_path, interval=interval)
        self.tuning = manager
        sched = self.scheduler
        if manager.enabled:
            self.planner.reweighter = manager.reweighter
            if sched is not None:
                sched.burn_gate = manager.burnshed
        else:
            # disarming restores the untuned behavior, also after a
            # previously armed manager is replaced
            self.planner.reweighter = None
            if sched is not None:
                sched.burn_gate = None
        return manager

    def tuning_report(self) -> dict:
        """The attached tuning manager's report, the ``/debug/tuning``
        payload (controller values, bounds and readings, plan factors,
        burn gate state, decision ring). An unattached store reports a
        disarmed, empty tier."""
        if self.tuning is None:
            return {
                "enabled": False, "controllers": [], "plan_factors": {},
                "burn": None, "decisions": [],
            }
        return self.tuning.report()

    def attach_slo(self, objectives=None):
        """Attach an SLO tracker: declarative latency objectives evaluated
        over sliding windows. ``objectives`` is a sequence of
        obs.slo.SloObjective (default: the knob-configured
        ``default_objectives()``) or an already-built SloTracker. A store
        without a metrics registry gets one: the tracker subscribes to the
        registry's histogram observations. Replacing this store's tracker
        detaches the old one from the registry first. Returns the
        tracker."""
        from geomesa_tpu_torch.metrics import MetricsRegistry
        from geomesa_tpu_torch.obs.slo import SloTracker

        if self.metrics is None:
            self.metrics = MetricsRegistry()
        tracker = objectives if isinstance(objectives, SloTracker) else SloTracker(objectives)
        # without the detach every re-attach would chain another fan-out
        # layer onto the observer (attach fans out only for trackers it
        # does not know: other stores sharing the registry)
        if self.slo is not None and getattr(self.metrics, "observer", None) == self.slo.observe:
            self.metrics.observer = None
        self.slo = tracker.attach(self.metrics)
        return self.slo

    def slo_report(self) -> dict:
        """The attached SLO tracker's report — the payload ``/health``
        carries (status, per-objective windowed quantiles, burn rates). An
        unattached store reports ok with no objectives."""
        if self.slo is None:
            return {"status": "ok", "window_s": 0.0, "objectives": []}
        return self.slo.report()

    def bin_query(
        self,
        type_name: str,
        f: "Filter | str" = INCLUDE,
        track: str | None = None,
        label: str | None = None,
        sort: bool = False,
    ) -> bytes:
        """Matching features as packed 16/24-byte BIN records (reference
        BinAggregatingScan + BinaryOutputEncoder; utils.bin_format): the
        query runs through the planner and its scan kernels, the records
        encode on the host. ``track=None`` correlates by id."""
        from geomesa_tpu_torch.utils import bin_format

        sft = self._schemas[type_name]
        out = self.query(type_name, f)
        lon, lat = out.representative_xy()
        dtg = (
            np.asarray(out.columns[sft.dtg_field], dtype=np.int64)
            if sft.dtg_field
            else np.zeros(len(out), np.int64)
        )
        track_col = out.ids if track is None else out.columns[track]
        label_col = out.columns[label] if label else None
        return bin_format.encode(lon, lat, dtg, track_col, label_col, sort=sort)

    def count(self, type_name: str, f: "Filter | str" = INCLUDE) -> int:
        """Exact hit count (scan + refine; a polygon filter with a raster
        counts its certain rows without gathering them; a pure-bbox count
        on a cached store composes from the tile-aggregate cache, still
        exact). INCLUDE counts the rows outright unless visibility or an
        interceptor may hide some."""
        if isinstance(f, Include) and not self._vis_active(type_name) and not self.interceptors:
            return self.row_count(type_name)
        plan = self.planner.plan(type_name, f)
        if self.cache is not None:
            t0 = time.perf_counter()
            comp = self._tile_compose(type_name, plan.filter)
            if comp is not None:
                self._record_composed(plan, comp, t0)
                return comp.count
        if self._raster_agg_eligible(type_name, plan):
            return self._raster_agg_scan(type_name, plan)[0]
        return len(self.planner.execute(plan))

    def estimate_count(self, type_name: str, f: "Filter | str" = INCLUDE) -> int:
        """Estimated hit count from the stats sketches, without a scan
        (reference GeoMesaStats.getCount / StatsBasedEstimator): the
        marginal-histogram product first, then the z-prefix sketch over
        the index that feeds it, then an exact count where no sketch
        covers the filter. With visibility active the count is exact (the
        sketches cannot see labels)."""
        from geomesa_tpu_torch.filter import ecql

        if isinstance(f, str):
            f = ecql.parse(f)
        if self._vis_active(type_name):
            return self.count(type_name, f)
        # interceptor rewrites apply to estimates too: the sketch tiers
        # never reach the planner's rewrite hook
        f = self.apply_interceptors(type_name, f)
        if isinstance(f, Include):
            return len(self.features(type_name))
        stats = self.stats_for(type_name)
        if stats is not None:
            est = stats.estimate_filter(self._schemas[type_name], f)
            if est is not None:
                return int(round(est))
            # the z-prefix sketch over the index that feeds it (z2 ranges
            # against a z3-keyed sketch would estimate ~0)
            idx = next((i for i in self._indexes[type_name] if i.name == stats.z_index), None)
            if idx is not None:
                cfg = idx.scan_config(f)
                if cfg is not None:
                    if cfg.disjoint:
                        return 0
                    est = stats.estimate_scan(idx.name, cfg)
                    if est is not None:
                        return int(round(est))
        # exact fallback on the already rewritten filter: no second
        # interceptor pass, but guarded (a user-facing query)
        plan = self.planner.plan(type_name, f, intercept=False, guard=True)
        return len(self.planner.execute(plan))

    def _device_aggregable(self, type_name: str, plan, explain=None, what: str = "") -> bool:
        """Whether a gather-free aggregation kernel may answer this plan:
        the kernels decide its filter (never for a polygon config: they
        test the box only) and visibility is off. Where only visibility
        stands in the way, the fallback is signalled
        (``_note_vis_fallback``) and the host path answers."""
        eligible = plan.ids is None and plan.index is not None and mask_decides_filter(
            plan.filter, plan.config, self._schemas[type_name], for_aggregation=True
        )
        if eligible and self._vis_active(type_name):
            self._note_vis_fallback(explain, what)
            return False
        return eligible

    def _tile_compose(self, type_name: str, f, explain=None):
        """Tile-aggregate composition for a pure-bbox aggregation: cached
        interior tiles plus fresh edge scans, or None when ineligible. The
        tile tier serves point schemas with no row visibility and no
        interceptors (both change per-row membership in ways a cached
        tile cannot represent), for one in-world BBox on the geometry
        field."""
        from geomesa_tpu_torch.filter.predicates import BBox

        cache = self.cache
        if cache is None or not cache.tiles.enabled or not isinstance(f, BBox):
            return None
        sft = self._schemas[type_name]
        if (
            f.prop != sft.geom_field
            or not sft.is_points
            or self._vis_active(type_name)
            or self.interceptors
            or not (-180.0 <= f.xmin <= f.xmax <= 180.0)
            or not (-90.0 <= f.ymin <= f.ymax <= 90.0)
        ):
            return None
        if not cache.tiles.worth_composing(type_name):
            # the cost gate: measured compositions lose to the plain scan
            return None
        comp = cache.tiles.compose(self, type_name, f)
        if comp is not None and explain is not None:
            status = "hit" if comp.tiles_filled == 0 else "partial"
            explain(
                f"cache: {status} ({comp.tiles_reused}/{comp.tiles_total} "
                f"tiles reused, probe {comp.probe_s * 1e3:.3f}ms)"
            )
        return comp

    def _record_composed(self, plan, comp, t0: float) -> None:
        """Record a tile composition as a cache-served plan, so its own
        duration stays out of the tile tier's plain-scan baseline."""
        plan.cache_status = "hit" if comp.tiles_filled == 0 else "partial"
        plan.cache_probe_s = comp.probe_s
        self.record_query(plan, comp.count, time.perf_counter() - t0)

    def _agg_deadline(self):
        """Deadline of a device aggregation call from the store default
        (the aggregation entry points take no hints; a launched kernel
        runs to its end, so the check lands at the next stage boundary)."""
        from geomesa_tpu_torch.planning.errors import deadline_from

        return deadline_from(self.query_timeout)

    def _agg_check_deadline(self, deadline, stage: str) -> None:
        """check_deadline for the aggregation fast paths, with the
        planner's timeout accounting: an overdue density, count or bounds
        scan counts in ``geomesa.query.timeout``."""
        from geomesa_tpu_torch.planning.errors import QueryTimeout

        try:
            check_deadline(deadline, stage)
        except QueryTimeout:
            if self.metrics is not None:
                self.metrics.counter("geomesa.query.timeout")
            raise

    # -- raster aggregation push-down ------------------------------------
    def _raster_agg_eligible(self, type_name: str, plan) -> bool:
        """Whether a plan may take the raster aggregation path: a polygon
        config carrying a raster stack whose row-scan mask decides the
        filter. Such configs stay off the gather-free aggregations (their
        kernels test the box only), but count, bounds and Count() stats
        can still skip the full candidate gather: full raster cells decide
        membership outright and only the boundary residue refines. Only on
        a point schema without row visibility."""
        cfg = plan.config
        sft = self._schemas[type_name]
        return (
            plan.ids is None
            and plan.index is not None
            and cfg is not None
            and not cfg.disjoint
            and cfg.rast is not None
            and sft.is_points
            and not self._vis_active(type_name)
            and mask_decides_filter(plan.filter, cfg, sft)
        )

    def _raster_agg_scan(self, type_name: str, plan, explain=None):
        """(hit count, hit ordinals, chunk snapshot) of a raster-eligible
        plan: the scan's certain rows (full cells, contained ranges) are
        accepted without a gather; only the uncertain residue gathers and
        refines in f64. Recorded (``record_query``,
        ``geomesa.query.raster_agg``) like the other aggregation fast
        paths."""
        deadline = self._agg_deadline()
        t0 = time.perf_counter()
        # pinned pair: the residue gather resolves the scan's ordinals
        # against the chunk list the table was built over, not whatever
        # a publish swaps in mid-scan
        table, chunks = self.pin_scan_state(type_name, plan.index)
        ordinals, certain = table.scan_submit(plan.config, clock=self.clock)()
        self._agg_check_deadline(deadline, "raster aggregation scan")
        cert_ords = ordinals[certain]
        unc = ordinals[~certain]
        if len(unc):
            with self.clock.host("refine"):
                sub = self.gather(type_name, unc, chunks=chunks)
                m = plan.filter.evaluate(sub.batch)
            self._agg_check_deadline(deadline, "raster residue refinement")
            hits = np.concatenate([cert_ords, unc[m]])
        else:
            hits = cert_ords
        if explain is not None:
            explain(
                f"raster aggregation push-down: {len(cert_ords)} certain "
                f"(full cells / contained ranges), {len(unc)} residue rows "
                "re-checked exactly"
            )
        if self.metrics is not None:
            self.metrics.counter("geomesa.query.raster_agg")
        self.record_query(plan, len(hits), time.perf_counter() - t0)
        return len(hits), hits, chunks

    def _raster_agg_bounds(self, type_name: str, plan, explain=None):
        """(count, exact envelope | None) through the raster scan: the hit
        coordinates come straight from the point columns, chunk by chunk
        of the scan's pinned snapshot, with no row gather and no full
        concat (order is irrelevant to min/max)."""
        n, hits, chunks = self._raster_agg_scan(type_name, plan, explain=explain)
        if n == 0:
            return 0, None
        hits = np.sort(np.asarray(hits, dtype=np.int64))
        env = None
        base = 0
        for c in chunks:
            lo = np.searchsorted(hits, base)
            hi = np.searchsorted(hits, base + len(c))
            if hi > lo:
                col = c.geom_column
                sel = hits[lo:hi] - base
                x, y = col.x[sel], col.y[sel]
                e = (float(x.min()), float(y.min()), float(x.max()), float(y.max()))
                env = e if env is None else (
                    min(env[0], e[0]), min(env[1], e[1]),
                    max(env[2], e[2]), max(env[3], e[3]),
                )
            base += len(c)
        return n, env

    def density(
        self,
        type_name: str,
        f: "Filter | str" = INCLUDE,
        envelope: tuple | None = None,
        width: int = 256,
        height: int = 256,
        weight: str | None = None,
        explain=None,
    ) -> np.ndarray:
        """[height, width] density grid (reference DensityScan push-down).
        When the chosen index's device mask decides the whole filter and no
        weight attribute is requested, the grid renders on device; else
        rows gather to host and the grid is a numpy scatter over refined
        results."""
        return self.density_many(
            type_name, [(f, envelope)], width=width, height=height,
            weight=weight, explain=explain,
        )[0]

    def density_many(
        self,
        type_name: str,
        requests: Sequence,
        width: int = 256,
        height: int = 256,
        weight: str | None = None,
        explain=None,
    ) -> list[np.ndarray]:
        """Many density grids (a map frame's tiles), every tile's device
        kernel launched before any grid is pulled. ``requests`` is a
        sequence of (filter, envelope) pairs (envelope None = the whole
        world). Results equal sequential :meth:`density` calls."""
        staged: list = []  # (kind, payload) per request, in order
        for f, envelope in requests:
            if envelope is None:
                envelope = (-180.0, -90.0, 180.0, 90.0)
            plan = self.planner.plan(type_name, f, explain=explain)
            if weight is not None or not self._device_aggregable(
                type_name, plan, explain, "density"
            ):
                staged.append(("host", (plan, envelope)))
            elif plan.config.disjoint:
                self.record_query(plan, 0, 0.0)
                staged.append(("empty", None))
            else:
                staged.append(("device", (plan, self.table(type_name, plan.index).density_submit(
                    plan.config, envelope, width, height, clock=self.clock
                ))))
        out: list = []
        for kind, payload in staged:
            if kind == "empty":
                out.append(np.zeros((height, width), dtype=np.float32))
            elif kind == "device":
                # a fresh deadline and timing per tile, as sequential
                # density() calls have
                plan, finish = payload
                deadline = self._agg_deadline()
                t0 = time.perf_counter()
                grid = finish()
                self._agg_check_deadline(deadline, "density scan")
                self.record_query(plan, int(grid.sum()), time.perf_counter() - t0)
                out.append(grid)
            else:
                plan, envelope = payload
                rows = self.planner.execute(plan, explain=explain)
                out.append(_host_density(rows, envelope, width, height, weight))
        return out

    def stats_query(
        self,
        type_name: str,
        spec: str,
        f: "Filter | str" = INCLUDE,
        estimate: bool = False,
        explain=None,
    ) -> list:
        """Evaluate a Stat DSL spec over the query hits (reference
        StatsScan / StatsProcess; grammar in stats.stat_spec).

        ``estimate=True`` takes the device fast path for ``Count()`` terms
        when the scan mask decides the filter: a count-only kernel with no
        row gather (loose f32-widened semantics, like the reference's
        estimate-only stats). ``Count()`` alone over a polygon filter with
        a raster takes the raster push-down, exact, either way, and a
        pure-bbox ``Count()`` on a cached store composes from the tile
        cache, exact, either way."""
        from geomesa_tpu_torch.stats import stat_spec
        from geomesa_tpu_torch.stats.sketches import CountStat

        terms = stat_spec.parse(spec)
        plan = self.planner.plan(type_name, f, explain=explain)
        counts_only = all(t.kind == "count" for t in terms)
        if counts_only:
            t0 = time.perf_counter()
            comp = self._tile_compose(type_name, plan.filter, explain=explain)
            if comp is not None:
                self._record_composed(plan, comp, t0)
                out = []
                for _ in terms:
                    c = CountStat()
                    c.count = comp.count
                    out.append(c)
                return out
        if counts_only and self._raster_agg_eligible(type_name, plan):
            n = self._raster_agg_scan(type_name, plan, explain=explain)[0]
            out = []
            for _ in terms:
                c = CountStat()
                c.count = n
                out.append(c)
            return out
        if (
            estimate
            and counts_only
            and self._device_aggregable(type_name, plan, explain, "count estimate")
        ):
            deadline = self._agg_deadline()
            t0 = time.perf_counter()
            n = (
                0 if plan.config.disjoint
                else self.table(type_name, plan.index).count(plan.config, clock=self.clock)
            )
            self._agg_check_deadline(deadline, "count scan")
            self.record_query(plan, n, time.perf_counter() - t0)
            out = []
            for _ in terms:
                c = CountStat()
                c.count = n
                out.append(c)
            return out
        return stat_spec.evaluate_terms(terms, self.planner.execute(plan, explain=explain))

    def bounds(
        self, type_name: str, f: "Filter | str" = INCLUDE,
        estimate: bool = True, explain=None,
    ) -> Optional[tuple]:
        """Spatial envelope (xmin, ymin, xmax, ymax) of matching features,
        or None when nothing matches (reference GeoMesaStats.getBounds).
        ``estimate=True`` uses the device bounds kernel without a row
        gather when the scan mask decides the filter (loose f32
        semantics); otherwise exact from the refined results. A polygon
        filter with a raster gives the exact envelope through the raster
        push-down, either way, and a pure-bbox filter on a cached store
        composes its exact envelope from the tile cache."""
        plan = self.planner.plan(type_name, f, explain=explain)
        if not isinstance(plan.filter, Include):
            t0 = time.perf_counter()
            comp = self._tile_compose(type_name, plan.filter, explain=explain)
            if comp is not None:
                self._record_composed(plan, comp, t0)
                return comp.bounds
        if not isinstance(plan.filter, Include) and self._raster_agg_eligible(type_name, plan):
            return self._raster_agg_bounds(type_name, plan, explain=explain)[1]
        if (
            estimate
            and not isinstance(plan.filter, Include)
            and self._device_aggregable(type_name, plan, explain, "bounds")
        ):
            if plan.config.disjoint:
                self.record_query(plan, 0, 0.0)
                return None
            deadline = self._agg_deadline()
            t0 = time.perf_counter()
            cnt, env = self.table(type_name, plan.index).bounds_stats(
                plan.config, clock=self.clock
            )
            self._agg_check_deadline(deadline, "bounds scan")
            self.record_query(plan, cnt, time.perf_counter() - t0)
            return env
        return _exact_bounds(self.planner.execute(plan, explain=explain))

    def explain(self, type_name: str, f: "Filter | str" = INCLUDE) -> str:
        """Render the query plan trace without running the scan."""
        exp = Explainer()
        plan = self.planner.plan(type_name, f, explain=exp)
        exp(f"Plan: strategy={plan.strategy}")
        if plan.config is not None and not plan.config.disjoint:
            exp(f"Ranges: {plan.config.n_ranges}")
        return exp.render()


def _sketch_index(indexes) -> str:
    """Which index's keys feed the z sketch: z3 when present, else z2 (one
    sketch per store; its key space must match the ranges estimated
    against it, StatsStore.z_index)."""
    names = {i.name for i in indexes}
    return "z3" if "z3" in names else "z2"


def _observe_sketch(stats, idx, keys) -> None:
    """Feed one index's write keys into the z sketch; the cell width is
    codec-defined (dims x per-dim precision), so cells align across
    batches. Shared by the write path and the full re-sketch."""
    dims = 3 if idx.name == "z3" else 2
    stats.observe_index_keys(
        idx.name, keys.bins, keys.zs, dims * getattr(idx.sfc, "precision", 21),
    )


def _exact_bounds(fc: FeatureCollection) -> Optional[tuple]:
    """Exact envelope of a result batch's geometries (bboxes for extents)."""
    if len(fc) == 0:
        return None
    col = fc.geom_column
    if isinstance(col, PointColumn):
        return (
            float(col.x.min()), float(col.y.min()),
            float(col.x.max()), float(col.y.max()),
        )
    b = col.bboxes.astype(np.float64)
    return (
        float(b[:, 0].min()), float(b[:, 1].min()),
        float(b[:, 2].max()), float(b[:, 3].max()),
    )


def _host_density(fc: FeatureCollection, envelope, width: int, height: int,
                  weight: str | None) -> np.ndarray:
    """numpy scatter-add density over refined results (filters the device
    mask cannot decide, or weighted grids)."""
    x0, y0, x1, y1 = (float(v) for v in envelope)
    grid = np.zeros(height * width, dtype=np.float32)
    if len(fc) == 0:
        return grid.reshape(height, width)
    x, y = fc.representative_xy()
    w = (
        np.asarray(fc.columns[weight], dtype=np.float32)
        if weight
        else np.ones(len(fc), dtype=np.float32)
    )
    m = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
    px = np.clip(((x - x0) / (x1 - x0) * width).astype(np.int64), 0, width - 1)
    py = np.clip(((y - y0) / (y1 - y0) * height).astype(np.int64), 0, height - 1)
    np.add.at(grid, (py * width + px)[m], w[m])
    return grid.reshape(height, width)
