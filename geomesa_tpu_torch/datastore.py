"""DataStore: schema lifecycle, ingest, and the query entry points.

The port of geomesa_tpu/datastore.py's main path (reference
GeoMesaDataStore): create_schema -> write -> query / query_many / count /
density / density_many / bounds / stats_query / explain, and serve() for
concurrent callers. Point schemas get a Z3 index (when a time attribute
exists) and a Z2 index; extent schemas (polygons, lines, multi-geometries)
an XZ3 and an XZ2 index; both narrowed by the ``geomesa.indices.enabled``
user data. Each index is a sorted IndexTable whose predicate columns live
on the store's device.

The device is explicit: ``DataStore(device="cuda")`` (the default) raises
when no CUDA device is present; tests pass ``device="cpu"``, where every
kernel wrapper takes its plain PyTorch version. The first write builds
each index table; later writes stay in a host delta tier (storage.delta)
until it outgrows ``geomesa.tpu.compact.min.rows`` and an eighth of the
rows, when ``compact`` rebuilds the tables from all rows.
"""

from __future__ import annotations

import threading
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from geomesa_tpu_torch import conf
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.predicates import INCLUDE, Filter, Include, PointColumn
from geomesa_tpu_torch.index import XZ2Index, XZ3Index, Z2Index, Z3Index
from geomesa_tpu_torch.index.api import WriteKeys
from geomesa_tpu_torch.planning.explain import Explainer
from geomesa_tpu_torch.planning.planner import QueryPlanner, mask_decides_filter
from geomesa_tpu_torch.sft import FeatureType
from geomesa_tpu_torch.storage.delta import TieredTable, concat_keys
from geomesa_tpu_torch.storage.table import IndexTable, merged_perm
from geomesa_tpu_torch.timing import NULL_CLOCK


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

    def __init__(self, device="cuda", tile: int | None = None):
        self.device = resolve_device(device)
        self.tile = tile
        self._schemas: dict[str, FeatureType] = {}
        self._chunks: dict[str, list[FeatureCollection]] = {}
        self._full: dict[str, FeatureCollection | None] = {}
        self._indexes: dict[str, list] = {}
        self._tables: dict[tuple[str, str], IndexTable] = {}
        # per-index write keys, one part per write; rows past _main_rows
        # are the delta tier
        self._key_chunks: dict[tuple[str, str], list[WriteKeys]] = {}
        self._main_rows: dict[str, int] = {}
        self.planner = QueryPlanner(self)
        # per-phase timing of the scan path (timing.PhaseClock), or the
        # clock that records nothing
        self.clock = NULL_CLOCK
        # the serving tier (serve()); the lock keeps concurrent first
        # callers from starting two schedulers
        self.scheduler = None
        self._serve_lock = threading.Lock()

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
        return sft

    @staticmethod
    def _choose_indexes(sft: FeatureType) -> list:
        indexes: list = []
        if sft.is_points:
            if sft.dtg_field is not None:
                indexes.append(Z3Index(sft))
            indexes.append(Z2Index(sft))
        else:
            if sft.dtg_field is not None:
                indexes.append(XZ3Index(sft))
            indexes.append(XZ2Index(sft))
        # reference `geomesa.indices.enabled` user-data hint
        enabled = sft.user_data.get("geomesa.indices.enabled")
        if enabled:
            names = {s.strip() for s in str(enabled).split(",")}
            indexes = [i for i in indexes if i.name in names]
            if not indexes:
                raise ValueError(f"no supported index in {enabled!r}")
        return indexes

    def get_schema(self, type_name: str) -> FeatureType:
        return self._schemas[type_name]

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
        sft = self._schemas[type_name]
        if not isinstance(features, FeatureCollection):
            features = FeatureCollection.from_rows(sft, features)
        if len(features) == 0:
            return 0
        # encode every index's keys before any state mutates: a failing
        # encoder leaves the store untouched
        new_keys = {idx.name: idx.write_keys(features) for idx in self._indexes[type_name]}
        if check_ids:
            self._check_ids(type_name, np.asarray(features.ids))
        self._widen_bin_ranges(type_name, new_keys)
        self._chunks[type_name].append(features)
        self._full[type_name] = None
        for name, keys in new_keys.items():
            self._key_chunks.setdefault((type_name, name), []).append(keys)
        total = self.row_count(type_name)
        main_rows = self._main_rows[type_name]
        if main_rows == 0 or total - main_rows > max(conf.COMPACT_MIN_ROWS.get(), total // 8):
            self.compact(type_name)
        return len(features)

    def compact(self, type_name: str) -> None:
        """Merge the delta tier into the device tables: concatenate the
        key and feature chunks and rebuild each index table from all rows,
        the delta's rows sorted into the old table's (bin, z) order ahead
        of old rows with an equal key, as the JAX package's merge places
        them (storage.table.merged_perm). Also collapses the feature
        chunks into one collection."""
        full = self.features(type_name)
        self._chunks[type_name] = [full] if len(full) else []
        main_rows = self._main_rows[type_name]
        for idx in self._indexes[type_name]:
            key = (type_name, idx.name)
            parts = self._key_chunks.get(key)
            if not parts:
                continue
            keys = concat_keys(parts)
            self._key_chunks[key] = [keys]
            old = self._tables.get(key)
            if old is not None and old.n == len(keys.zs) == main_rows:
                continue  # empty delta: the table is current
            perm = None
            if old is not None and old.n == main_rows < len(keys.zs):
                perm = merged_perm(old.perm, keys, main_rows)
            # release the old device columns before the rebuild uploads
            self._tables.pop(key, None)
            self._tables[key] = IndexTable(
                idx, keys, tile=self.tile, device=self.device, perm=perm
            )
        self._main_rows[type_name] = len(full)

    def _check_ids(self, type_name: str, ids: np.ndarray) -> None:
        if len(np.unique(ids)) != len(ids):
            raise ValueError("duplicate feature ids in write batch")
        for chunk in self._chunks[type_name]:
            stored = np.asarray(chunk.ids)
            probe = ids.astype(str) if stored.dtype.kind in "US" else ids
            if np.isin(probe, stored).any():
                raise ValueError("duplicate feature ids in write batch")

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
        main_rows = self._main_rows[type_name]
        if self.row_count(type_name) == main_rows:
            return table
        # a compaction leaves one key part of exactly main_rows rows and
        # each later write appends one part, so the delta is whole parts
        delta, seen = [], 0
        for p in self._key_chunks[(type_name, index_name)]:
            if seen >= main_rows:
                delta.append(p)
            seen += len(p.zs)
        return TieredTable(table, concat_keys(delta), main_rows)

    def features(self, type_name: str) -> FeatureCollection:
        chunks = self._chunks.get(type_name, [])
        if not chunks:
            return FeatureCollection.from_rows(self._schemas[type_name], [])
        if len(chunks) == 1:
            return chunks[0]
        full = self._full.get(type_name)
        if full is None:
            full = FeatureCollection.concat(chunks)
            self._full[type_name] = full
        return full

    def row_count(self, type_name: str) -> int:
        return sum(len(c) for c in self._chunks.get(type_name, []))

    def gather(self, type_name: str, ordinals: np.ndarray) -> FeatureCollection:
        """Features at the given ordinals, in ``ordinals`` order."""
        return self.features(type_name).take(ordinals)

    # -- queries ---------------------------------------------------------
    def query(
        self,
        type_name: str,
        f: "Filter | str" = INCLUDE,
        limit: Optional[int] = None,
        explain: Explainer | None = None,
    ) -> FeatureCollection:
        """Run a query; returns the matching features as a collection."""
        plan = self.planner.plan(type_name, f, limit=limit, explain=explain)
        return self.planner.execute(plan, explain=explain)

    def query_many(
        self,
        type_name: str,
        filters: "Sequence[Filter | str]",
        limit: Optional[int] = None,
    ) -> list[FeatureCollection]:
        """Run several queries with every device scan launched before any
        result is pulled; index scans on one table fuse into one kernel
        launch per chunk. Per-query results equal sequential ``query``."""
        plans = [self.planner.plan(type_name, f, limit=limit) for f in filters]
        return self.planner.execute_many(plans)

    def serve(self, config=None):
        """Attach (or return) the micro-batch serving tier: concurrent
        callers ``submit()`` through the returned, started QueryScheduler,
        and compatible index scans coalesce into fused launches.
        ``config``: None builds a ServingConfig from the conf.py knobs; a
        ServingConfig is used as given. Returns the attached scheduler
        while it is open; a closed one is replaced. Thread-safe."""
        from geomesa_tpu_torch.serving import QueryScheduler

        with self._serve_lock:
            sched = self.scheduler
            if sched is not None and not sched.closed:
                return sched
            self.scheduler = QueryScheduler(self, config).start()
            return self.scheduler

    def count(self, type_name: str, f: "Filter | str" = INCLUDE) -> int:
        """Exact hit count (scan + refine; a polygon filter with a raster
        counts its certain rows without gathering them)."""
        if isinstance(f, Include):
            return self.row_count(type_name)
        plan = self.planner.plan(type_name, f)
        if self._raster_agg_eligible(type_name, plan):
            return self._raster_agg_scan(type_name, plan)[0]
        return len(self.planner.execute(plan))

    def _device_aggregable(self, type_name: str, plan) -> bool:
        """Whether the gather-free aggregation kernels decide this plan's
        filter (never for a polygon config: they test the box only)."""
        return plan.index is not None and mask_decides_filter(
            plan.filter, plan.config, self._schemas[type_name], for_aggregation=True
        )

    # -- raster aggregation push-down ------------------------------------
    def _raster_agg_eligible(self, type_name: str, plan) -> bool:
        """Whether a plan may take the raster aggregation path: a polygon
        config carrying a raster stack whose row-scan mask decides the
        filter. Such configs stay off the gather-free aggregations (their
        kernels test the box only), but count, bounds and Count() stats
        can still skip the full candidate gather: full raster cells decide
        membership outright and only the boundary residue refines."""
        cfg = plan.config
        return (
            plan.index is not None
            and cfg is not None
            and not cfg.disjoint
            and cfg.rast is not None
            and mask_decides_filter(plan.filter, cfg, self._schemas[type_name])
        )

    def _raster_agg_scan(self, type_name: str, plan, explain=None):
        """(hit count, hit ordinals) of a raster-eligible plan: the scan's
        certain rows (full cells, contained ranges) are accepted without a
        gather; only the uncertain residue gathers and refines in f64."""
        ordinals, certain = self.table(type_name, plan.index).scan_submit(
            plan.config, clock=self.clock
        )()
        cert_ords = ordinals[certain]
        unc = ordinals[~certain]
        if len(unc):
            with self.clock.host("refine"):
                m = plan.filter.evaluate(self.gather(type_name, unc).batch)
            hits = np.concatenate([cert_ords, unc[m]])
        else:
            hits = cert_ords
        if explain is not None:
            explain(
                f"raster aggregation push-down: {len(cert_ords)} certain "
                f"(full cells / contained ranges), {len(unc)} residue rows "
                "re-checked exactly"
            )
        return len(hits), hits

    def _raster_agg_bounds(self, type_name: str, plan, explain=None):
        """(count, exact envelope | None) through the raster scan: the hit
        coordinates come straight from the point column, no row gather."""
        n, hits = self._raster_agg_scan(type_name, plan, explain=explain)
        if n == 0:
            return 0, None
        col = self.features(type_name).geom_column
        x, y = col.x[hits], col.y[hits]
        return n, (float(x.min()), float(y.min()), float(x.max()), float(y.max()))

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
            if weight is not None or not self._device_aggregable(type_name, plan):
                staged.append(("host", (plan, envelope)))
            elif plan.config.disjoint:
                staged.append(("empty", None))
            else:
                staged.append(("device", self.table(type_name, plan.index).density_submit(
                    plan.config, envelope, width, height, clock=self.clock
                )))
        out: list = []
        for kind, payload in staged:
            if kind == "empty":
                out.append(np.zeros((height, width), dtype=np.float32))
            elif kind == "device":
                out.append(payload())
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
        a raster takes the raster push-down, exact, either way."""
        from geomesa_tpu_torch.stats import stat_spec
        from geomesa_tpu_torch.stats.sketches import CountStat

        terms = stat_spec.parse(spec)
        plan = self.planner.plan(type_name, f, explain=explain)
        if all(t.kind == "count" for t in terms) and self._raster_agg_eligible(
            type_name, plan
        ):
            n = self._raster_agg_scan(type_name, plan, explain=explain)[0]
            out = []
            for _ in terms:
                c = CountStat()
                c.count = n
                out.append(c)
            return out
        if (
            estimate
            and all(t.kind == "count" for t in terms)
            and self._device_aggregable(type_name, plan)
        ):
            n = (
                0 if plan.config.disjoint
                else self.table(type_name, plan.index).count(plan.config, clock=self.clock)
            )
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
        push-down, either way."""
        plan = self.planner.plan(type_name, f, explain=explain)
        if not isinstance(plan.filter, Include) and self._raster_agg_eligible(type_name, plan):
            return self._raster_agg_bounds(type_name, plan, explain=explain)[1]
        if (
            estimate
            and not isinstance(plan.filter, Include)
            and self._device_aggregable(type_name, plan)
        ):
            if plan.config.disjoint:
                return None
            _, env = self.table(type_name, plan.index).bounds_stats(
                plan.config, clock=self.clock
            )
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
