"""Columnar feature collections: the host-side batch representation.

The port's copy of geomesa_tpu/features.py: a FeatureCollection is a
struct-of-arrays batch (ids, one array per scalar attribute, the geometry
as a PointColumn for point schemas or a PackedGeometryColumn for
extents). It is both the ingest format and the query result format, and
the ``batch`` mapping the filter predicates evaluate over. The query
hints' post-processing stages (``sample``, ``sort_values``, ``transform``,
``project``) are methods here, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch import native
from geomesa_tpu_torch.filter.predicates import PointColumn
from geomesa_tpu_torch.sft import COLUMN_DTYPES, FeatureType


def _date_to_millis(v) -> int:
    """Accept int epoch-millis, numpy datetime64, or ISO-8601 string."""
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, np.datetime64):
        return int(v.astype("datetime64[ms]").astype(np.int64))
    if isinstance(v, str):
        return int(np.datetime64(v.rstrip("Z"), "ms").astype(np.int64))
    raise TypeError(f"cannot convert {type(v)} to epoch millis")


@dataclass
class FeatureCollection:
    """A batch of features for one FeatureType, stored column-wise.

    - ``ids``: numpy array of feature ids
    - ``columns``: attribute name -> numpy array (Date attrs = int64 millis,
      strings = unicode arrays); the geometry attribute maps to a
      PointColumn (point schemas) or a PackedGeometryColumn (extents)
    """

    sft: FeatureType
    ids: np.ndarray
    columns: dict

    def __post_init__(self):
        n = len(self.ids)
        for name, col in self.columns.items():
            if len(col) != n:
                raise ValueError(
                    f"column {name!r} has {len(col)} rows, expected {n}"
                )

    def __len__(self) -> int:
        return len(self.ids)

    @property
    def batch(self) -> Mapping[str, object]:
        """The mapping the filter predicates evaluate over."""
        return {**self.columns, "__id__": self.ids}

    @property
    def geom_column(self):
        g = self.sft.geom_field
        return self.columns[g] if g else None

    def representative_xy(self) -> tuple[np.ndarray, np.ndarray]:
        """(x, y) representative coordinate per feature: the point itself,
        or the bbox midpoint for extent geometries (the representative the
        device aggregation kernels use, there in f32)."""
        col = self.geom_column
        if isinstance(col, PointColumn):
            return col.x, col.y
        b = col.bboxes.astype(np.float64)
        return (b[:, 0] + b[:, 2]) * 0.5, (b[:, 1] + b[:, 3]) * 0.5

    def geometries(self) -> list[geo.Geometry]:
        col = self.geom_column
        if col is None:
            return []
        if isinstance(col, PointColumn):
            return [geo.Point(float(x), float(y)) for x, y in zip(col.x, col.y)]
        return col.geometries()

    def take(self, idx) -> "FeatureCollection":
        idx = np.asarray(idx)
        # the threaded native gather (native.take) for u32-indexable
        # numeric columns; other columns, and negative or out-of-range
        # indices (numpy raises; the C++ gather is unchecked), take numpy
        idx_u32 = None
        if idx.dtype.kind in "iu" and len(idx) and len(self.ids) < (1 << 32):
            if int(idx.min()) >= 0 and int(idx.max()) < len(self.ids):
                idx_u32 = idx.astype(np.uint32, copy=False)

        def g(col):
            if idx_u32 is not None:
                out = native.take(np.asarray(col), idx_u32)
                if out is not None:
                    return out
            return np.asarray(col)[idx]

        cols = {}
        for name, col in self.columns.items():
            if isinstance(col, PointColumn):
                cols[name] = PointColumn(g(col.x), g(col.y))
            elif isinstance(col, geo.PackedGeometryColumn):
                cols[name] = col.take(idx)
            else:
                cols[name] = g(col)
        return FeatureCollection(self.sft, g(self.ids), cols)

    def mask(self, m: np.ndarray) -> "FeatureCollection":
        return self.take(np.nonzero(np.asarray(m))[0])

    def transform(self, specs: Sequence[str]) -> "FeatureCollection":
        """Query transforms (reference QueryPlanner.scala:189-312
        configureQuery transform handling): each spec is either a plain
        attribute name (column selection, ``project``) or ``name=expr``
        where ``expr`` is a converter-DSL expression (io.converters) —
        renames (``b=a``), casts (``b=a::int``), ST_ functions
        (``lon=st_x(geom)``), string ops, concat. Vectorized fast paths
        cover renames and st_x/st_y over point columns; other expressions
        evaluate per row over {attribute: value} dicts."""
        if all("=" not in s for s in specs):
            return self.project(specs)
        from dataclasses import replace

        from geomesa_tpu_torch.io.converters import compile_expression
        from geomesa_tpu_torch.sft import AttributeDescriptor

        import re as _re

        n = len(self)
        cols: dict = {}
        attrs: list[AttributeDescriptor] = []
        # only the columns the expressions actually reference materialize
        # into row dicts — decoding every packed geometry for a scalar
        # rename would put O(n x n_attrs) Python-object churn on the
        # query hot path
        referenced: set[str] = set()
        for s in specs:
            if "=" in s:
                referenced |= set(_re.findall(r"\w+", s.split("=", 1)[1]))
        referenced &= set(self.columns)
        rows_cache: list[dict] | None = None

        def rows() -> list[dict]:
            # row dicts for the expression evaluator, built at most once;
            # geometry attributes materialize as Geometry objects so ST_
            # functions apply directly
            nonlocal rows_cache
            if rows_cache is None:
                base: dict[str, list] = {}
                for aname in referenced:
                    col = self.columns[aname]
                    if isinstance(col, PointColumn):
                        base[aname] = [
                            geo.Point(float(x), float(y))
                            for x, y in zip(col.x, col.y)
                        ]
                    elif isinstance(col, geo.PackedGeometryColumn):
                        base[aname] = col.geometries()
                    else:
                        base[aname] = np.asarray(col).tolist()
                rows_cache = [
                    {k: v[i] for k, v in base.items()} for i in range(n)
                ]
            return rows_cache

        geom_seen = False  # True once a DEFAULT geometry attr is emitted
        for spec in specs:
            if "=" not in spec:
                src = self.sft.attr(spec)  # raises KeyError on unknown
                cols[spec] = self.columns[spec]
                a = replace(src, default=src.default and not geom_seen)
                attrs.append(a)
                geom_seen |= a.default and a.is_geometry
                continue
            name, expr_text = (s.strip() for s in spec.split("=", 1))
            if self.sft.has(expr_text):  # pure rename: share the column
                src = self.sft.attr(expr_text)
                cols[name] = self.columns[expr_text]
                a = replace(src, name=name, default=src.default and not geom_seen)
                attrs.append(a)
                geom_seen |= a.default and a.is_geometry
                continue
            gf = self.sft.geom_field
            col = self.geom_column
            if (
                gf is not None
                and isinstance(col, PointColumn)
                and expr_text in (f"st_x({gf})", f"st_y({gf})")
            ):
                v = col.x if expr_text.startswith("st_x") else col.y
                cols[name] = np.asarray(v, np.float64)
                attrs.append(AttributeDescriptor(name, "Double"))
                continue
            expr = compile_expression(expr_text)
            vals = [expr(r) for r in rows()]
            first = next((v for v in vals if v is not None), None)
            if isinstance(first, geo.Point) and all(
                isinstance(v, geo.Point) for v in vals
            ):
                cols[name] = PointColumn(
                    np.array([p.x for p in vals], np.float64),
                    np.array([p.y for p in vals], np.float64),
                )
                attrs.append(
                    AttributeDescriptor(name, "Point", default=not geom_seen)
                )
                geom_seen = True
            elif isinstance(first, geo.Geometry):
                cols[name] = geo.PackedGeometryColumn.from_geometries(vals)
                attrs.append(
                    AttributeDescriptor(
                        name, first.geom_type, default=not geom_seen
                    )
                )
                geom_seen = True
            elif isinstance(first, bool):
                cols[name] = np.array([bool(v) for v in vals])
                attrs.append(AttributeDescriptor(name, "Boolean"))
            elif isinstance(first, (int, np.integer)) and not any(
                v is None or isinstance(v, (float, np.floating)) for v in vals
            ):
                # pure-int results only: a None anywhere promotes to float
                # so nulls stay NaN (the store's null) instead of becoming
                # fabricated zeros; mixed int/float promotes too
                cols[name] = np.array([int(v) for v in vals], np.int64)
                attrs.append(AttributeDescriptor(name, "Long"))
            elif isinstance(first, (int, float, np.integer, np.floating)):
                cols[name] = np.array(
                    [np.nan if v is None else float(v) for v in vals],
                    np.float64,
                )
                attrs.append(AttributeDescriptor(name, "Double"))
            else:
                cols[name] = np.array(
                    ["" if v is None else str(v) for v in vals]
                )
                attrs.append(AttributeDescriptor(name, "String"))
        sub = FeatureType(self.sft.name, attrs, dict(self.sft.user_data))
        return FeatureCollection(sub, self.ids, cols)

    def project(self, names: Sequence[str]) -> "FeatureCollection":
        """Column projection (reference query transforms): keep only the
        named attributes. Ids are always kept; the projected SFT preserves
        attribute order and flags."""
        keep = [a for a in self.sft.attributes if a.name in set(names)]
        missing = set(names) - {a.name for a in keep}
        if missing:
            raise KeyError(f"unknown transform attributes: {sorted(missing)}")
        sub = FeatureType(self.sft.name, keep, dict(self.sft.user_data))
        return FeatureCollection(
            sub, self.ids, {a.name: self.columns[a.name] for a in keep}
        )

    def sort_values(self, by: str) -> "FeatureCollection":
        """Stable sort by one attribute; ``-attr`` sorts descending
        (reference SORT_FIELDS hint)."""
        desc = by.startswith("-")
        name = by[1:] if desc else by
        col = self.ids if name == "__id__" else self.columns[name]
        if isinstance(col, PointColumn):
            col = col.x
        col = np.asarray(col)
        if desc:
            # stable descending: ties keep original order (reversing an
            # ascending stable sort would reverse ties too)
            ranks = np.unique(col, return_inverse=True)[1]
            order = np.argsort(-ranks, kind="stable")
        else:
            order = np.argsort(col, kind="stable")
        return self.take(order)

    def sample(self, fraction: float, by: str | None = None) -> "FeatureCollection":
        """Deterministic stride sampling keeping ~fraction of rows
        (reference SamplingIterator: modular per-record sampling,
        optionally stratified per ``by`` value so every group survives)."""
        n = len(self)
        if n == 0 or fraction >= 1.0:
            return self
        step = max(1, int(round(1.0 / fraction)))
        if by is None:
            return self.take(np.arange(0, n, step))
        vals = np.asarray(self.columns[by])
        keep = np.zeros(n, dtype=bool)
        for v in np.unique(vals):
            idx = np.nonzero(vals == v)[0]
            keep[idx[::step]] = True
        return self.mask(keep)

    def to_rows(self) -> list[dict]:
        """Expand to per-feature dicts (export / debugging)."""
        geoms = {self.sft.geom_field: self.geometries()} if self.sft.geom_field else {}
        rows = []
        for i in range(len(self)):
            row = {"__id__": str(self.ids[i])}
            for name, col in self.columns.items():
                if name in geoms:
                    row[name] = geoms[name][i]
                else:
                    row[name] = col[i].item() if hasattr(col[i], "item") else col[i]
            rows.append(row)
        return rows

    @staticmethod
    def from_rows(sft: FeatureType, rows: Sequence[Mapping], ids: Sequence[str] | None = None) -> "FeatureCollection":
        """Build from per-feature dicts: {attr: value, ...}.

        Geometry values may be Geometry objects or WKT strings; dates may be
        epoch millis, datetime64, or ISO strings. Missing ids are generated.
        """
        n = len(rows)
        if ids is None:
            ids = [str(r.get("__id__", i)) for i, r in enumerate(rows)]
        cols: dict = {}
        for attr in sft.attributes:
            vals = [r.get(attr.name) for r in rows]
            if attr.is_geometry:
                geoms = [
                    geo.from_wkt(v) if isinstance(v, str) else v for v in vals
                ]
                if sft.is_points and attr.name == sft.geom_field:
                    xs = np.array([g.x for g in geoms], dtype=np.float64)
                    ys = np.array([g.y for g in geoms], dtype=np.float64)
                    cols[attr.name] = PointColumn(xs, ys)
                else:
                    cols[attr.name] = geo.PackedGeometryColumn.from_geometries(geoms)
            elif attr.type == "Date":
                cols[attr.name] = np.array(
                    [_date_to_millis(v) for v in vals], dtype=np.int64
                )
            elif attr.type in COLUMN_DTYPES:
                cols[attr.name] = np.array(vals, dtype=COLUMN_DTYPES[attr.type])
            elif attr.type == "Bytes":
                # object column: str() would corrupt binary payloads
                b = np.empty(n, dtype=object)
                b[:] = [None if v is None else bytes(v) for v in vals]
                cols[attr.name] = b
            else:  # String / UUID -> unicode
                cols[attr.name] = np.array(
                    ["" if v is None else str(v) for v in vals]
                )
        return FeatureCollection(sft, np.array([str(i) for i in ids]), cols)

    @staticmethod
    def from_columns(
        sft: FeatureType,
        ids: Sequence[str],
        columns: Mapping[str, object],
    ) -> "FeatureCollection":
        """Build from pre-columnar data; the geometry column may be an
        (x, y) tuple of arrays, a PointColumn, a PackedGeometryColumn, or a
        list of Geometry objects."""
        cols: dict = {}
        for attr in sft.attributes:
            col = columns[attr.name]
            if attr.is_geometry:
                if isinstance(col, (PointColumn, geo.PackedGeometryColumn)):
                    cols[attr.name] = col
                elif isinstance(col, tuple):
                    cols[attr.name] = PointColumn(
                        np.asarray(col[0], dtype=np.float64),
                        np.asarray(col[1], dtype=np.float64),
                    )
                else:
                    cols[attr.name] = geo.PackedGeometryColumn.from_geometries(col)
            elif attr.type == "Date":
                c = np.asarray(col)
                if c.dtype.kind == "M":
                    c = c.astype("datetime64[ms]").astype(np.int64)
                cols[attr.name] = c.astype(np.int64)
            elif attr.type in COLUMN_DTYPES:
                cols[attr.name] = np.asarray(col, dtype=COLUMN_DTYPES[attr.type])
            else:
                cols[attr.name] = np.asarray(col)
        return FeatureCollection(sft, np.asarray(ids), cols)

    @staticmethod
    def concat(parts: Sequence["FeatureCollection"]) -> "FeatureCollection":
        parts = [p for p in parts if len(p)]
        if not parts:
            raise ValueError("nothing to concat")
        sft = parts[0].sft
        ids = np.concatenate([p.ids for p in parts])
        cols: dict = {}
        for name in parts[0].columns:
            vals = [p.columns[name] for p in parts]
            if isinstance(vals[0], PointColumn):
                cols[name] = PointColumn(
                    np.concatenate([v.x for v in vals]),
                    np.concatenate([v.y for v in vals]),
                )
            elif isinstance(vals[0], geo.PackedGeometryColumn):
                cols[name] = geo.PackedGeometryColumn.concat(vals)
            else:
                cols[name] = np.concatenate(vals)
        return FeatureCollection(sft, ids, cols)
