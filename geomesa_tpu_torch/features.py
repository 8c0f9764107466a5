"""Columnar feature collections: the host-side batch representation.

The port's copy of geomesa_tpu/features.py: a FeatureCollection is a
struct-of-arrays batch (ids, one array per scalar attribute, the geometry
as a PointColumn for point schemas or a PackedGeometryColumn for
extents). It is both the ingest format and the query result format, and
the ``batch`` mapping the filter predicates evaluate over.
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
