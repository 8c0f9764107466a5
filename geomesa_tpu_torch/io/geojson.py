"""GeoJSON FeatureCollection reader — the ingest direction of the
GeoJSON exporter (io/exporters._geojson).

Reference: the JSON converter (geomesa-convert-json) covers arbitrary
JSON via JSONPath configs; RFC 7946 GeoJSON is self-describing, so this
reader needs no config: the schema is inferred from the properties of
the features (Int/Double/String, ISO-8601 strings become Dates) and the
geometry type, mirroring TypeInference for the delimited converter.
"""

from __future__ import annotations

import json
import re

import numpy as np

from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.sft import FeatureType

_ISO = re.compile(r"^\d{4}-\d{2}-\d{2}[T ]\d{2}:\d{2}(:\d{2}(\.\d+)?)?Z?$")


def _infer_attr_type(values: list) -> str:
    """Schema type for one property across all features (None skipped)."""
    vals = [v for v in values if v is not None]
    if not vals:
        return "String"
    if all(isinstance(v, bool) for v in vals):
        return "Boolean"
    if all(isinstance(v, int) and not isinstance(v, bool) for v in vals):
        return "Long" if any(abs(v) > (1 << 31) - 1 for v in vals) else "Int"
    if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in vals):
        return "Double"
    if all(isinstance(v, str) and _ISO.match(v) for v in vals):
        return "Date"
    return "String"


def read_geojson(
    source,
    type_name: str = "features",
    sft: "FeatureType | None" = None,
    id_offset: int = 0,
) -> FeatureCollection:
    """Decode a GeoJSON FeatureCollection (text, path, file-like, or an
    already-parsed dict). With ``sft`` None the schema is inferred and
    the geometry attribute is named ``geom``; with an explicit ``sft``
    the geometry key follows its schema. Features without an explicit
    ``id`` get running indices starting at ``id_offset`` (so repeat
    ingests can rebase on the store size)."""
    if isinstance(source, dict):
        obj = source
    elif isinstance(source, (str, bytes)) and not source.lstrip().startswith(
        "{" if isinstance(source, str) else b"{"
    ):
        with open(source) as f:
            obj = json.load(f)
    elif hasattr(source, "read"):
        obj = json.load(source)
    else:
        obj = json.loads(source)
    if obj.get("type") != "FeatureCollection":
        raise ValueError(f"not a GeoJSON FeatureCollection: {obj.get('type')!r}")
    feats = obj.get("features", [])

    from geomesa_tpu_torch.sql.functions import _geom_from_geojson

    geoms = [
        _geom_from_geojson(f["geometry"]) if f.get("geometry") is not None else None
        for f in feats
    ]
    if any(g is None for g in geoms):
        raise ValueError("features without geometry are not supported")

    geom_name = sft.geom_field if sft is not None else "geom"
    prop_names: list[str] = []
    for f in feats:
        for k in (f.get("properties") or {}):
            if k not in prop_names and k != geom_name:
                prop_names.append(k)
    columns = {
        k: [(f.get("properties") or {}).get(k) for f in feats] for k in prop_names
    }

    if sft is None:
        all_points = all(isinstance(g, geo.Point) for g in geoms)
        gtype = "Point" if all_points else (
            geoms[0].geom_type if len({g.geom_type for g in geoms}) == 1
            else "Geometry"
        )
        parts = [f"{k}:{_infer_attr_type(v)}" for k, v in columns.items()]
        parts.append(f"*{geom_name}:{gtype}:srid=4326")
        sft = FeatureType.from_spec(type_name, ",".join(parts))

    # synthesized ids must not collide with explicit ids in the same batch
    # (a file mixing id-less features with explicit numeric ids): number
    # only the id-less features with a separate counter, skipping values
    # already taken by an explicit id
    explicit = {str(f["id"]) for f in feats if f.get("id") is not None}
    ids: list[str] = []
    next_id = id_offset
    for f in feats:
        if f.get("id") is not None:
            ids.append(str(f["id"]))
        else:
            while str(next_id) in explicit:
                next_id += 1
            ids.append(str(next_id))
            next_id += 1
    rows = []
    for i, f in enumerate(feats):
        row = dict(f.get("properties") or {})
        row[geom_name] = geoms[i]
        rows.append(row)
    return FeatureCollection.from_rows(sft, rows, ids=ids)
