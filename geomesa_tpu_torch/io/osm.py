"""OpenStreetMap XML converter (reference geomesa-convert-osm module;
implemented from the public OSM XML format: <node id lat lon> with
<tag k v/> children, <way id> with <nd ref/> + tags).

- ``kind="nodes"``: every tagged (or all) node becomes a Point feature;
- ``kind="ways"``: ways resolve their node refs into LineStrings, or
  Polygons when the ring closes and the way carries an area-ish tag
  (building/landuse/area=yes — the conventional OSM area heuristic).

Selected tag keys become string attributes (missing tags are empty).
"""

from __future__ import annotations

import io as _io
import xml.etree.ElementTree as ET
from typing import Sequence

import numpy as np

from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.sft import FeatureType

DEFAULT_TAGS = ("name", "highway", "building", "amenity", "landuse")
_AREA_KEYS = {"building", "landuse", "leisure", "natural", "amenity"}


def _root(src) -> ET.Element:
    if isinstance(src, bytes):
        return ET.fromstring(src.decode("utf-8"))
    if isinstance(src, str):
        if src.lstrip().startswith("<"):
            return ET.fromstring(src)
        with open(src, "rb") as fh:
            return ET.parse(fh).getroot()
    return ET.parse(src).getroot()


def _tags(el) -> dict:
    return {t.get("k"): t.get("v") for t in el.findall("tag")}


def read_osm(
    src,
    kind: str = "nodes",
    type_name: str = "osm",
    tags: Sequence[str] = DEFAULT_TAGS,
    tagged_only: bool = True,
) -> FeatureCollection:
    """Parse OSM XML into a FeatureCollection of nodes or ways.

    ``tagged_only`` (nodes): skip bare geometry-carrier nodes (the
    overwhelming majority in real extracts — they only exist to shape
    ways), matching the reference converter's default.
    """
    if kind not in ("nodes", "ways"):
        raise ValueError(f"kind must be nodes|ways, got {kind!r}")
    root = _root(src)

    if kind == "nodes":
        ids, lon, lat, cols = [], [], [], {k: [] for k in tags}
        for n in root.findall("node"):
            t = _tags(n)
            if tagged_only and not t:
                continue
            ids.append(str(n.get("id")))
            lon.append(float(n.get("lon")))
            lat.append(float(n.get("lat")))
            for k in tags:
                cols[k].append(t.get(k, ""))
        sft = FeatureType.from_spec(
            type_name,
            ",".join(f"{k}:String" for k in tags) + ",*geom:Point:srid=4326",
        )
        return FeatureCollection.from_columns(
            sft, np.array(ids),
            {**{k: np.array(v if v else [], dtype=object) for k, v in cols.items()},
             "geom": (np.array(lon, np.float64), np.array(lat, np.float64))},
        )

    # ways: resolve node refs (ALL nodes this time — carriers included)
    coords = {
        str(n.get("id")): (float(n.get("lon")), float(n.get("lat")))
        for n in root.findall("node")
    }
    ids, geoms, cols = [], [], {k: [] for k in tags}
    for w in root.findall("way"):
        refs = [str(nd.get("ref")) for nd in w.findall("nd")]
        pts = [coords[r] for r in refs if r in coords]
        if len(pts) < 2:
            continue
        t = _tags(w)
        closed = len(pts) >= 4 and pts[0] == pts[-1]
        is_area = closed and (
            t.get("area") == "yes" or any(k in t for k in _AREA_KEYS)
        )
        g = geo.Polygon(pts[:-1]) if is_area else geo.LineString(pts)
        ids.append(str(w.get("id")))
        geoms.append(g)
        for k in tags:
            cols[k].append(t.get(k, ""))
    sft = FeatureType.from_spec(
        type_name,
        ",".join(f"{k}:String" for k in tags) + ",*geom:Geometry:srid=4326",
    )
    return FeatureCollection.from_columns(
        sft, np.array(ids),
        {**{k: np.array(v if v else [], dtype=object) for k, v in cols.items()},
         "geom": geo.PackedGeometryColumn.from_geometries(geoms)},
    )
