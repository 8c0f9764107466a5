"""Coordinate reference systems: 4326 <-> 3857 reprojection.

The port's copy of geomesa_tpu/crs.py. The store is EPSG:4326-native end
to end, so CRS support is a boundary concern: a BBOX literal in a
supported foreign CRS reprojects to EPSG:4326 before planning, and the
``reproject`` query hint transforms result geometries after the scan
(reference QueryPlanner.scala:292 reprojection hints). Unsupported CRSs
raise. Supported: EPSG:4326 (and its aliases; axis order lon/lat) and
EPSG:3857 (spherical web mercator, radius 6378137 m).
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch import geometry as geo

_R = 6378137.0  # web-mercator sphere radius (meters)
# latitude bound where mercator y is finite: atan(sinh(pi)) in degrees
MAX_LAT_3857 = 85.05112877980659

_ALIASES_4326 = {
    "EPSG:4326", "4326", "CRS:84", "OGC:CRS84", "CRS84", "WGS84",
    "URN:OGC:DEF:CRS:EPSG::4326", "URN:OGC:DEF:CRS:OGC:1.3:CRS84",
}
_ALIASES_3857 = {
    "EPSG:3857", "3857", "EPSG:900913", "900913",
    "URN:OGC:DEF:CRS:EPSG::3857",
}


def normalize_crs(crs: str) -> str:
    """Canonical "EPSG:4326" / "EPSG:3857"; raises on unsupported CRSs
    (reference behavior: an unknown CRS is an error, never a silent
    identity)."""
    key = str(crs).strip().upper().replace(" ", "")
    if key in _ALIASES_4326:
        return "EPSG:4326"
    if key in _ALIASES_3857:
        return "EPSG:3857"
    raise ValueError(
        f"unsupported CRS {crs!r}: supported are EPSG:4326 (CRS:84) and "
        "EPSG:3857"
    )


def to_4326(x, y, crs: str):
    """Coordinates in ``crs`` -> lon/lat degrees (vectorized)."""
    if normalize_crs(crs) == "EPSG:4326":
        return np.asarray(x, np.float64), np.asarray(y, np.float64)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    lon = np.degrees(x / _R)
    lat = np.degrees(2.0 * np.arctan(np.exp(y / _R)) - np.pi / 2.0)
    return lon, lat


def from_4326(lon, lat, crs: str):
    """Lon/lat degrees -> coordinates in ``crs`` (vectorized). Latitudes
    are clamped to the mercator domain (|lat| <= ~85.05) the way web
    mercator implementations conventionally do."""
    if normalize_crs(crs) == "EPSG:4326":
        return np.asarray(lon, np.float64), np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    lat = np.clip(np.asarray(lat, np.float64), -MAX_LAT_3857, MAX_LAT_3857)
    x = _R * np.radians(lon)
    y = _R * np.log(np.tan(np.pi / 4.0 + np.radians(lat) / 2.0))
    return x, y


def bbox_to_4326(x0: float, y0: float, x1: float, y1: float, crs: str):
    """An axis-aligned box in ``crs`` -> the equivalent 4326 box. Exact
    for 3857: mercator is separable and monotone per axis, so corners map
    to corners."""
    lons, lats = to_4326(np.array([x0, x1]), np.array([y0, y1]), crs)
    return float(lons[0]), float(lats[0]), float(lons[1]), float(lats[1])


def transform_geometry(g: geo.Geometry, src: str, dst: str) -> geo.Geometry:
    """Reproject one geometry object src -> dst (both supported CRSs)."""
    src, dst = normalize_crs(src), normalize_crs(dst)
    if src == dst:
        return g

    def tx(c: np.ndarray) -> np.ndarray:
        lon, lat = (c[:, 0], c[:, 1]) if src == "EPSG:4326" else to_4326(
            c[:, 0], c[:, 1], src
        )
        x, y = (lon, lat) if dst == "EPSG:4326" else from_4326(lon, lat, dst)
        return np.stack([x, y], axis=1)

    if isinstance(g, geo.Point):
        p = tx(np.array([[g.x, g.y]]))
        return geo.Point(float(p[0, 0]), float(p[0, 1]))
    if isinstance(g, geo.LineString):
        return geo.LineString(tx(np.asarray(g.coords)))
    if isinstance(g, geo.Polygon):
        return geo.Polygon(
            tx(np.asarray(g.shell)), holes=[tx(np.asarray(h)) for h in g.holes]
        )
    if isinstance(g, (geo.MultiPoint, geo.MultiLineString, geo.MultiPolygon)):
        return type(g)([transform_geometry(p, src, dst) for p in g.parts])
    raise TypeError(f"cannot reproject {type(g).__name__}")


def reproject_collection(fc, crs: str):
    """A new FeatureCollection with the geometry column reprojected from
    4326 to ``crs`` (the reference's QueryPlanner reprojection stage).
    Scalar columns are shared, not copied."""
    from geomesa_tpu_torch.features import FeatureCollection
    from geomesa_tpu_torch.filter.predicates import PointColumn

    crs = normalize_crs(crs)
    if crs == "EPSG:4326" or fc.sft.geom_field is None:
        return fc
    col = fc.geom_column
    cols = dict(fc.columns)
    # stamp the output CRS on the derived SFT so CRS-labelling sinks
    # (GML srsName, shapefile prj) describe the coordinates they carry
    from dataclasses import replace as _replace

    from geomesa_tpu_torch.sft import FeatureType

    attrs = []
    for a in fc.sft.attributes:
        if a.is_geometry:
            opts = dict(a.options)
            opts["srid"] = crs.split(":")[1]
            a = _replace(a, options=opts)
        attrs.append(a)
    user_data = dict(fc.sft.user_data)
    user_data["geomesa.crs"] = crs
    sft = FeatureType(fc.sft.name, attrs, user_data)
    if isinstance(col, PointColumn):
        x, y = from_4326(col.x, col.y, crs)
        cols[fc.sft.geom_field] = PointColumn(x, y)
    elif isinstance(col, geo.PackedGeometryColumn):
        c = np.asarray(col.coords, np.float64)
        x, y = from_4326(c[:, 0], c[:, 1], crs)
        coords = np.stack([x, y], axis=1)
        # mercator is monotone per axis: bbox corners map to corners
        bx0, by0 = from_4326(
            col.bboxes[:, 0].astype(np.float64),
            col.bboxes[:, 1].astype(np.float64), crs,
        )
        bx1, by1 = from_4326(
            col.bboxes[:, 2].astype(np.float64),
            col.bboxes[:, 3].astype(np.float64), crs,
        )
        bb = np.stack([bx0, by0, bx1, by1], axis=1).astype(np.float32)
        # keep the column's bbox invariant: one f32 ulp outward
        bb[:, :2] = np.nextafter(bb[:, :2], -np.inf)
        bb[:, 2:] = np.nextafter(bb[:, 2:], np.inf)
        out = geo.PackedGeometryColumn(
            coords, col.ring_offsets, col.part_ring_offsets,
            col.geom_part_offsets, col.types, bb,
        )
        # rectangles stay rectangles under the separable mercator map:
        # carry the box_info cache (with reprojected bounds) forward
        cached = getattr(col, "_box_info", None)
        if cached is not None:
            bmask, bounds = cached
            rx0, ry0 = from_4326(bounds[:, 0], bounds[:, 1], crs)
            rx1, ry1 = from_4326(bounds[:, 2], bounds[:, 3], crs)
            out._box_info = (bmask, np.stack([rx0, ry0, rx1, ry1], axis=1))
            out._uniform_rect = getattr(col, "_uniform_rect", False)
        cols[fc.sft.geom_field] = out
    return FeatureCollection(sft, fc.ids, cols)
