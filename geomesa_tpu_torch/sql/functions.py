"""ST_* spatial functions: the accessor and constructor subset.

The port's copy of part of geomesa_tpu/sql/functions.py (reference
spark-jts GeometricConstructorFunctions, GeometricAccessorFunctions,
GeometricOutputFunctions): the functions query transforms evaluate
(``lon=st_x(geom)``) that the port's geometry module supports. Every
function is registered in ``FUNCTIONS`` for name-based dispatch
(``st_call``). ``_geom_from_geojson`` decodes a GeoJSON geometry for the
GeoJSON reader (io.geojson), as in the reference. The relation,
measurement and processing functions come with the SQL tier.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

from geomesa_tpu_torch import geometry as geo

FUNCTIONS: dict[str, Callable] = {}


def _register(fn: Callable) -> Callable:
    FUNCTIONS[fn.__name__] = fn
    return fn


def st_call(name: str, *args):
    """Dispatch an ST_ function by (case-insensitive) name."""
    fn = FUNCTIONS.get(name.lower())
    if fn is None:
        raise KeyError(f"unknown function {name!r}")
    return fn(*args)


@_register
def st_point(x: float, y: float) -> geo.Point:
    return geo.Point(float(x), float(y))


@_register
def st_makepoint(x: float, y: float) -> geo.Point:
    return geo.Point(float(x), float(y))


@_register
def st_makebbox(xmin: float, ymin: float, xmax: float, ymax: float) -> geo.Polygon:
    return geo.box(xmin, ymin, xmax, ymax)


@_register
def st_makeline(points: Sequence) -> geo.LineString:
    coords = [(p.x, p.y) if isinstance(p, geo.Point) else tuple(p) for p in points]
    return geo.LineString(np.asarray(coords, dtype=np.float64))


@_register
def st_makepolygon(shell: "geo.LineString | Sequence") -> geo.Polygon:
    ring = shell.coords if isinstance(shell, geo.LineString) else np.asarray(shell)
    return geo.Polygon(ring)


@_register
def st_geomfromwkt(wkt: str) -> geo.Geometry:
    return geo.from_wkt(wkt)


def _geom_from_geojson(obj: dict) -> geo.Geometry:
    t = obj["type"]
    c = obj.get("coordinates")
    if t == "Point":
        return geo.Point(float(c[0]), float(c[1]))
    if t == "LineString":
        return geo.LineString(np.asarray(c, dtype=np.float64))
    if t == "Polygon":
        rings = [np.asarray(r, dtype=np.float64) for r in c]
        return geo.Polygon(rings[0], rings[1:])
    if t == "MultiPoint":
        return geo.MultiPoint([geo.Point(float(p[0]), float(p[1])) for p in c])
    if t == "MultiLineString":
        return geo.MultiLineString([geo.LineString(np.asarray(l, dtype=np.float64)) for l in c])
    if t == "MultiPolygon":
        return geo.MultiPolygon(
            [
                geo.Polygon(
                    np.asarray(p[0], dtype=np.float64),
                    [np.asarray(r, dtype=np.float64) for r in p[1:]],
                )
                for p in c
            ]
        )
    if t == "GeometryCollection":
        raise ValueError("GeometryCollection is not supported")
    raise ValueError(f"unknown GeoJSON type {t!r}")


@_register
def st_x(g: geo.Geometry) -> float:
    if not isinstance(g, geo.Point):
        raise TypeError("st_x requires a Point")
    return g.x


@_register
def st_y(g: geo.Geometry) -> float:
    if not isinstance(g, geo.Point):
        raise TypeError("st_y requires a Point")
    return g.y


@_register
def st_envelope(g: geo.Geometry) -> geo.Polygon:
    return geo.box(*g.bounds())


@_register
def st_geometrytype(g: geo.Geometry) -> str:
    return g.geom_type


@_register
def st_numpoints(g: geo.Geometry) -> int:
    return g._coord_count()


@_register
def st_isvalid(g: geo.Geometry) -> bool:
    b = g.bounds()
    return all(math.isfinite(v) for v in b)


@_register
def st_astext(g: geo.Geometry) -> str:
    return geo.to_wkt(g)
