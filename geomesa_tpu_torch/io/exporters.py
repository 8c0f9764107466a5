"""Export sinks: CSV / TSV / GeoJSON / WKT lines / JSON rows / Arrow IPC.

Reference: the feature-exporter SPI (geomesa-features/
geomesa-feature-exporters/src/main/scala/org/locationtech/geomesa/
features/exporters/ — DelimitedExporter, GeoJsonExporter, ArrowExporter).
Columnar analogues: each sink renders whole columns. Arrow export uses
pyarrow when present and raises a clear error otherwise (the wheel is not
in every image).
"""

from __future__ import annotations

import io
import json
from typing import IO

import numpy as np

from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.predicates import PointColumn

FORMATS = (
    "csv", "tsv", "geojson", "wkt", "json", "gml", "arrow", "avro",
    "parquet", "orc", "leaflet",
)


def export(fc: FeatureCollection, fmt: str, fh: IO | None = None) -> "str | bytes":
    """Render a collection in ``fmt``; writes to ``fh`` when given, and
    always returns the rendered payload (str, or bytes for arrow)."""
    fmt = fmt.lower()
    if fmt in ("csv", "tsv"):
        payload = _delimited(fc, "," if fmt == "csv" else "\t")
    elif fmt == "geojson":
        payload = _geojson(fc)
    elif fmt == "wkt":
        payload = _wkt_lines(fc)
    elif fmt == "json":
        payload = _json_rows(fc)
    elif fmt == "gml":
        payload = _gml(fc)
    elif fmt == "arrow":
        payload = _arrow(fc)
    elif fmt == "avro":
        from geomesa_tpu_torch.io.avro import write_avro

        payload = write_avro(fc)
    elif fmt == "parquet":
        import io as _io

        from geomesa_tpu_torch.io.parquet import write_parquet

        buf = _io.BytesIO()
        write_parquet(fc, buf)
        payload = buf.getvalue()
    elif fmt == "orc":
        import io as _io

        from geomesa_tpu_torch.io.orc import write_orc

        buf = _io.BytesIO()
        write_orc(fc, buf)
        payload = buf.getvalue()
    elif fmt == "leaflet":
        payload = _leaflet(fc)
    else:
        raise ValueError(f"unknown format {fmt!r}; supported: {FORMATS}")
    if fh is not None:
        fh.write(payload)
    return payload


def _geom_strings(fc: FeatureCollection) -> "np.ndarray | None":
    col = fc.geom_column
    if col is None:
        return None
    if isinstance(col, PointColumn):
        return np.array(
            [f"POINT ({x:.10g} {y:.10g})" for x, y in zip(col.x, col.y)]
        )
    return np.array([geo.to_wkt(col.geometry(i)) for i in range(len(col))])


def _cell(v) -> str:
    if isinstance(v, (float, np.floating)):
        return f"{v:.10g}"
    return str(v)


def _date_strings(col) -> np.ndarray:
    """ISO-8601 rendering of an epoch-millis Date column."""
    return np.datetime_as_string(
        np.asarray(col, dtype=np.int64).astype("datetime64[ms]"), unit="ms"
    )


def date_str(v) -> str:
    """ISO-8601 'Z' rendering of one epoch-millis value — the single
    definition shared by the GML and DBF writers."""
    return f"{np.datetime64(int(v), 'ms')}Z"


def _delimited(fc: FeatureCollection, sep: str) -> str:
    geom_field = fc.sft.geom_field
    geoms = _geom_strings(fc)
    names = [a.name for a in fc.sft.attributes]
    types = {a.name: a.type for a in fc.sft.attributes}
    out = io.StringIO()
    out.write(sep.join(["id"] + names) + "\n")
    cols = []
    for n in names:
        if n == geom_field:
            cols.append(geoms)
        elif types[n] == "Date":
            cols.append(_date_strings(fc.columns[n]))
        else:
            cols.append(np.asarray(fc.columns[n]))
    for i in range(len(fc)):
        row = [str(fc.ids[i])] + [_cell(c[i]) for c in cols]
        out.write(sep.join(_quote(v, sep) for v in row) + "\n")
    return out.getvalue()


def _quote(v: str, sep: str) -> str:
    if sep in v or '"' in v or "\n" in v:
        return '"' + v.replace('"', '""') + '"'
    return v


def geojson_features(fc: FeatureCollection):
    """Per-feature GeoJSON dicts, in result order — the shared core of
    :func:`_geojson` and the served data plane's streamed writer
    (serving/http.py), so a paged network response is bit-identical to
    the one-shot export by construction."""
    geom_field = fc.sft.geom_field
    date_fields = {a.name for a in fc.sft.attributes if a.type == "Date"}
    for row in fc.to_rows():
        fid = row.pop("__id__")
        g = row.pop(geom_field, None)  # to_rows already decoded the geometry
        props = {
            k: (date_str(v) if k in date_fields and v is not None else _jsonable(v))
            for k, v in row.items()
        }
        yield {
            "type": "Feature",
            "id": fid,
            "geometry": _geojson_geom(g) if g is not None else None,
            "properties": props,
        }


def geojson_crs(fc: FeatureCollection) -> "dict | None":
    """The legacy named-CRS member for non-WGS84 collections (None for
    EPSG:4326). RFC 7946 mandates WGS84; reprojected collections carry
    the GeoJSON-2008 member so coordinates are not misread as degrees."""
    crs = str(fc.sft.user_data.get("geomesa.crs", "EPSG:4326"))
    if crs == "EPSG:4326":
        return None
    code = crs.split(":")[-1]
    return {
        "type": "name",
        "properties": {"name": f"urn:ogc:def:crs:EPSG::{code}"},
    }


def _geojson(fc: FeatureCollection) -> str:
    out = {"type": "FeatureCollection", "features": list(geojson_features(fc))}
    crs = geojson_crs(fc)
    if crs is not None:
        out["crs"] = crs
    return json.dumps(out)


def _geojson_geom(g: geo.Geometry) -> dict:
    def ring(r):
        return [[float(x), float(y)] for x, y in np.asarray(r)]

    if isinstance(g, geo.Point):
        return {"type": "Point", "coordinates": [g.x, g.y]}
    if isinstance(g, geo.LineString):
        return {"type": "LineString", "coordinates": ring(g.coords)}
    if isinstance(g, geo.Polygon):
        return {"type": "Polygon", "coordinates": [ring(g.shell)] + [ring(h) for h in g.holes]}
    if isinstance(g, geo.MultiPoint):
        return {"type": "MultiPoint", "coordinates": [[p.x, p.y] for p in g.parts]}
    if isinstance(g, geo.MultiLineString):
        return {"type": "MultiLineString", "coordinates": [ring(p.coords) for p in g.parts]}
    if isinstance(g, geo.MultiPolygon):
        return {
            "type": "MultiPolygon",
            "coordinates": [
                [ring(p.shell)] + [ring(h) for h in p.holes] for p in g.parts
            ],
        }
    raise TypeError(f"cannot render {type(g)}")


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.str_):
        return str(v)
    return v


def _wkt_lines(fc: FeatureCollection) -> str:
    geoms = _geom_strings(fc)
    if geoms is None:
        raise ValueError("schema has no geometry to export as WKT")
    return "\n".join(geoms.tolist()) + "\n"


def _json_rows(fc: FeatureCollection) -> str:
    geom_field = fc.sft.geom_field
    rows = []
    for row in fc.to_rows():
        if geom_field in row:
            row[geom_field] = geo.to_wkt(row[geom_field])
        rows.append({k: _jsonable(v) for k, v in row.items()})
    return json.dumps(rows)


def _arrow(fc: FeatureCollection) -> bytes:
    """Arrow IPC record-batch stream built from the store's columns, with
    dictionary-encoded string attributes (geomesa_tpu_torch.io.arrow; reference
    ArrowScan.scala:31-240)."""
    from geomesa_tpu_torch.io.arrow import arrow_stream

    return arrow_stream(fc)


def _gml_coords(coords) -> str:
    return " ".join(f"{x:.10g} {y:.10g}" for x, y in np.asarray(coords))


def _gml_geom(g: "geo.Geometry", srs: str = "EPSG:4326") -> str:
    """GML 3.1 geometry element (srsName from the collection's CRS,
    lon/lat order kept)."""
    if isinstance(g, geo.Point):
        return (
            f'<gml:Point srsName="{srs}"><gml:pos>{g.x:.10g} {g.y:.10g}'
            "</gml:pos></gml:Point>"
        )
    if isinstance(g, geo.LineString):
        return (
            f'<gml:LineString srsName="{srs}"><gml:posList>'
            f"{_gml_coords(g.coords)}</gml:posList></gml:LineString>"
        )
    if isinstance(g, geo.Polygon):
        rings = [
            "<gml:exterior><gml:LinearRing><gml:posList>"
            f"{_gml_coords(g.shell)}</gml:posList></gml:LinearRing></gml:exterior>"
        ]
        for h in g.holes:
            rings.append(
                "<gml:interior><gml:LinearRing><gml:posList>"
                f"{_gml_coords(h)}</gml:posList></gml:LinearRing></gml:interior>"
            )
        return (
            f'<gml:Polygon srsName="{srs}">{"".join(rings)}</gml:Polygon>'
        )
    if isinstance(g, (geo.MultiPoint, geo.MultiLineString, geo.MultiPolygon)):
        tag = {
            geo.MultiPoint: ("gml:MultiPoint", "gml:pointMember"),
            geo.MultiLineString: ("gml:MultiCurve", "gml:curveMember"),
            geo.MultiPolygon: ("gml:MultiSurface", "gml:surfaceMember"),
        }[type(g)]
        inner = "".join(
            f"<{tag[1]}>{_gml_geom(p, srs)}</{tag[1]}>" for p in g.parts
        )
        return f'<{tag[0]} srsName="{srs}">{inner}</{tag[0]}>'
    raise ValueError(f"cannot GML-encode {type(g).__name__}")


def _gml(fc: FeatureCollection) -> str:
    """GML 3.1 FeatureCollection (reference GmlExporter,
    geomesa-feature-exporters)."""
    from xml.sax.saxutils import escape, quoteattr

    sft = fc.sft
    name = escape(sft.name or "features")
    # a reprojected collection stamps its CRS in user_data (crs.py)
    srs = str(sft.user_data.get("geomesa.crs", "EPSG:4326"))
    geoms = fc.geometries()
    parts = [
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<gml:FeatureCollection xmlns:gml="http://www.opengis.net/gml" '
        'xmlns:geomesa="http://geomesa.org">\n'
    ]
    for i in range(len(fc)):
        parts.append(
            f"<gml:featureMember><geomesa:{name} "
            f"gml:id={quoteattr(str(fc.ids[i]))}>"
        )
        for a in sft.attributes:
            if a.is_geometry:
                parts.append(
                    f"<geomesa:{a.name}>{_gml_geom(geoms[i], srs)}"
                    f"</geomesa:{a.name}>"
                )
                continue
            v = fc.columns[a.name][i]
            if a.type == "Date":
                v = date_str(v)
            parts.append(f"<geomesa:{a.name}>{escape(str(v))}</geomesa:{a.name}>")
        parts.append(f"</geomesa:{name}></gml:featureMember>\n")
    parts.append("</gml:FeatureCollection>\n")
    return "".join(parts)


def _leaflet(fc: FeatureCollection) -> str:
    """Self-contained Leaflet HTML map with the features inlined as a
    GeoJSON FeatureCollection (reference LeafletMapExporter: HTML shell +
    CDN leaflet + `var points = <geojson>` + a density-weighted heat
    layer; here the heat tint rides per-marker opacity)."""
    from xml.sax.saxutils import escape

    if str(fc.sft.user_data.get("geomesa.crs", "EPSG:4326")) != "EPSG:4326":
        # the Leaflet map template interprets coordinates as lon/lat
        # degrees; a reprojected collection would render at garbage
        # positions with no error
        raise ValueError(
            "leaflet export requires EPSG:4326 coordinates; drop the "
            "reproject hint"
        )
    # '</' must not appear literally inside the <script> block: a string
    # attribute containing '</script>' would otherwise terminate it and
    # inject attacker-controlled markup into the exported page
    gj = _geojson(fc).replace("</", "<\\/")
    xs, ys = (
        fc.representative_xy() if len(fc) and fc.sft.geom_field else ([0.0], [0.0])
    )
    cx = float(np.mean(np.asarray(ys))) if len(ys) else 0.0
    cy = float(np.mean(np.asarray(xs))) if len(xs) else 0.0
    title = escape(fc.sft.name)
    return f"""<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8"/>
<title>{title}</title>
<link rel="stylesheet" href="https://unpkg.com/leaflet@1.9.4/dist/leaflet.css"/>
<script src="https://unpkg.com/leaflet@1.9.4/dist/leaflet.js"></script>
<style>html, body, #map {{ height: 100%; margin: 0; }}</style>
</head>
<body>
<div id="map"></div>
<script>
var points = {gj};
var map = L.map('map').setView([{cx:.6f}, {cy:.6f}], 3);
L.tileLayer('https://{{s}}.tile.openstreetmap.org/{{z}}/{{x}}/{{y}}.png',
  {{ attribution: '&copy; OpenStreetMap contributors' }}).addTo(map);
var layer = L.geoJSON(points, {{
  pointToLayer: function (feature, latlng) {{
    return L.circleMarker(latlng, {{ radius: 4, weight: 1, fillOpacity: 0.6 }});
  }},
  onEachFeature: function (feature, l) {{
    var esc = function (s) {{
      return s.replace(/[&<>]/g, function (c) {{
        return {{'&': '&amp;', '<': '&lt;', '>': '&gt;'}}[c];
      }});
    }};
    // bindPopup renders HTML: attribute values must be escaped or a
    // hostile string attribute executes in the reader's browser
    l.bindPopup('<pre>' + esc(JSON.stringify(feature.properties, null, 1)) + '</pre>');
  }}
}}).addTo(map);
if (layer.getBounds().isValid()) {{ map.fitBounds(layer.getBounds()); }}
</script>
</body>
</html>
"""
