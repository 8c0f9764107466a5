"""Shapefile (.shp/.dbf) reader: ESRI shapefiles -> feature batches.

Reference: geomesa-convert-shp (geomesa-convert/
geomesa-convert-shp/src/main/scala/org/locationtech/geomesa/convert/shp/
ShapefileConverter.scala) — there it delegates to GeoTools' shapefile
store; here the format is decoded directly (no GDAL/fiona in the image):
the .shp geometry file (ESRI whitepaper layout: 100-byte header, BE
record headers, LE shapes) and the dBase III .dbf attribute file
(fixed-width ASCII records). Point/MultiPoint/PolyLine/Polygon shapes
map onto the packed geometry model; polygon ring winding (outer = CW in
shapefiles) splits shells from holes, holes attaching to the preceding
shell (the standard writer ordering).
"""

from __future__ import annotations

import struct
from typing import IO, Optional

import numpy as np

from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.sft import FeatureType

SHP_MAGIC = 9994

# shape type code -> handler name
_POINT = {1, 11, 21}  # Point / PointZ / PointM (Z/M dropped)
_POLYLINE = {3, 13, 23}
_POLYGON = {5, 15, 25}
_MULTIPOINT = {8, 18, 28}


def _ring_is_cw(ring: np.ndarray) -> bool:
    """Shoelace: negative signed area = clockwise = shapefile outer ring."""
    x, y = ring[:, 0], ring[:, 1]
    return float(np.sum(x[:-1] * y[1:] - x[1:] * y[:-1])) < 0


def _read_shapes(data: bytes) -> list:
    """.shp payload -> list of Geometry | None (null shapes)."""
    if len(data) < 100 or struct.unpack(">i", data[:4])[0] != SHP_MAGIC:
        raise ValueError("not a shapefile (.shp)")
    out: list = []
    pos = 100
    n = len(data)
    while pos + 8 <= n:
        (_recno, content_words) = struct.unpack(">ii", data[pos : pos + 8])
        pos += 8
        end = pos + content_words * 2
        if end > n:
            raise ValueError("truncated shapefile record")
        (stype,) = struct.unpack("<i", data[pos : pos + 4])
        body = data[pos + 4 : end]
        pos = end
        if stype == 0:
            out.append(None)
        elif stype in _POINT:
            x, y = struct.unpack_from("<2d", body, 0)
            out.append(geo.Point(x, y))
        elif stype in _MULTIPOINT:
            (npts,) = struct.unpack_from("<i", body, 32)
            pts = np.frombuffer(body, "<f8", count=npts * 2, offset=36).reshape(-1, 2)
            out.append(
                geo.MultiPoint([geo.Point(float(p[0]), float(p[1])) for p in pts])
            )
        elif stype in _POLYLINE or stype in _POLYGON:
            nparts, npts = struct.unpack_from("<2i", body, 32)
            parts = np.frombuffer(body, "<i4", count=nparts, offset=40)
            pts = np.frombuffer(
                body, "<f8", count=npts * 2, offset=40 + 4 * nparts
            ).reshape(-1, 2)
            bounds = np.append(parts, npts)
            rings = [
                np.array(pts[bounds[i] : bounds[i + 1]], dtype=np.float64)
                for i in range(nparts)
            ]
            if stype in _POLYLINE:
                lines = [geo.LineString(r) for r in rings if len(r) >= 2]
                out.append(
                    lines[0] if len(lines) == 1 else geo.MultiLineString(lines)
                )
            else:
                out.append(_assemble_polygon(rings))
        else:
            raise ValueError(f"unsupported shape type {stype}")
    return out


def _assemble_polygon(rings: list) -> "geo.Geometry":
    """CW rings open polygons, CCW rings are holes of the preceding shell
    (standard shapefile writer ordering)."""
    polys: list[tuple[np.ndarray, list]] = []
    for r in rings:
        if len(r) < 4:
            continue
        if _ring_is_cw(r) or not polys:
            polys.append((r[::-1].copy(), []))  # store shells CCW (WKT norm)
        else:
            polys[-1][1].append(r)
    if not polys:
        raise ValueError("polygon record with no valid rings")
    geoms = [geo.Polygon(shell, holes) for shell, holes in polys]
    return geoms[0] if len(geoms) == 1 else geo.MultiPolygon(geoms)


def _read_dbf(data: bytes) -> tuple[list[str], list[str], list[list]]:
    """dBase III file -> (field names, field types, record values)."""
    if len(data) < 32:
        raise ValueError("truncated .dbf")
    n_rec, hdr_size, rec_size = struct.unpack_from("<iHH", data, 4)
    fields = []
    pos = 32
    while pos < hdr_size - 1 and data[pos] != 0x0D:
        name = data[pos : pos + 11].split(b"\x00")[0].decode("ascii", "replace")
        ftype = chr(data[pos + 11])
        length = data[pos + 16]
        decimals = data[pos + 17]
        fields.append((name, ftype, length, decimals))
        pos += 32
    names = [f[0] for f in fields]
    kinds = []
    for _, ftype, _length, decimals in fields:
        if ftype in ("N", "F"):
            kinds.append("Double" if (decimals > 0 or ftype == "F") else "Long")
        elif ftype == "L":
            kinds.append("Boolean")
        elif ftype == "D":
            kinds.append("String")  # YYYYMMDD kept as text
        else:
            kinds.append("String")
    records: list[list] = []
    pos = hdr_size
    for _ in range(n_rec):
        if pos + rec_size > len(data):
            break
        rec = data[pos : pos + rec_size]
        pos += rec_size
        if rec[:1] == b"*":  # deleted
            records.append(None)
            continue
        vals: list = []
        off = 1
        for (name, ftype, length, decimals), kind in zip(fields, kinds):
            raw = rec[off : off + length].decode("latin-1").strip()
            off += length
            if kind == "Long":
                vals.append(int(raw) if raw and raw != "*" * length else 0)
            elif kind == "Double":
                vals.append(float(raw) if raw else float("nan"))
            elif kind == "Boolean":
                vals.append(raw.upper() in ("T", "Y"))
            else:
                vals.append(raw)
        records.append(vals)
    return names, kinds, records


def read_shapefile(
    shp: "bytes | str | IO",
    dbf: "bytes | str | IO | None" = None,
    type_name: str = "shp",
    geom_name: str = "geom",
) -> FeatureCollection:
    """Decode a shapefile (+ optional .dbf attributes) into a collection
    with an inferred schema. ``shp``/``dbf`` accept bytes, paths or file
    objects; when ``shp`` is a path and ``dbf`` is None, the sibling .dbf
    is picked up automatically."""

    def _bytes(src):
        if src is None:
            return None
        if isinstance(src, bytes):
            return src
        if isinstance(src, str):
            with open(src, "rb") as fh:
                return fh.read()
        return src.read()

    if isinstance(shp, str) and dbf is None:
        import os

        cand = shp[:-4] + ".dbf" if shp.lower().endswith(".shp") else None
        if cand and os.path.exists(cand):
            dbf = cand
    shapes = _read_shapes(_bytes(shp))
    names: list[str] = []
    kinds: list[str] = []
    records: Optional[list] = None
    d = _bytes(dbf)
    if d is not None:
        names, kinds, records = _read_dbf(d)
        if len(records) != len(shapes):
            raise ValueError(
                f".dbf has {len(records)} records but .shp has {len(shapes)} shapes"
            )

    keep = [
        i
        for i, s in enumerate(shapes)
        if s is not None and (records is None or records[i] is not None)
    ]
    gtype = "Geometry"
    ts = {type(shapes[i]).__name__ for i in keep}
    if len(ts) == 1:
        gtype = ts.pop()
    # the sibling .prj decides the srid stamp (written by write_shapefile;
    # Web-Mercator files must not round-trip mislabeled as degrees)
    srid = "4326"
    if isinstance(shp, str):
        import os

        prj = (shp[:-4] if shp.lower().endswith(".shp") else shp) + ".prj"
        if os.path.exists(prj):
            with open(prj, encoding="ascii", errors="replace") as fh:
                wkt = fh.read()
            if "Mercator" in wkt or "3857" in wkt:
                srid = "3857"
    spec = ",".join(
        [f"{n}:{k}" for n, k in zip(names, kinds)]
        + [f"*{geom_name}:{gtype}:srid={srid}"]
    )
    sft = FeatureType.from_spec(type_name, spec)
    if srid == "3857":
        sft.user_data["geomesa.crs"] = "EPSG:3857"
    rows = []
    for i in keep:
        row = {geom_name: shapes[i]}
        if records is not None:
            row.update(dict(zip(names, records[i])))
        rows.append(row)
    return FeatureCollection.from_rows(sft, rows, ids=[str(i) for i in keep])


# ------------------------------------------------------------------ write

_TYPE_CODE = {"Point": 1, "LineString": 3, "Polygon": 5, "MultiLineString": 3,
              "MultiPolygon": 5, "MultiPoint": 8}


def _shape_record(g) -> bytes:
    """One record's content (shape type + body), little-endian."""
    if isinstance(g, geo.Point):
        return struct.pack("<i2d", 1, g.x, g.y)
    if isinstance(g, geo.MultiPoint):
        pts = np.array([[p.x, p.y] for p in g.parts], dtype="<f8")
        x0, y0, x1, y1 = g.bounds()
        return (
            struct.pack("<i4di", 8, x0, y0, x1, y1, len(pts)) + pts.tobytes()
        )
    if isinstance(g, (geo.LineString, geo.MultiLineString)):
        parts = [g.coords] if isinstance(g, geo.LineString) else [
            p.coords for p in g.parts
        ]
        code = 3
    elif isinstance(g, (geo.Polygon, geo.MultiPolygon)):
        polys = [g] if isinstance(g, geo.Polygon) else list(g.parts)
        parts = []
        for p in polys:
            shell = np.asarray(p.shell, dtype=np.float64)
            if not _ring_is_cw(shell):  # shapefile outer rings are CW
                shell = shell[::-1]
            parts.append(shell)
            for h in p.holes:
                hole = np.asarray(h, dtype=np.float64)
                if _ring_is_cw(hole):  # holes are CCW
                    hole = hole[::-1]
                parts.append(hole)
        code = 5
    else:
        raise ValueError(f"cannot write {type(g).__name__} to a shapefile")
    pts = np.concatenate([np.asarray(p, dtype="<f8") for p in parts])
    offsets = np.cumsum([0] + [len(p) for p in parts[:-1]]).astype("<i4")
    x0, y0, x1, y1 = g.bounds()
    return (
        struct.pack("<i4d2i", code, x0, y0, x1, y1, len(parts), len(pts))
        + offsets.tobytes()
        + pts.tobytes()
    )


def _dbf_fields(sft: FeatureType, fc: FeatureCollection):
    """(name, dbf type, width, decimals, formatter) per attribute."""
    out = []
    seen: set = set()
    for a in sft.attributes:
        if a.is_geometry:
            continue
        name = a.name[:10]
        k = 0
        while name in seen:  # 10-char truncation can collide
            k += 1
            name = f"{a.name[:10 - len(str(k))]}{k}"
        seen.add(name)
        col = fc.columns[a.name]
        if a.type in ("Integer", "Int", "Long"):
            # width 20 holds any int64 including the sign
            out.append((a.name, name, "N", 20, 0, lambda v: f"{int(v):>20d}"))
        elif a.type in ("Float", "Double"):
            # general format: any double fits in 25 chars at 16 sig digits
            out.append(
                (a.name, name, "F", 25, 8, lambda v: f"{float(v):>25.16g}")
            )
        elif a.type == "Boolean":
            out.append(
                (a.name, name, "L", 1, 0, lambda v: "T" if v else "F")
            )
        elif a.type == "Date":
            from geomesa_tpu_torch.io.exporters import date_str

            out.append((
                a.name, name, "C", 24, 0,
                lambda v: date_str(v)[:24].ljust(24),
            ))
        else:
            width = 1
            if len(col):
                width = min(
                    254, max(1, max(len(str(v)) for v in np.asarray(col)))
                )
            out.append((
                a.name, name, "C", width, 0,
                lambda v, w=width: str(v)[:w].ljust(w),
            ))
    return out


def write_shapefile(fc: FeatureCollection, base: str) -> None:
    """Write ``base``.shp/.shx/.dbf (reference ShapefileExporter,
    geomesa-feature-exporters). Geometries must share one shapefile type
    family (points, lines, or polygons); attributes go to the .dbf."""
    sft = fc.sft
    geoms = fc.geometries()
    if not geoms:
        raise ValueError("nothing to write")
    codes = {_TYPE_CODE[type(g).__name__] for g in geoms}
    if len(codes) > 1:
        raise ValueError("shapefile requires a single geometry type family")
    code = codes.pop()

    records = [_shape_record(g) for g in geoms]
    xs = np.array([g.bounds() for g in geoms])
    bbox = (xs[:, 0].min(), xs[:, 1].min(), xs[:, 2].max(), xs[:, 3].max())

    def header(file_words: int) -> bytes:
        return (
            struct.pack(">7i", SHP_MAGIC, 0, 0, 0, 0, 0, file_words)
            + struct.pack("<2i", 1000, code)
            + struct.pack("<8d", *bbox, 0.0, 0.0, 0.0, 0.0)
        )

    shp = bytearray()
    shx = bytearray()
    offset_words = 50  # header = 100 bytes
    for i, rec in enumerate(records):
        words = len(rec) // 2
        shx += struct.pack(">2i", offset_words, words)
        shp += struct.pack(">2i", i + 1, words) + rec
        offset_words += 4 + words
    with open(base + ".shp", "wb") as fh:
        fh.write(header(offset_words) + bytes(shp))
    with open(base + ".shx", "wb") as fh:
        fh.write(header(50 + 4 * len(records)) + bytes(shx))

    fields = _dbf_fields(sft, fc)
    rec_size = 1 + sum(f[3] for f in fields)
    hdr = bytearray(struct.pack(
        "<4BiHH20x", 3, 24, 1, 1, len(fc), 33 + 32 * len(fields), rec_size
    ))
    for _, name, ftype, width, dec, _fmt in fields:
        hdr += name.encode("ascii", "replace")[:10].ljust(11, b"\x00")
        hdr += ftype.encode() + b"\x00" * 4 + bytes([width, dec]) + b"\x00" * 14
    hdr += b"\x0d"
    body = bytearray()
    for i in range(len(fc)):
        body += b" "
        for attr, _name, _ftype, width, _dec, fmt in fields:
            cell = fmt(fc.columns[attr][i]).encode("latin-1", "replace")
            if len(cell) > width:
                raise ValueError(
                    f"value for {attr!r} exceeds its DBF width {width}"
                )
            body += cell.ljust(width)
    with open(base + ".dbf", "wb") as fh:
        fh.write(bytes(hdr) + bytes(body) + b"\x1a")

    # .prj: label the coordinates we actually wrote (a reprojected
    # collection stamps its CRS in user_data — crs.reproject_collection)
    crs = str(sft.user_data.get("geomesa.crs", "EPSG:4326"))
    with open(base + ".prj", "w", encoding="ascii") as fh:
        fh.write(_PRJ_WKT.get(crs, _PRJ_WKT["EPSG:4326"]))


# standard ESRI WKT strings for the supported CRSs
_PRJ_WKT = {
    "EPSG:4326": (
        'GEOGCS["GCS_WGS_1984",DATUM["D_WGS_1984",SPHEROID["WGS_1984",'
        '6378137.0,298.257223563]],PRIMEM["Greenwich",0.0],'
        'UNIT["Degree",0.0174532925199433]]'
    ),
    "EPSG:3857": (
        'PROJCS["WGS_1984_Web_Mercator_Auxiliary_Sphere",'
        'GEOGCS["GCS_WGS_1984",DATUM["D_WGS_1984",SPHEROID["WGS_1984",'
        '6378137.0,298.257223563]],PRIMEM["Greenwich",0.0],'
        'UNIT["Degree",0.0174532925199433]],'
        'PROJECTION["Mercator_Auxiliary_Sphere"],'
        'PARAMETER["False_Easting",0.0],PARAMETER["False_Northing",0.0],'
        'PARAMETER["Central_Meridian",0.0],'
        'PARAMETER["Standard_Parallel_1",0.0],'
        'PARAMETER["Auxiliary_Sphere_Type",0.0],UNIT["Meter",1.0]]'
    ),
}
