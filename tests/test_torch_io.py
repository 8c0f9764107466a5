"""The port's readers, writers and codecs (io/, utils/bin_format,
DataStore.bin_query) against the JAX package's, on the CPU.

Both packages get the same seeded collections: points with every scalar
type (strings with separators, quotes, markup and non-ASCII), polygons
with holes, lines, and an empty collection. Every writer must give the
same bytes as the JAX writer (``export`` in each format, the shapefile's
three files, TWKB, Avro, BIN), and every reader the same collection: the
schema spec, ids in order and every column. The converters (delimited
with bad rows, JSON, XML, fixed width, Avro, DB-API rows, ``geomFromWkb``),
``infer_schema``, the validators and ``zigzag`` / ``unzigzag`` agree
value for value. ``DataStore.bin_query`` gives the same bytes as the JAX
package's on a Z3 and an XZ2 store, with and without ``track``, ``label``
and ``sort``, and equals ``bin_format.encode`` of the matching rows. The
Arrow, Parquet and ORC cases need pyarrow and skip without it, as
tests/test_arrow.py does. Tolerance: exact. Mirrors tests/test_io.py,
tests/test_codecs.py, tests/test_avro_xml.py, tests/test_shapefile.py,
tests/test_osm_streams.py and tests/test_arrow.py.
"""

import io
import sqlite3
import struct
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu.io import avro as javro
from geomesa_tpu.io import converters as jconv
from geomesa_tpu.io import exporters as jexp
from geomesa_tpu.io import geojson as jgeojson
from geomesa_tpu.io import osm as josm
from geomesa_tpu.io import shapefile as jshp
from geomesa_tpu.io import twkb as jtwkb
from geomesa_tpu.io import validators as jval
from geomesa_tpu.io import varint as jvarint
from geomesa_tpu.utils import bin_format as jbin
from geomesa_tpu_torch.io import avro as tavro
from geomesa_tpu_torch.io import converters as tconv
from geomesa_tpu_torch.io import exporters as texp
from geomesa_tpu_torch.io import geojson as tgeojson
from geomesa_tpu_torch.io import osm as tosm
from geomesa_tpu_torch.io import shapefile as tshp
from geomesa_tpu_torch.io import twkb as ttwkb
from geomesa_tpu_torch.io import validators as tval
from geomesa_tpu_torch.io import varint as tvarint
from geomesa_tpu_torch.utils import bin_format as tbin
from test_torch_native import ensure_jax_native

torch.set_num_threads(1)

JAX = SimpleNamespace(
    name="jax", pkg=geomesa_tpu, geo=geomesa_tpu.geometry, avro=javro, conv=jconv, exp=jexp,
    geojson=jgeojson, osm=josm, shp=jshp, twkb=jtwkb, val=jval, varint=jvarint, bin=jbin, kw={},
)
PORT = SimpleNamespace(
    name="port", pkg=geomesa_tpu_torch, geo=geomesa_tpu_torch.geometry, avro=tavro, conv=tconv,
    exp=texp, geojson=tgeojson, osm=tosm, shp=tshp, twkb=ttwkb, val=tval, varint=tvarint,
    bin=tbin, kw={"device": "cpu"},
)
BOTH = (JAX, PORT)

T0 = int(np.datetime64("2024-03-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000
POINT_SPEC = ("name:String,age:Int,big:Long,score:Double,ratio:Float,flag:Boolean,"
              "dtg:Date,*geom:Point:srid=4326")
NAMES = np.array(["plain", "a,b", 'say "hi"', "<tag>&amp;", "Zürich ünïcode", "tab\there", ""])


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    ensure_jax_native()


# ------------------------------------------------------------------ inputs


def _points(P, n=300, seed=1, name="pts"):
    rng = np.random.default_rng(seed)
    sft = P.pkg.FeatureType.from_spec(name, POINT_SPEC)
    return P.pkg.FeatureCollection.from_columns(sft, [f"f{i}" for i in range(n)], {
        "name": NAMES[np.arange(n) % len(NAMES)],
        "age": (np.arange(n) % 77).astype(np.int32),
        "big": rng.integers(-2**40, 2**40, n),
        "score": rng.uniform(-5, 5, n),
        "ratio": rng.uniform(0, 1, n).astype(np.float32),
        "flag": np.arange(n) % 3 == 0,
        "dtg": T0 + rng.integers(0, 5 * DAY, n),
        "geom": (rng.uniform(-170, 170, n), rng.uniform(-80, 80, n)),
    })


def _polygons(P, n=40, seed=2):
    rng = np.random.default_rng(seed)
    geo = P.geo
    geoms = []
    for i in range(n):
        x, y = rng.uniform(-150, 150), rng.uniform(-70, 70)
        w = rng.uniform(0.5, 5)
        shell = np.array([[x, y], [x + w, y], [x + w, y + w], [x, y + w], [x, y]])
        if i % 3 == 0:  # a hole, counter to the shell
            h = np.array([[x + w / 4, y + w / 4], [x + w / 4, y + w / 2],
                          [x + w / 2, y + w / 2], [x + w / 2, y + w / 4], [x + w / 4, y + w / 4]])
            geoms.append(geo.Polygon(shell, [h]))
        else:
            geoms.append(geo.Polygon(shell))
    sft = P.pkg.FeatureType.from_spec("polys", "name:String,dtg:Date,*geom:Polygon:srid=4326")
    return P.pkg.FeatureCollection.from_columns(sft, [f"p{i}" for i in range(n)], {
        "name": NAMES[np.arange(n) % len(NAMES)],
        "dtg": T0 + rng.integers(0, 5 * DAY, n),
        "geom": geoms,
    })


def _lines(P, n=30, seed=3):
    rng = np.random.default_rng(seed)
    geoms = [P.geo.LineString(np.cumsum(rng.uniform(-1, 1, (4 + i % 5, 2)), axis=0) + [10, 20])
             for i in range(n)]
    sft = P.pkg.FeatureType.from_spec("lines", "name:String,*geom:LineString:srid=4326")
    return P.pkg.FeatureCollection.from_columns(
        sft, [f"l{i}" for i in range(n)], {"name": NAMES[np.arange(n) % len(NAMES)], "geom": geoms})


def _empty(P):
    return _points(P, n=0)


COLLECTIONS = {"points": _points, "polygons": _polygons, "lines": _lines, "empty": _empty}


def _geometries(P):
    """One of each geometry kind, with negative and large coordinates."""
    geo = P.geo
    ring = np.array([[0, 0], [4, 0], [4, 4], [0, 4], [0, 0]], float)
    hole = np.array([[1, 1], [1, 2], [2, 2], [2, 1], [1, 1]], float)
    return [
        geo.Point(-122.4194155, 37.7749295),
        geo.Point(179.9999999, -89.9999999),
        geo.LineString(np.array([[0.5, 0.25], [1.75, -3.125], [100.0, 45.0]])),
        geo.Polygon(ring, [hole]),
        geo.MultiPoint([geo.Point(1, 2), geo.Point(-3.5, 4.25)]),
        geo.MultiLineString([geo.LineString(ring[:3]), geo.LineString(hole[:2] * 7)]),
        geo.MultiPolygon([geo.Polygon(ring), geo.Polygon(ring + 10, [hole + 10])]),
    ]


# ------------------------------------------------------------- comparison


def _col_state(col) -> list:
    if hasattr(col, "bboxes"):
        return [col.coords, col.ring_offsets, col.part_ring_offsets,
                col.geom_part_offsets, col.types, col.bboxes]
    if hasattr(col, "x"):
        return [col.x, col.y]
    return [col]


def _fc_state(fc) -> dict:
    out = {"spec": fc.sft.to_spec(), "name": fc.sft.name,
           "ids": [str(i) for i in np.asarray(fc.ids).tolist()]}
    for name, col in fc.columns.items():
        for i, a in enumerate(_col_state(col)):
            a = np.asarray(a)
            out[f"{name}.{i}"] = (a.dtype.str if a.dtype.kind != "O" else "O", a.tolist())
    return out


def _outcome(fn, *args, **kw):
    """A reader's collection, or the type and text of what it raised."""
    try:
        return _fc_state(fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 (both packages must fail alike)
        return type(e).__name__, str(e)


def _same_collection(a, b):
    sa, sb = _fc_state(a), _fc_state(b)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k] == sb[k], k


# ----------------------------------------------------------------- writers

TEXT_FORMATS = ["csv", "tsv", "geojson", "wkt", "json", "gml", "leaflet", "avro"]


@pytest.mark.parametrize("kind", sorted(COLLECTIONS))
@pytest.mark.parametrize("fmt", TEXT_FORMATS)
def test_export_is_byte_identical(fmt, kind):
    out = {}
    for P in BOTH:
        buf = io.BytesIO() if fmt == "avro" else io.StringIO()
        payload = P.exp.export(COLLECTIONS[kind](P), fmt, buf)
        assert buf.getvalue() == payload
        out[P.name] = payload
    assert out["jax"] == out["port"]
    assert PORT.exp.FORMATS == JAX.exp.FORMATS


def test_unknown_export_format_raises_alike():
    for P in BOTH:
        with pytest.raises(ValueError, match="unknown format"):
            P.exp.export(_points(P, 3), "xls")


@pytest.mark.parametrize("kind", ["points", "polygons", "lines"])
def test_shapefile_files_byte_identical_and_read_back(kind, tmp_path):
    files, back = {}, {}
    for P in BOTH:
        base = str(tmp_path / P.name / kind)
        (tmp_path / P.name).mkdir()
        P.shp.write_shapefile(COLLECTIONS[kind](P), base)
        files[P.name] = {ext: open(base + ext, "rb").read() for ext in (".shp", ".shx", ".dbf")}
        back[P.name] = P.shp.read_shapefile(base + ".shp", type_name=kind)
    assert files["jax"] == files["port"]
    _same_collection(back["jax"], back["port"])
    # each package reads the other's files
    _same_collection(PORT.shp.read_shapefile(str(tmp_path / "jax" / kind) + ".shp", type_name=kind),
                     back["jax"])


def _shp_bytes(records):
    body = b""
    for i, content in enumerate(records):
        body += struct.pack(">ii", i + 1, len(content) // 2) + content
    header = struct.pack(">i5i", 9994, 0, 0, 0, 0, 0) + struct.pack(">i", (100 + len(body)) // 2)
    header += struct.pack("<ii", 1000, 1) + struct.pack("<8d", *([0.0] * 8))
    return header + body


def test_shapefile_reader_edge_records_agree():
    """Hand-built records: a null shape, a two-shell multipolygon, a
    polyline, and garbage (tests/test_shapefile.py's inputs)."""
    cw = np.array([[0, 0], [0, 4], [4, 4], [4, 0], [0, 0]], float)

    def poly(rings, code=5):
        pts = np.concatenate(rings)
        parts = np.cumsum([0] + [len(r) for r in rings[:-1]]).astype("<i4")
        out = struct.pack("<i4d", code, pts[:, 0].min(), pts[:, 1].min(),
                          pts[:, 0].max(), pts[:, 1].max())
        return out + struct.pack("<2i", len(rings), len(pts)) + parts.tobytes() + pts.astype("<f8").tobytes()

    shp = _shp_bytes([struct.pack("<i", 0), poly([cw, cw + 10]), poly([cw[:3]], code=3)])
    _same_collection(JAX.shp.read_shapefile(shp), PORT.shp.read_shapefile(shp))
    for P in BOTH:
        with pytest.raises(ValueError):
            P.shp.read_shapefile(b"not a shapefile at all" * 10)


def test_twkb_bytes_and_decode_identical():
    for precision in (7, 3, 0, -2):
        for gj, gt in zip(_geometries(JAX), _geometries(PORT)):
            bj, bt = jtwkb.to_twkb(gj, precision), ttwkb.to_twkb(gt, precision)
            assert bj == bt, (gt.geom_type, precision)
            assert JAX.geo.to_wkt(jtwkb.from_twkb(bj)) == PORT.geo.to_wkt(ttwkb.from_twkb(bt))
    for P in BOTH:
        with pytest.raises((ValueError, IndexError)):
            P.twkb.from_twkb(b"\xff")


# ----------------------------------------------------------------- readers


@pytest.mark.parametrize("kind", ["points", "polygons", "lines"])
def test_geojson_reader_agrees(kind):
    text = PORT.exp.export(COLLECTIONS[kind](PORT), "geojson")
    backs = [P.geojson.read_geojson(text, type_name=kind) for P in BOTH]
    _same_collection(*backs)
    # an explicit schema names the geometry key; ids offset when absent
    sfts = [P.pkg.FeatureType.from_spec(kind, COLLECTIONS[kind](P).sft.to_spec()) for P in BOTH]
    assert _outcome(JAX.geojson.read_geojson, text, sft=sfts[0]) == _outcome(
        PORT.geojson.read_geojson, text, sft=sfts[1])
    doc = ('{"type":"FeatureCollection","features":[{"type":"Feature","geometry":'
           '{"type":"Point","coordinates":[1,2]},"properties":{"a":1}},{"type":"Feature",'
           '"geometry":{"type":"Polygon","coordinates":[[[0,0],[1,0],[1,1],[0,0]]]}}]}')
    assert _outcome(JAX.geojson.read_geojson, doc, id_offset=5) == _outcome(
        PORT.geojson.read_geojson, doc, id_offset=5)


@pytest.mark.parametrize("kind", ["points", "polygons", "empty"])
def test_avro_reads_back_in_both_packages(kind):
    payloads = {P.name: P.avro.write_avro(COLLECTIONS[kind](P), block_rows=64) for P in BOTH}
    assert payloads["jax"] == payloads["port"]
    data = payloads["port"]
    _same_collection(JAX.avro.read_avro(data), PORT.avro.read_avro(data))
    sfts = [COLLECTIONS[kind](P).sft for P in BOTH]
    _same_collection(JAX.avro.read_avro(io.BytesIO(data), sfts[0]), PORT.avro.read_avro(io.BytesIO(data), sfts[1]))
    assert JAX.avro.schema_dict(sfts[0]) == PORT.avro.schema_dict(sfts[1])
    recs = [list(P.avro.read_records(data)[1]) for P in BOTH]
    assert recs[0] == recs[1]
    bad = data[:-20] + bytes(20)
    for P in BOTH:
        with pytest.raises(ValueError):
            P.avro.read_avro(bad)


OSM = """<?xml version="1.0"?>
<osm version="0.6">
  <node id="1" lat="48.1" lon="11.5"><tag k="name" v="Stop A"/><tag k="highway" v="bus_stop"/></node>
  <node id="2" lat="48.2" lon="11.6"/>
  <node id="3" lat="48.3" lon="11.7"/>
  <node id="4" lat="48.1" lon="11.8"><tag k="amenity" v="cafe"/><tag k="name" v="Cafe B"/></node>
  <node id="10" lat="48.0" lon="11.0"/>
  <node id="11" lat="48.0" lon="11.1"/>
  <node id="12" lat="48.1" lon="11.1"/>
  <node id="13" lat="48.1" lon="11.0"/>
  <way id="100"><nd ref="2"/><nd ref="3"/><tag k="highway" v="residential"/><tag k="name" v="Main St"/></way>
  <way id="200"><nd ref="10"/><nd ref="11"/><nd ref="12"/><nd ref="13"/><nd ref="10"/><tag k="building" v="yes"/></way>
  <way id="300"><nd ref="10"/><nd ref="99"/></way>
</osm>
"""


@pytest.mark.parametrize("kind,tagged_only", [("nodes", True), ("nodes", False), ("ways", True)])
def test_osm_reader_agrees(kind, tagged_only):
    outs = [P.osm.read_osm(OSM, kind=kind, tagged_only=tagged_only) for P in BOTH]
    _same_collection(*outs)
    assert [g.geom_type for g in outs[0].geometries()] == [g.geom_type for g in outs[1].geometries()]
    osm_bytes = io.BytesIO(OSM.encode())
    _same_collection(outs[1], PORT.osm.read_osm(osm_bytes, kind=kind, tagged_only=tagged_only))


# -------------------------------------------------------------- converters

XML_DOC = """<?xml version="1.0"?>
<gml:Observations xmlns:gml="http://www.opengis.net/gml">
  <gml:Observation station="alpha">
    <gml:value>12.5</gml:value><gml:when>2024-03-05T12:30:00Z</gml:when>
    <gml:pos lon="16.4" lat="48.2"/>
  </gml:Observation>
  <gml:Observation station="beta">
    <gml:value>-3.25</gml:value><gml:when>2024-03-06T00:00:00Z</gml:when>
    <gml:pos lon="151.2" lat="-33.9"/>
  </gml:Observation>
  <gml:Observation station="gamma">
    <gml:value>oops</gml:value><gml:when>2024-03-06T00:00:00Z</gml:when>
    <gml:pos lon="1" lat="2"/>
  </gml:Observation>
</gml:Observations>
"""


def _csv_text(n=200, seed=4):
    rng = np.random.default_rng(seed)
    lines = ["name,val,lon,lat,when\n"]
    for i in range(n):
        val = "NaNope" if i % 37 == 5 else f"{rng.uniform():.4f}"
        lon = 250.0 if i % 41 == 7 else rng.uniform(-60, 60)
        lines.append(f"r{i},{val},{lon:.4f},{rng.uniform(-45, 45):.4f},2024-02-0{1 + i % 9}T00:00:00Z\n")
    lines.append("short,1\n")
    return "".join(lines)


def _converter(P, case):
    FS = P.conv.FieldSpec
    if case in ("delimited", "validated", "raise"):
        sft = P.pkg.FeatureType.from_spec("c", "name:String,val:Double,dtg:Date,*geom:Point:srid=4326")
        return P.conv.Converter(
            sft=sft, fmt="delimited", skip_lines=1, id_field="md5($1)",
            fields=[FS("name", "concat($1, '-', touppercase($1))"), FS("val", "$2::double"),
                    FS("geom", "point($3, $4)"), FS("dtg", "datetime($5)")],
            validators="index" if case == "validated" else None,
            drop_errors=case != "raise",
        )
    if case == "json":
        sft = P.pkg.FeatureType.from_spec("j", "name:String,n:Int,*geom:Point:srid=4326")
        return P.conv.Converter(
            sft=sft, fmt="json", id_field="$.id",
            fields=[FS("name", "$.props.name"), FS("n", "$.props.n::int"),
                    FS("geom", "point($.loc.x, $.loc.y)")],
        )
    if case == "xml":
        sft = P.pkg.FeatureType.from_spec("obs", "station:String,value:Double,dtg:Date,*geom:Point:srid=4326")
        return P.conv.Converter(
            sft=sft, fmt="xml", xml_feature_tag="Observation", id_field="$.@station",
            fields=[FS("station", "$.@station"), FS("value", "$.value::double"),
                    FS("dtg", "datetime($.when)"), FS("geom", "point($.pos.@lon, $.pos.@lat)")],
        )
    if case == "fixed":
        sft = P.pkg.FeatureType.from_spec("fw", "name:String,*geom:Point:srid=4326")
        return P.conv.Converter(
            sft, fields=[FS("name", "trim($1)"), FS("geom", "point($2, $3)")],
            fmt="fixed-width", fixed_widths=[(0, 6), (6, 8), (14, 8)], skip_lines=1,
        )
    if case == "wkb":
        sft = P.pkg.FeatureType.from_spec("w", "name:String,*geom:Geometry:srid=4326")
        return P.conv.Converter(sft, fields=[FS("name", "$1"), FS("geom", "geomFromWkb($2)")], id_field="$1")
    raise AssertionError(case)


def _converter_input(P, case):
    if case in ("delimited", "validated", "raise"):
        return _csv_text()
    if case == "json":
        return ('[{"id": "a", "props": {"name": "x", "n": "3"}, "loc": {"x": 1.5, "y": 2}},'
                ' {"id": "b", "props": {"name": "y", "n": 4}, "loc": {"x": -7, "y": 8.25}},'
                ' {"id": "c", "props": {"name": "z", "n": "bad"}, "loc": {"x": 0, "y": 0}}]').encode()
    if case == "xml":
        return io.StringIO(XML_DOC)
    if case == "fixed":
        return "NAME  LON     LAT     \nalpha   10.50   20.25\nbeta   -33.10   51.00\n\nbad   xx      yy\n"
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["delimited", "validated", "json", "xml", "fixed", "raise"])
def test_converters_agree(case):
    outs = []
    for P in BOTH:
        conv = _converter(P, case)
        try:
            fc = conv.convert(_converter_input(P, case))
            outs.append((_fc_state(fc), conv.errors, conv.error_reasons))
        except ValueError as e:
            outs.append(str(e))
    assert outs[0] == outs[1]
    if case == "validated":
        assert any(r.startswith("z-bounds") for r in outs[1][2])


def test_avro_and_dbapi_and_wkb_records_agree():
    outs = []
    for P in BOTH:
        fc = _points(P, 50)
        FS = P.conv.FieldSpec
        sft = P.pkg.FeatureType.from_spec("back", "name:String,score:Double,*geom:Point:srid=4326")
        conv = P.conv.Converter(sft, fmt="avro", id_field="$.__fid__", fields=[
            FS("name", "$.name"), FS("score", "$.score"), FS("geom", "geomFromWkb($.geom)")])
        a = conv.convert(io.BytesIO(P.avro.write_avro(fc)))
        conn = sqlite3.connect(":memory:")
        conn.execute("CREATE TABLE pts (name TEXT, lon REAL, lat REAL)")
        conn.executemany("INSERT INTO pts VALUES (?, ?, ?)",
                         [("a", 1.0, 2.0), ("b", -3.0, 4.5), ("c", 100.0, -45.0), ("d", None, 1.0)])
        dconv = P.conv.Converter(P.pkg.FeatureType.from_spec("db", "name:String,*geom:Point:srid=4326"),
                                 fields=[FS("name", "$1"), FS("geom", "point($2, $3)")], id_field="$1")
        d = dconv.convert_records(P.conv.dbapi_records(conn, "SELECT name, lon, lat FROM pts ORDER BY name"))
        conn.close()
        wconv = _converter(P, "wkb")
        geoms = _geometries(P)
        w = wconv.convert_records([[f"g{i}", P.geo.to_wkb(g)] for i, g in enumerate(geoms)] + [["bad", b"\x00"]])
        outs.append((_fc_state(a), _fc_state(d), dconv.errors, _fc_state(w), wconv.errors))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("header", [True, False])
def test_infer_schema_agrees(header):
    rows = [["id", "lon", "lat", "when", "count", "label"]] if header else []
    rng = np.random.default_rng(5)
    for i in range(30):
        rows.append([str(i), f"{rng.uniform(-50, 50):.3f}", f"{rng.uniform(-40, 40):.3f}",
                     f"2024-01-{1 + i % 28:02d}T00:00:00Z", str(i * 3), f"x{i}"])
    head, body = (rows[0], rows[1:]) if header else (None, rows)
    outs = []
    for P in BOTH:
        sft, conv = P.conv.infer_schema("inf", body, header=head)
        text = "\n".join(",".join(r) for r in body)
        fc = conv.convert(text)
        outs.append((sft.to_spec(), [(f.name, f.transform) for f in conv.fields], _fc_state(fc),
                     [P.conv._infer_kind(v) for v in (["1", "2"], ["1.5", "x"], ["2024-01-01"], ["1e3"])]))
    assert outs[0] == outs[1]
    for P in BOTH:
        with pytest.raises(ValueError):
            P.conv.infer_schema("x", [])


@pytest.mark.parametrize("spec", [None, "none", "index", "has-geo", "z-bounds,has-dtg", "has-geo,name",
                                  ["has-geo", "required:name"]])
def test_validators_agree(spec):
    outs = []
    for P in BOTH:
        sft = P.pkg.FeatureType.from_spec("v", "name:String,dtg:Date,*geom:Point:srid=4326")
        try:
            vals = P.val.parse_validators(spec, sft)
        except ValueError as e:
            outs.append(str(e))
            continue
        rows = [
            {"name": "a", "dtg": 1, "geom": P.geo.Point(1, 2)},
            {"name": "b", "dtg": None, "geom": P.geo.Point(1, 2)},
            {"name": "c", "dtg": 1, "geom": None},
            {"name": "d", "dtg": 1, "geom": P.geo.Point(181, 2)},
            {"name": "e", "dtg": 1, "geom": P.geo.Point(float("nan"), 2)},
            {"name": None, "dtg": 1, "geom": P.geo.Point(1, -90.5)},
        ]
        outs.append(([v.name for v in vals], [[v.validate(r) for v in vals] for r in rows],
                     _outcome(P.val.validator_spec, spec), _outcome(P.val.validator_spec, vals)))
    assert outs[0] == outs[1]


def test_zigzag_and_uvarint_agree():
    vals = [0, 1, -1, 2, -2, 63, -64, 2**31 - 1, -2**31, 2**62, -2**63, 2**63 - 1]
    vals += np.random.default_rng(6).integers(-2**63, 2**63 - 1, 200, dtype=np.int64).tolist()
    for v in vals:
        z = tvarint.zigzag(v)
        assert z == jvarint.zigzag(v)
        assert tvarint.unzigzag(z) == jvarint.unzigzag(z) == v
        a, b = bytearray(), bytearray()
        tvarint.append_uvarint(a, z)
        jvarint.append_uvarint(b, z)
        assert a == b and tvarint.read_uvarint(bytes(a), 0) == (z & (2**64 - 1), len(a))


# --------------------------------------------------------------------- BIN


@pytest.mark.parametrize("label", [False, True])
@pytest.mark.parametrize("sort", [False, True])
def test_bin_format_encode_decode_agree(label, sort):
    rng = np.random.default_rng(7)
    n = 500
    lon, lat = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    dtg = T0 + rng.integers(0, 30 * DAY, n)
    for track in (NAMES[np.arange(n) % len(NAMES)], np.arange(n) % 9, None):
        lab = np.array([f"label-{i}" for i in range(n)]) if label else None
        a = jbin.encode(lon, lat, dtg, track, lab, sort=sort)
        b = tbin.encode(lon, lat, dtg, track, lab, sort=sort)
        assert a == b and len(b) == n * (24 if label else 16)
        da, db = jbin.decode(a, label=label), tbin.decode(b, label=label)
        assert sorted(da) == sorted(db)
        for k in da:
            assert np.array_equal(da[k], db[k])
    assert np.array_equal(jbin.label_u64(np.arange(5)), tbin.label_u64(np.arange(5)))
    assert np.array_equal(jbin.track_ids(np.zeros(0, "U3")), tbin.track_ids(np.zeros(0, "U3")))


BIN_QUERIES = [
    "bbox(geom, -40, -30, 40, 30)",
    "bbox(geom, -170, -80, 170, 80) AND name = 'plain'",
    "INCLUDE",
    "bbox(geom, 100, 60, 101, 61)",
]


@pytest.mark.parametrize("kind", ["points", "polygons"])
@pytest.mark.parametrize("opts", [{}, {"track": "name"}, {"label": "name", "sort": True},
                                  {"track": "name", "label": "name"}, {"sort": True}])
def test_bin_query_bytes_equal_the_jax_package(kind, opts):
    outs = []
    for P in BOTH:
        fc = COLLECTIONS[kind](P, 2000) if kind == "points" else _polygons(P, 600)
        ds = P.pkg.DataStore(**P.kw)
        ds.create_schema(fc.sft)
        ds.write(fc.sft.name, fc)
        got = []
        for q in BIN_QUERIES:
            data = ds.bin_query(fc.sft.name, q, **opts)
            hits = ds.query(fc.sft.name, q)
            lon, lat = hits.representative_xy()
            track = hits.ids if "track" not in opts else hits.columns[opts["track"]]
            lab = hits.columns[opts["label"]] if "label" in opts else None
            assert data == P.bin.encode(lon, lat, hits.columns["dtg"], track, lab, sort=opts.get("sort", False))
            got.append(data)
        outs.append(got)
    assert outs[0] == outs[1]
    assert len(outs[1][2]) == (2000 if kind == "points" else 600) * (24 if "label" in opts else 16)


# ----------------------------------------------------------------- pyarrow


@pytest.mark.parametrize("kind", ["points", "polygons", "empty"])
@pytest.mark.parametrize("fmt", ["arrow", "parquet", "orc"])
def test_columnar_formats_agree(fmt, kind):
    pytest.importorskip("pyarrow")
    if fmt == "orc":
        pytest.importorskip("pyarrow.orc")
    from geomesa_tpu.io import arrow as jarrow
    from geomesa_tpu.io import orc as jorc
    from geomesa_tpu.io import parquet as jparquet
    from geomesa_tpu_torch.io import arrow as tarrow
    from geomesa_tpu_torch.io import orc as torc
    from geomesa_tpu_torch.io import parquet as tparquet

    reader = {"arrow": (jarrow.read_arrow, tarrow.read_arrow),
              "parquet": (jparquet.read_parquet, tparquet.read_parquet),
              "orc": (jorc.read_orc, torc.read_orc)}[fmt]
    payloads = [P.exp.export(COLLECTIONS[kind](P), fmt) for P in BOTH]
    assert payloads[0] == payloads[1]
    sfts = [COLLECTIONS[kind](P).sft for P in BOTH]
    _same_collection(reader[0](io.BytesIO(payloads[0]), sfts[0]), reader[1](io.BytesIO(payloads[1]), sfts[1]))


def test_arrow_streams_and_delta_writer_agree():
    pytest.importorskip("pyarrow")
    from geomesa_tpu.io import arrow as jarrow
    from geomesa_tpu_torch.io import arrow as tarrow

    fcs = [_points(P, 3000) for P in (JAX, PORT)]
    for kw in ({}, {"dictionary": False}, {"batch_rows": 512}):
        a, b = jarrow.arrow_stream(fcs[0], **kw), tarrow.arrow_stream(fcs[1], **kw)
        assert a == b
        assert jarrow.read_arrow_table(a).equals(tarrow.read_arrow_table(b))
    writers = [jarrow.ArrowDeltaWriter(fcs[0].sft, batch_rows=700), tarrow.ArrowDeltaWriter(fcs[1].sft, batch_rows=700)]
    for w, fc in zip(writers, fcs):
        for s in range(0, 3000, 1000):
            w.write(fc.take(np.arange(s, s + 1000)))
    a, b = writers[0].finish(), writers[1].finish()
    assert a == b
    _same_collection(jarrow.read_arrow(a, fcs[0].sft), tarrow.read_arrow(b, fcs[1].sft))


def test_parquet_pushdown_and_orc_storage_agree(tmp_path):
    pytest.importorskip("pyarrow")
    pytest.importorskip("pyarrow.orc")
    from geomesa_tpu.io import orc as jorc
    from geomesa_tpu.io import parquet as jparquet
    from geomesa_tpu_torch.io import orc as torc
    from geomesa_tpu_torch.io import parquet as tparquet

    outs = []
    for P, parquet, orc in ((JAX, jparquet, jorc), (PORT, tparquet, torc)):
        d = tmp_path / P.name
        d.mkdir()
        fc = _points(P, 2000)
        parquet.write_parquet(fc, d / "f.parquet")
        sub = parquet.read_parquet(d / "f.parquet", bbox=(-10, -10, 10, 10))
        st = orc.OrcStorage(str(d / "orc"))
        for s in range(0, 2000, 500):
            st.write(fc.take(np.arange(s, s + 500)))
        got = st.query(bbox=(-30, -20, 30, 20))
        outs.append((_fc_state(sub), _fc_state(got), [p.rsplit("/", 1)[-1] for p in st.files((-30, -20, 30, 20))]))
    assert outs[0] == outs[1]
