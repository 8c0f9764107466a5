"""Avro interop: feature batches as Avro Object Container Files.

Reference: geomesa-feature-avro (geomesa-features/
geomesa-feature-avro/src/main/scala/org/locationtech/geomesa/features/
avro/ — AvroSimpleFeatureTypeSchema, serialization/AvroUserDataSerializer)
writes features as Avro records: feature id in a reserved field, scalar
attributes as native Avro types, Date as timestamp-millis long, geometry
as WKB bytes. This module implements the same wire layout from scratch
(no avro wheel in the image): the Avro 1.x binary encoding (zigzag-varint
longs, length-prefixed bytes/strings, null-union index prefixes) and the
Object Container File framing (magic, metadata map with embedded JSON
schema, 16-byte sync marker, counted data blocks — Avro spec §
"Object Container Files"), codec null.

Per-row encode/decode is inherent to Avro's varint framing — this is an
interop boundary, not the scan hot path.
"""

from __future__ import annotations

import io
import json
import struct
from typing import IO

import numpy as np

from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.predicates import PointColumn
from geomesa_tpu_torch.io.varint import append_uvarint as _append_uvarint
from geomesa_tpu_torch.io.varint import read_uvarint as _read_uvarint
from geomesa_tpu_torch.io.varint import unzigzag as _unzigzag
from geomesa_tpu_torch.io.varint import zigzag as _zigzag
from geomesa_tpu_torch.sft import FeatureType

MAGIC = b"Obj\x01"
SYNC = bytes(range(16))  # deterministic marker: files are reproducible
FID_FIELD = "__fid__"  # reference AvroSimpleFeatureUtils.FEATURE_ID_AVRO_FIELD_NAME

_AVRO_TYPES = {
    "Integer": "int",
    "Int": "int",
    "Long": "long",
    "Float": "float",
    "Double": "double",
    "Boolean": "boolean",
    "String": "string",
    "UUID": "string",
    "Bytes": "bytes",
}


def schema_dict(sft: FeatureType) -> dict:
    """The Avro record schema for a feature type (geometry = WKB bytes,
    Date = timestamp-millis long; nullable attributes as null unions)."""
    fields = [{"name": FID_FIELD, "type": "string"}]
    for a in sft.attributes:
        if a.is_geometry:
            t: object = "bytes"
        elif a.type == "Date":
            t = {"type": "long", "logicalType": "timestamp-millis"}
        else:
            t = _AVRO_TYPES[a.type]
        fields.append({"name": a.name, "type": ["null", t]})
    return {
        "type": "record",
        "name": sft.name or "feature",
        "namespace": "org.geomesa.tpu",
        "fields": fields,
        # custom schema attribute naming the geometry field, so a reader
        # without the FeatureType can rebuild it unambiguously (the
        # reference stores the full sft spec in schema props the same way)
        "geomesa.geom": sft.geom_field,
    }


# ----------------------------------------------------------------- encode


def _write_long(out: io.BytesIO, n: int) -> None:
    buf = bytearray()
    _append_uvarint(buf, _zigzag(int(n)))
    out.write(bytes(buf))


def _write_bytes(out: io.BytesIO, b: bytes) -> None:
    _write_long(out, len(b))
    out.write(b)


def _write_str(out: io.BytesIO, s: str) -> None:
    _write_bytes(out, s.encode("utf-8"))


def _encoder_for(a) -> "tuple":
    """(union_branch_writer) for one attribute: returns a fn(out, value)."""
    if a.is_geometry:
        return lambda out, v: _write_bytes(out, geo.to_wkb(v))
    t = a.type
    if t == "Date":
        return lambda out, v: _write_long(out, int(v))
    if t in ("Integer", "Int", "Long"):
        return lambda out, v: _write_long(out, int(v))
    if t == "Float":
        return lambda out, v: out.write(struct.pack("<f", float(v)))
    if t == "Double":
        return lambda out, v: out.write(struct.pack("<d", float(v)))
    if t == "Boolean":
        return lambda out, v: out.write(b"\x01" if v else b"\x00")
    if t == "Bytes":
        return lambda out, v: _write_bytes(out, bytes(v))
    return lambda out, v: _write_str(out, str(v))


def write_avro(fc: FeatureCollection, fh: IO | None = None, block_rows: int = 4096) -> bytes:
    """Serialize a collection as an Avro Object Container File."""
    sft = fc.sft
    schema = schema_dict(sft)
    out = io.BytesIO()
    out.write(MAGIC)
    # file metadata map: one block of 2 entries, then end-of-blocks 0
    _write_long(out, 2)
    _write_str(out, "avro.schema")
    _write_bytes(out, json.dumps(schema).encode("utf-8"))
    _write_str(out, "avro.codec")
    _write_bytes(out, b"null")
    _write_long(out, 0)
    out.write(SYNC)

    encoders = [(a, _encoder_for(a)) for a in sft.attributes]
    geom_field = sft.geom_field
    ids = np.asarray(fc.ids, dtype=str)
    cols = {
        a.name: (fc.columns[a.name] if a.name != geom_field else fc.geom_column)
        for a in sft.attributes
    }
    point = isinstance(fc.geom_column, PointColumn)

    n = len(fc)
    for start in range(0, n, block_rows):
        stop = min(start + block_rows, n)
        body = io.BytesIO()
        for i in range(start, stop):
            _write_str(body, str(ids[i]))
            for a, enc in encoders:
                if a.name == geom_field:
                    g = (
                        geo.Point(float(cols[a.name].x[i]), float(cols[a.name].y[i]))
                        if point
                        else cols[a.name].geometry(i)
                    )
                    _write_long(body, 1)  # union branch 1 = value
                    _write_bytes(body, geo.to_wkb(g))
                    continue
                v = cols[a.name][i]
                if v is None or (isinstance(v, float) and np.isnan(v) and a.type == "String"):
                    _write_long(body, 0)  # union branch 0 = null
                else:
                    _write_long(body, 1)
                    enc(body, v)
        payload = body.getvalue()
        _write_long(out, stop - start)
        _write_long(out, len(payload))
        out.write(payload)
        out.write(SYNC)

    data = out.getvalue()
    if fh is not None:
        fh.write(data)
    return data


# ----------------------------------------------------------------- decode


def _block_count(r: "_Reader") -> int:
    """Data-block row count; a negative count (spec: skippable blocks)
    carries abs(count) rows preceded by a byte size."""
    n = r.read_long()
    if n < 0:
        r.read_long()  # block byte size
        return -n
    r.read_long()  # serialized size
    return n

class _Reader:
    def __init__(self, data: bytes):
        self.b = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        out = self.b[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("truncated avro file")
        self.pos += n
        return out

    def read_long(self) -> int:
        acc, self.pos = _read_uvarint(self.b, self.pos)
        return _unzigzag(acc)

    def read_bytes(self) -> bytes:
        return self.read(self.read_long())

    def read_str(self) -> str:
        return self.read_bytes().decode("utf-8")


def _decoder_for(avro_type) -> "object":
    """Value decoder for the schema subset write_avro emits."""
    if isinstance(avro_type, dict):
        avro_type = avro_type["type"]
    try:
        return {
            "string": _Reader.read_str,
            "bytes": _Reader.read_bytes,
            "int": _Reader.read_long,
            "long": _Reader.read_long,
            "float": lambda r: struct.unpack("<f", r.read(4))[0],
            "double": lambda r: struct.unpack("<d", r.read(8))[0],
            "boolean": lambda r: r.read(1) == b"\x01",
        }[avro_type]
    except KeyError:
        raise ValueError(f"unsupported avro type {avro_type!r}") from None


def _field_decoder(avro_type):
    """(decode fn(_Reader) -> value | None) for a field type, handling
    unions in any branch order: the union index picks the branch, null
    branches decode to None (Avro spec: unions encode a long index then
    the value)."""
    if isinstance(avro_type, list):
        branches = [
            None if b == "null" else _decoder_for(b) for b in avro_type
        ]

        def dec(r):
            i = r.read_long()
            if not 0 <= i < len(branches):
                raise ValueError(f"union index {i} out of range")
            b = branches[i]
            return None if b is None else b(r)

        return dec
    return _decoder_for(avro_type)


def _union_value_type(t):
    """The non-null type of a field declaration (union or plain)."""
    if isinstance(t, list):
        vals = [b for b in t if b != "null"]
        if len(vals) != 1:
            raise ValueError(f"unsupported multi-type union {t!r}")
        return vals[0]
    return t


def read_avro(data: "bytes | IO", sft: FeatureType | None = None) -> FeatureCollection:
    """Parse an Object Container File produced by ``write_avro`` (or any
    writer of the same schema subset) back into a FeatureCollection.

    ``sft``: target feature type; when None, a type is rebuilt from the
    embedded schema (geometry comes back as the generic ``Geometry`` type).
    """
    if hasattr(data, "read"):
        data = data.read()
    r = _Reader(bytes(data))
    if r.read(4) != MAGIC:
        raise ValueError("not an avro object container file")
    meta: dict = {}
    while True:
        count = r.read_long()
        if count == 0:
            break
        if count < 0:  # spec: negative count precedes a byte size
            r.read_long()
            count = -count
        for _ in range(count):
            key = r.read_str()
            meta[key] = r.read_bytes()
    codec = meta.get("avro.codec", b"null")
    if codec not in (b"null", b""):
        raise ValueError(f"unsupported avro codec {codec!r}")
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    sync = r.read(16)

    fields = schema["fields"]
    if fields[0]["name"] != FID_FIELD:
        raise ValueError(
            f"expected leading {FID_FIELD!r} feature-id field, got {fields[0]['name']!r}"
        )
    if sft is None:
        sft = _sft_from_schema(schema)
    geom_field = sft.geom_field

    decoders = [(f["name"], _field_decoder(f["type"])) for f in fields[1:]]

    ids: list = []
    rows: list = []
    while r.pos < len(r.b):
        n_rows = _block_count(r)
        for _ in range(n_rows):
            ids.append(r.read_str())
            row = {}
            for name, dec in decoders:
                v = dec(r)
                if v is not None and name == geom_field:
                    v = geo.from_wkb(v)
                row[name] = v
            rows.append(row)
        if r.read(16) != sync:
            raise ValueError("sync marker mismatch: corrupt avro block")
    return FeatureCollection.from_rows(sft, rows, ids=ids)


def read_records(data: "bytes | IO"):
    """(schema dict, list of plain-dict records) from a container file —
    the generic record view for the Avro ingest converter (reference
    geomesa-convert-avro): geometry/bytes values stay raw ``bytes``, the
    feature id is under ``__fid__``."""
    if hasattr(data, "read"):
        data = data.read()
    r = _Reader(bytes(data))
    if r.read(4) != MAGIC:
        raise ValueError("not an avro object container file")
    meta: dict = {}
    while True:
        count = r.read_long()
        if count == 0:
            break
        if count < 0:
            r.read_long()
            count = -count
        for _ in range(count):
            key = r.read_str()
            meta[key] = r.read_bytes()
    if meta.get("avro.codec", b"null") not in (b"null", b""):
        raise ValueError("unsupported avro codec")
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    sync = r.read(16)
    decoders = [(f["name"], _field_decoder(f["type"])) for f in schema["fields"]]
    records = []
    while r.pos < len(r.b):
        n_rows = _block_count(r)
        for _ in range(n_rows):
            records.append({name: dec(r) for name, dec in decoders})
        if r.read(16) != sync:
            raise ValueError("sync marker mismatch: corrupt avro block")
    return schema, records


def _sft_from_schema(schema: dict) -> FeatureType:
    """Rebuild a FeatureType from the embedded Avro schema."""
    rev = {v: k for k, v in _AVRO_TYPES.items() if k not in ("Int", "UUID")}
    geom_name = schema.get("geomesa.geom")
    bytes_fields = [
        f["name"]
        for f in schema["fields"][1:]
        if _union_value_type(f["type"]) == "bytes"
    ]
    if geom_name is None and len(bytes_fields) == 1:
        geom_name = bytes_fields[0]  # unambiguous: the geomesa layout uses
        # bytes for WKB geometry
    if geom_name is None and bytes_fields:
        raise ValueError(
            "schema has multiple bytes fields and no geomesa.geom marker: "
            "pass the FeatureType explicitly"
        )
    parts = []
    for f in schema["fields"][1:]:
        t = _union_value_type(f["type"])
        if f["name"] == geom_name:
            parts.append(f"*{f['name']}:Geometry:srid=4326")
        elif isinstance(t, dict) and t.get("logicalType") == "timestamp-millis":
            parts.append(f"{f['name']}:Date")
        else:
            parts.append(f"{f['name']}:{rev[t]}")
    return FeatureType.from_spec(schema.get("name", "feature"), ",".join(parts))
