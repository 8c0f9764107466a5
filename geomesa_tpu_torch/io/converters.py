"""Ingest converters: config-driven parsing of delimited text and JSON
into feature batches.

The port's copy of geomesa_tpu/io/converters.py. Reference:
geomesa-convert (geomesa-convert/geomesa-convert-common/src/main/scala/
org/locationtech/geomesa/convert2/SimpleFeatureConverter.scala:28, transforms/Expression.scala,
TypeInference.scala). The reference's HOCON config + expression DSL maps
to a Converter built from field specs using the same expression shapes:

    $1                      column reference (1-based, $0 = whole record)
    $1::int  $2::double     casts (::int ::long ::double ::string)
    point($1, $2)           geometry constructors (also geomFromWkt($1))
    datetime($3)            ISO-8601 -> epoch millis
    concat($1, '-', $2)     string concat; 'lit' literals
    md5($1) / uuid()        id functions

JSON records address fields with $.a.b paths instead of $N.
Type inference (``infer_schema``) mirrors TypeInference: trial-parse
columns as int -> double -> date -> string, geometry from lon/lat pairs.
"""

from __future__ import annotations

import csv as _csv
import hashlib
import io
import json
import re
import uuid as _uuid
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.sft import FeatureType

# -- expression DSL ------------------------------------------------------

_TOKEN = re.compile(
    r"\s*(?:(?P<col>\$\d+)|(?P<path>\$(?:\.@?\w+)+)|(?P<name>\w+)\s*\(|(?P<lit>'[^']*')"
    r"|(?P<num>-?\d+(?:\.\d+)?)|(?P<ident>\w+)|(?P<close>\))|(?P<comma>,)|(?P<cast>::\w+))"
)


@dataclass
class Expression:
    """A compiled field expression: record -> value."""

    fn: Callable
    text: str

    def __call__(self, rec):
        return self.fn(rec)


def _get_path(rec, path: Sequence[str]):
    cur = rec
    for p in path:
        if cur is None:
            return None
        cur = cur.get(p) if isinstance(cur, dict) else None
    return cur


_CASTS = {
    "int": lambda v: int(float(v)),
    "long": lambda v: int(float(v)),
    "float": float,
    "double": float,
    "string": str,
}


def _compile_fns(name: str, args: list):
    if name == "point":
        return lambda rec: geo.Point(float(args[0](rec)), float(args[1](rec)))
    if name in ("geomfromwkt", "geometry"):
        return lambda rec: geo.from_wkt(str(args[0](rec)))
    if name == "geomfromwkb":
        return lambda rec: geo.from_wkb(args[0](rec))
    if name in ("datetime", "date", "isodate"):
        from geomesa_tpu_torch.filter.ecql import parse_dt_millis

        return lambda rec: parse_dt_millis(str(args[0](rec)))
    if name == "millisecondstodate":
        return lambda rec: int(args[0](rec))
    if name == "concat":
        return lambda rec: "".join(str(a(rec)) for a in args)
    if name in ("tolowercase", "lowercase"):
        return lambda rec: str(args[0](rec)).lower()
    if name in ("touppercase", "uppercase"):
        return lambda rec: str(args[0](rec)).upper()
    if name == "trim":
        return lambda rec: str(args[0](rec)).strip()
    if name == "md5":
        return lambda rec: hashlib.md5(str(args[0](rec)).encode()).hexdigest()
    if name == "uuid":
        return lambda rec: str(_uuid.uuid4())
    if name.startswith("st_"):
        # the ST_ function library (sql.functions) is shared with query
        # transforms: st_x(geom), st_buffer(geom, 1), ... evaluate over
        # the record's geometry values
        from geomesa_tpu_torch.sql.functions import FUNCTIONS

        fn = FUNCTIONS.get(name)
        if fn is not None:
            return lambda rec: fn(*(a(rec) for a in args))
    raise ValueError(f"unknown transform function {name!r}")


def compile_expression(text: str) -> Expression:
    """Compile one expression string into a callable."""
    pos = 0

    def parse() -> Callable:
        nonlocal pos
        m = _TOKEN.match(text, pos)
        if m is None:
            raise ValueError(f"bad expression at {text[pos:]!r}")
        pos = m.end()
        if m.group("col"):
            idx = int(m.group("col")[1:])
            base = (lambda rec: rec[idx - 1]) if idx > 0 else (lambda rec: rec)
        elif m.group("path"):
            path = m.group("path")[2:].split(".")
            base = lambda rec: _get_path(rec, path)
        elif m.group("lit"):
            v = m.group("lit")[1:-1]
            base = lambda rec: v
        elif m.group("num"):
            v = float(m.group("num")) if "." in m.group("num") else int(m.group("num"))
            base = lambda rec: v
        elif m.group("ident"):
            # bare identifier: a record-field reference by name (query
            # transforms evaluate over {attribute: value} row dicts).
            # Unknown names raise — a typo must not fabricate a column
            key = m.group("ident")

            def _field(rec, key=key):
                if isinstance(rec, dict):
                    if key not in rec:
                        raise KeyError(f"unknown field {key!r} in expression")
                    return rec[key]
                raise ValueError(
                    f"bare identifier {key!r} needs a named record; use "
                    "$N for positional fields"
                )

            base = _field
        elif m.group("name"):
            fname = m.group("name").lower()
            args: list = []
            while True:
                m2 = _TOKEN.match(text, pos)
                if m2 and m2.group("close"):
                    pos = m2.end()
                    break
                args.append(parse())
                m3 = _TOKEN.match(text, pos)
                if m3 and m3.group("comma"):
                    pos = m3.end()
                elif m3 and m3.group("close"):
                    pos = m3.end()
                    break
                else:
                    raise ValueError(f"expected , or ) at {text[pos:]!r}")
            base = _compile_fns(fname, args)
        else:
            raise ValueError(f"bad expression at {text[pos:]!r}")
        # optional cast suffix
        m4 = _TOKEN.match(text, pos)
        if m4 and m4.group("cast"):
            pos = m4.end()
            cast = _CASTS.get(m4.group("cast")[2:].lower())
            if cast is None:
                raise ValueError(f"unknown cast {m4.group('cast')!r}")
            inner = base
            base = lambda rec: cast(inner(rec))
        return base

    fn = parse()
    if pos != len(text) and text[pos:].strip():
        raise ValueError(f"trailing input in expression: {text[pos:]!r}")
    return Expression(fn, text)


# -- converter -----------------------------------------------------------

@dataclass
class FieldSpec:
    name: str
    transform: str  # expression string


@dataclass
class Converter:
    """Config-driven converter: parse records, evaluate field expressions,
    emit a FeatureCollection (reference SimpleFeatureConverter.process)."""

    sft: FeatureType
    fields: Sequence[FieldSpec]
    id_field: str | None = None  # expression; None = running index
    fmt: str = "delimited"  # "delimited" | "json" | "xml" | "fixed-width"
    delimiter: str = ","
    skip_lines: int = 0  # header rows to drop (delimited / fixed-width)
    drop_errors: bool = True  # skip unparseable/invalid records vs raise
    # converted-row validation (the reference CqlValidatorFactory hook;
    # io.validators): a spec string ("index", "has-geo,z-bounds", ...),
    # a sequence of names/Validator objects, or None. Failures count per
    # reason in ``error_reasons`` and follow ``drop_errors`` skip/raise.
    validators: "str | Sequence | None" = None
    # xml: tag of the per-feature element (reference geomesa-convert-xml
    # featurePath); fields address the element tree with $.child.grandchild
    # paths, attributes as @name segments ($.pos.@lat)
    xml_feature_tag: str | None = None
    # fixed-width: (start, width) character slices per column (reference
    # geomesa-convert-fixedwidth FixedWidthConverter); $N addresses the
    # N-th slice, stripped
    fixed_widths: Sequence[tuple[int, int]] | None = None

    def __post_init__(self):
        from geomesa_tpu_torch.io.validators import parse_validators

        self._exprs = [(f.name, compile_expression(f.transform)) for f in self.fields]
        self._id_expr = compile_expression(self.id_field) if self.id_field else None
        self._validators = parse_validators(self.validators, self.sft)
        self.errors = 0
        self.error_reasons: dict = {}

    def convert(self, data: "str | bytes | io.IOBase") -> FeatureCollection:
        if self.fmt == "avro":  # binary format: never decode
            if hasattr(data, "read"):
                data = data.read()
        else:
            if isinstance(data, bytes):
                data = data.decode("utf-8")
            if not isinstance(data, str):
                data = data.read()
                if isinstance(data, bytes):
                    data = data.decode("utf-8")
        return self.convert_records(self._parse(data))

    def convert_records(self, records) -> FeatureCollection:
        """Convert an iterable of already-parsed records (lists for $N
        expressions, dicts for $.path expressions). The entry point for
        externally-sourced records — e.g. DB-API rows via
        :func:`dbapi_records` (the geomesa-convert-jdbc analogue)."""
        rows = []
        ids = []
        self.errors = 0
        self.error_reasons = {}

        def reject(reason: str) -> None:
            self.errors += 1
            self.error_reasons[reason] = self.error_reasons.get(reason, 0) + 1

        for i, rec in enumerate(records):
            try:
                row = {name: expr(rec) for name, expr in self._exprs}
                rid = str(self._id_expr(rec)) if self._id_expr else str(i)
            except Exception:
                if self.drop_errors:
                    reject("parse")
                    continue
                raise
            failed = None
            for v in self._validators:
                reason = v.validate(row)
                if reason is not None:
                    failed = f"{v.name}: {reason}"
                    break
            if failed is not None:
                if self.drop_errors:
                    reject(failed)
                    continue
                raise ValueError(f"validation failed ({failed}): record {i}")
            rows.append(row)
            ids.append(rid)
        return FeatureCollection.from_rows(self.sft, rows, ids=ids)

    def _parse(self, data: str):
        if self.fmt == "delimited":
            reader = _csv.reader(io.StringIO(data), delimiter=self.delimiter)
            for i, rec in enumerate(reader):
                if i < self.skip_lines or not rec:
                    continue
                yield rec
        elif self.fmt == "fixed-width":
            if not self.fixed_widths:
                raise ValueError("fixed-width converter requires fixed_widths")
            for i, line in enumerate(io.StringIO(data)):
                line = line.rstrip("\n")
                if i < self.skip_lines or not line.strip():
                    continue
                yield [line[s : s + w].strip() for s, w in self.fixed_widths]
        elif self.fmt == "json":
            doc = json.loads(data)
            if isinstance(doc, dict):
                doc = [doc]
            yield from doc
        elif self.fmt == "avro":
            from geomesa_tpu_torch.io.avro import read_records

            _, records = read_records(data)
            yield from records
        elif self.fmt == "xml":
            import xml.etree.ElementTree as ET

            if self.xml_feature_tag is None:
                raise ValueError("xml converter requires xml_feature_tag")
            root = ET.fromstring(data)
            elems = (
                [root]
                if _local(root.tag) == self.xml_feature_tag
                else [
                    e for e in root.iter() if _local(e.tag) == self.xml_feature_tag
                ]
            )
            for e in elems:
                yield _elem_to_dict(e)
        else:
            raise ValueError(f"unknown converter format {self.fmt!r}")


# -- xml record shaping --------------------------------------------------


def _local(tag: str) -> str:
    """Element tag without its namespace ({uri}tag -> tag)."""
    return tag.rsplit("}", 1)[-1]


def _elem_to_dict(e) -> dict:
    """An XML element as a nested dict the $.path expressions can address:
    attributes under '@name', leaf children under their tag (text), nested
    children recurse; the first occurrence of a repeated tag wins (the
    reference's xpath configs select explicitly — this covers the common
    record-per-element shape)."""
    out: dict = {f"@{k}": v for k, v in e.attrib.items()}
    for c in e:
        tag = _local(c.tag)
        if tag in out:
            continue
        out[tag] = _elem_to_dict(c) if (len(c) or c.attrib) else (c.text or "").strip()
    if not out and e.text:
        return e.text.strip()
    return out


# -- type inference ------------------------------------------------------

def infer_schema(
    name: str,
    rows: Sequence[Sequence[str]],
    header: Sequence[str] | None = None,
) -> tuple[FeatureType, Converter]:
    """Infer a schema + converter from delimited sample rows (reference
    TypeInference.scala): trial-parse int -> double -> date -> string;
    adjacent lon/lat-range double columns become the point geometry."""
    if not rows:
        raise ValueError("no sample rows")
    n_cols = len(rows[0])
    names = list(header) if header else [f"col{i}" for i in range(n_cols)]
    kinds = []
    for c in range(n_cols):
        vals = [r[c] for r in rows if len(r) > c]
        kinds.append(_infer_kind(vals))
    # geometry: a name-hinted (lon, lat) numeric pair wins; otherwise the
    # first adjacent in-range Double pair (rows may be ragged; only rows
    # long enough vote). Int-only pairs need the name hint — bare small-int
    # columns (counts, ages) would false-positive on the range test.
    lon_names = {"lon", "long", "longitude", "x"}
    lat_names = {"lat", "latitude", "y"}

    def in_range(c) -> bool:
        full = [r for r in rows if len(r) > c + 1]
        if not full:
            return False
        xs = np.array([float(r[c]) for r in full])
        ys = np.array([float(r[c + 1]) for r in full])
        return bool((np.abs(xs) <= 180).all() and (np.abs(ys) <= 90).all())

    geom_pair = None
    for c in range(n_cols - 1):
        if (
            names[c].lower() in lon_names
            and names[c + 1].lower() in lat_names
            and kinds[c] in ("Int", "Double")
            and kinds[c + 1] in ("Int", "Double")
            and in_range(c)
        ):
            geom_pair = c
            break
    if geom_pair is None:
        for c in range(n_cols - 1):
            if kinds[c] == "Double" and kinds[c + 1] == "Double" and in_range(c):
                geom_pair = c
                break
    parts = []
    fields = []
    for c in range(n_cols):
        if geom_pair is not None and c == geom_pair:
            parts.append("*geom:Point:srid=4326")
            fields.append(FieldSpec("geom", f"point(${c + 1}, ${c + 2})"))
            continue
        if geom_pair is not None and c == geom_pair + 1:
            continue
        t = kinds[c]
        spec_t = {"Int": "Integer", "Double": "Double", "Date": "Date"}.get(t, "String")
        parts.append(f"{names[c]}:{spec_t}")
        cast = {"Int": "::int", "Double": "::double"}.get(t, "")
        expr = f"datetime(${c + 1})" if t == "Date" else f"${c + 1}{cast}"
        fields.append(FieldSpec(names[c], expr))
    sft = FeatureType.from_spec(name, ",".join(parts))
    return sft, Converter(sft=sft, fields=fields)


_DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}([T ]\d{2}:\d{2}(:\d{2})?(\.\d+)?Z?)?$")


def _infer_kind(vals: Sequence[str]) -> str:
    def all_match(fn) -> bool:
        try:
            for v in vals:
                fn(v)
            return True
        except (ValueError, TypeError):
            return False

    if all_match(int):
        return "Int"
    if all_match(float):
        return "Double"
    if all(_DATE_RE.match(str(v)) for v in vals):
        return "Date"
    return "String"


# -- database records (geomesa-convert-jdbc analogue) --------------------

def dbapi_records(conn, sql: str, params=()):
    """Rows of a DB-API 2.0 query as converter records: each row yields
    ``[rowvals...]`` addressable as $1..$N ($0 is the whole row), matching
    the reference's JDBC converter column addressing
    (geomesa-convert-jdbc/.../JdbcConverter.scala: statement.executeQuery,
    fields reference columns by index). Works with any DB-API module
    (sqlite3 in the standard library).

        conv = Converter(sft, fields=[FieldSpec("name", "$1"), ...])
        fc = conv.convert_records(dbapi_records(conn, "SELECT ..."))
    """
    cur = conn.cursor()
    try:
        cur.execute(sql, params)
        while True:
            batch = cur.fetchmany(10_000)
            if not batch:
                break
            for row in batch:
                yield list(row)  # $1 = first column, $0 = whole row
    finally:
        cur.close()
