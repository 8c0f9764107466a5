"""The converters' expression DSL, as query transforms read it.

The port's copy of the expression part of geomesa_tpu/io/converters.py
(reference geomesa-convert transforms/Expression.scala): one expression
string compiles to a callable over a record. ``FeatureCollection.transform``
evaluates ``name=expr`` specs with it over {attribute: value} row dicts.

    $1                      column reference (1-based, $0 = whole record)
    $1::int  $2::double     casts (::int ::long ::double ::string)
    point($1, $2)           geometry constructors (also geomFromWkt($1))
    datetime($3)            ISO-8601 -> epoch millis
    concat($1, '-', $2)     string concat; 'lit' literals
    md5($1) / uuid()        id functions
    st_x(geom)              the ST_ functions of sql.functions

The converters themselves (delimited text, JSON, XML readers and type
inference) and ``geomFromWkb`` (the port's geometry has no WKB codec) are
not ported yet.
"""

from __future__ import annotations

import hashlib
import re
import uuid as _uuid
from dataclasses import dataclass
from typing import Callable, Sequence

from geomesa_tpu_torch import geometry as geo

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
