"""SQL front-end: SELECT over a DataStore with ST_ predicate push-down.

Reference: the Spark SQL relation tier — GeoMesaRelation binds a
GeoMesa-indexed store into SQL, and SQLRules rewrites Catalyst ST_
predicates into GeoTools filters pushed into the relation scan
(geomesa-spark/geomesa-spark-sql/.../GeoMesaRelation.scala:
46-120, SQLRules.scala scalaUDFtoGTFilter). The analogue here compiles a
small SELECT dialect straight onto the query planner:

    SELECT name, st_x(geom) AS lon
    FROM   pts
    WHERE  st_intersects(geom, st_geomfromwkt('POLYGON((...))'))
           AND name LIKE 'a%' ORDER BY name LIMIT 10

- WHERE terms that map to index-servable predicates (st_intersects /
  st_contains / st_within / st_dwithin / st_bbox with a constant
  geometry, plus scalar comparisons) PUSH DOWN into the planner — they
  ride the z/xz/attribute indexes and the device kernels;
- anything else (st_area(geom) > 2, arbitrary ST_ calls) stays a
  RESIDUAL evaluated per row after the scan, like Spark evaluating a
  non-pushable predicate above the relation;
- the select list reuses the query-transform expression engine
  (FeatureCollection.transform): renames, casts, ST_ accessors.

The port's copy of geomesa_tpu/sql/query.py,
held to it by the CPU parity tests.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.filter.predicates import (
    And, Between, Cmp, DWithin, Filter, In, Include, Intersects, IsNull,
    Like, Not, Or, Within,
)

_TOKEN = re.compile(
    r"\s*(?:(?P<str>'(?:[^']|'')*')|(?P<num>-?\d+(?:\.\d+)?)"
    r"|(?P<word>[A-Za-z_]\w*)|(?P<op><=|>=|<>|!=|=|<|>)"
    r"|(?P<punct>[(),.*])|(?P<cast>::\w+))"
)

_KEYWORDS = {
    "SELECT", "FROM", "WHERE", "ORDER", "BY", "LIMIT", "OFFSET", "AND",
    "OR", "NOT", "AS", "ASC", "DESC", "BETWEEN", "IN", "LIKE", "IS",
    "NULL",
}


@dataclass
class _Tok:
    kind: str
    value: object


def _lex(text: str) -> list[_Tok]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            if text[pos:].strip():
                raise ValueError(f"bad SQL at {text[pos:]!r}")
            break
        pos = m.end()
        if m.group("str") is not None:
            out.append(_Tok("str", m.group("str")[1:-1].replace("''", "'")))
        elif m.group("num") is not None:
            v = m.group("num")
            out.append(_Tok("num", float(v) if "." in v else int(v)))
        elif m.group("word") is not None:
            w = m.group("word")
            out.append(
                _Tok("kw", w.upper()) if w.upper() in _KEYWORDS
                else _Tok("word", w)
            )
        elif m.group("op") is not None:
            out.append(_Tok("op", m.group("op")))
        elif m.group("cast") is not None:
            out.append(_Tok("cast", m.group("cast")))
        else:
            out.append(_Tok("punct", m.group("punct")))
    return out


class _Parser:
    def __init__(self, text: str):
        self.toks = _lex(text)
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of SQL")
        self.i += 1
        return t

    def accept(self, kind, value=None):
        t = self.peek()
        if t is not None and t.kind == kind and (value is None or t.value == value):
            self.i += 1
            return t
        return None

    def expect(self, kind, value=None):
        t = self.accept(kind, value)
        if t is None:
            raise ValueError(f"expected {value or kind} at token {self.peek()}")
        return t

    # -- expression source reconstruction (for the transform engine) ----
    def _expr_text(self) -> str:
        """Consume one select-list expression, returning its source-ish
        text (balanced parens; stops at , FROM AS)."""
        parts = []
        depth = 0
        while True:
            t = self.peek()
            if t is None:
                break
            if depth == 0 and (
                (t.kind == "punct" and t.value == ",")
                or (t.kind == "kw" and t.value in ("FROM", "AS"))
            ):
                break
            t = self.next()
            if t.kind == "punct" and t.value == "(":
                depth += 1
                parts.append("(")
            elif t.kind == "punct" and t.value == ")":
                depth -= 1
                parts.append(")")
            elif t.kind == "str":
                parts.append("'" + str(t.value).replace("'", "''") + "'")
            elif t.kind == "punct" and t.value == ",":
                parts.append(", ")
            elif t.kind == "cast":
                parts.append(str(t.value))
            else:
                parts.append(str(t.value))
        return "".join(parts).strip()

    # -- WHERE grammar --------------------------------------------------
    def or_expr(self):
        parts = [self.and_expr()]
        while self.accept("kw", "OR"):
            parts.append(self.and_expr())
        return parts[0] if len(parts) == 1 else ("or", parts)

    def and_expr(self):
        parts = [self.not_expr()]
        while self.accept("kw", "AND"):
            parts.append(self.not_expr())
        return parts[0] if len(parts) == 1 else ("and", parts)

    def not_expr(self):
        if self.accept("kw", "NOT"):
            return ("not", self.not_expr())
        if self.accept("punct", "("):
            e = self.or_expr()
            self.expect("punct", ")")
            return e
        return self.predicate()

    def predicate(self):
        """One comparison / function predicate, as an AST tuple."""
        left = self.value()
        t = self.peek()
        if t is not None and t.kind == "op":
            op = self.next().value
            return ("cmp", op, left, self.value())
        if t is not None and t.kind == "kw":
            if t.value == "BETWEEN":
                self.next()
                lo = self.value()
                self.expect("kw", "AND")
                return ("between", left, lo, self.value())
            if t.value == "IN":
                self.next()
                self.expect("punct", "(")
                vals = [self.value()]
                while self.accept("punct", ","):
                    vals.append(self.value())
                self.expect("punct", ")")
                return ("in", left, vals)
            if t.value == "LIKE":
                self.next()
                return ("like", left, self.value())
            if t.value == "IS":
                self.next()
                neg = self.accept("kw", "NOT") is not None
                self.expect("kw", "NULL")
                return ("not", ("isnull", left)) if neg else ("isnull", left)
            if t.value == "NOT":  # x NOT IN / NOT LIKE / NOT BETWEEN
                self.next()
                inner = self.predicate_tail(left)
                return ("not", inner)
        # bare boolean function call, e.g. st_intersects(...)
        return ("bool", left)

    def predicate_tail(self, left):
        t = self.next()
        if t.kind == "kw" and t.value == "IN":
            self.expect("punct", "(")
            vals = [self.value()]
            while self.accept("punct", ","):
                vals.append(self.value())
            self.expect("punct", ")")
            return ("in", left, vals)
        if t.kind == "kw" and t.value == "LIKE":
            return ("like", left, self.value())
        if t.kind == "kw" and t.value == "BETWEEN":
            lo = self.value()
            self.expect("kw", "AND")
            return ("between", left, lo, self.value())
        raise ValueError(f"unexpected NOT {t}")

    def value(self):
        """A scalar/function value: ('col', name) | ('lit', v) |
        ('call', name, [args])."""
        t = self.next()
        if t.kind == "str" or t.kind == "num":
            return ("lit", t.value)
        if t.kind == "kw" and t.value == "NULL":
            return ("lit", None)
        if t.kind == "word":
            if self.accept("punct", "("):
                args = []
                if not self.accept("punct", ")"):
                    args.append(self.value())
                    while self.accept("punct", ","):
                        args.append(self.value())
                    self.expect("punct", ")")
                return ("call", t.value.lower(), args)
            return ("col", t.value)
        raise ValueError(f"unexpected token {t} in expression")


def _const_value(node):
    """Evaluate a constant AST node (literals and ST_ constructor calls
    with constant args) -> python value, or raise KeyError when the node
    references a column."""
    kind = node[0]
    if kind == "lit":
        return node[1]
    if kind == "col":
        raise KeyError(node[1])
    if kind == "call":
        from geomesa_tpu_torch.sql.functions import FUNCTIONS

        fn = FUNCTIONS.get(node[1])
        if fn is None:
            raise KeyError(node[1])
        return fn(*[_const_value(a) for a in node[2]])
    raise KeyError(str(node))


def _is_geom_col(node, sft) -> bool:
    return (
        node[0] == "col"
        and sft.has(node[1])
        and sft.attr(node[1]).is_geometry
    )


_SPATIAL = {"st_intersects", "st_contains", "st_within", "st_dwithin", "st_bbox"}


def _compile_term(node, sft):
    """AST -> (Filter, residual_text): pushable terms become planner
    Filters; non-pushable return (None, source-text) for row-wise
    evaluation. Mirrors SQLRules.scalaUDFtoGTFilter: only (column,
    constant-geometry) shapes push down."""
    kind = node[0]
    if kind == "and":
        subs = [_compile_term(c, sft) for c in node[1]]
        filters = [f for f, _ in subs if f is not None]
        residuals = [t for _, r in subs if r is not None for t in r]
        f = And(filters) if len(filters) > 1 else (filters[0] if filters else None)
        return f, residuals or None
    if kind in ("or", "not"):
        # OR / NOT push down only when EVERY branch pushes down (a mixed
        # OR cannot split into filter + residual soundly)
        try:
            return _compile_bool(node, sft), None
        except _NotPushable:
            return None, [_ast_text(node)]
    try:
        return _compile_bool(node, sft), None
    except _NotPushable:
        return None, [_ast_text(node)]


class _NotPushable(Exception):
    pass


def _compile_bool(node, sft) -> Filter:
    kind = node[0]
    if kind == "and":
        return And([_compile_bool(c, sft) for c in node[1]])
    if kind == "or":
        return Or([_compile_bool(c, sft) for c in node[1]])
    if kind == "not":
        return Not(_compile_bool(node[1], sft))
    if kind == "bool":
        return _spatial_filter(node[1], sft)
    if kind == "cmp":
        op, left, right = node[1], node[2], node[3]
        if left[0] == "col" and sft.has(left[1]) and not sft.attr(left[1]).is_geometry:
            try:
                v = _const_value(right)
            except KeyError:
                raise _NotPushable()
            if op in ("<>", "!="):
                return Not(Cmp(left[1], "=", v))
            return Cmp(left[1], op, v)
        # literal <op> column flips
        if right[0] == "col" and sft.has(right[1]):
            flip = {"<": ">", ">": "<", "<=": ">=", ">=": "<=", "=": "=",
                    "<>": "<>", "!=": "!="}
            return _compile_bool(("cmp", flip[op], right, left), sft)
        raise _NotPushable()
    if kind == "between":
        left, lo, hi = node[1], node[2], node[3]
        if left[0] == "col" and sft.has(left[1]):
            try:
                return Between(left[1], _const_value(lo), _const_value(hi))
            except KeyError:
                raise _NotPushable()
        raise _NotPushable()
    if kind == "in":
        left, vals = node[1], node[2]
        if left[0] == "col" and sft.has(left[1]):
            try:
                return In(left[1], tuple(_const_value(v) for v in vals))
            except KeyError:
                raise _NotPushable()
        raise _NotPushable()
    if kind == "like":
        left, pat = node[1], node[2]
        if left[0] == "col" and sft.has(left[1]) and pat[0] == "lit":
            return Like(left[1], str(pat[1]))
        raise _NotPushable()
    if kind == "isnull":
        left = node[1]
        if left[0] == "col" and sft.has(left[1]):
            return IsNull(left[1])
        raise _NotPushable()
    raise _NotPushable()


def _spatial_filter(call, sft) -> Filter:
    """st_intersects(geomcol, G) etc. with a CONSTANT geometry -> the
    planner predicate (the push-down rule)."""
    if call[0] != "call" or call[1] not in _SPATIAL:
        raise _NotPushable()
    name, args = call[1], call[2]
    if name == "st_bbox":
        # st_bbox(geom, x0, y0, x1, y1)
        if len(args) == 5 and _is_geom_col(args[0], sft):
            from geomesa_tpu_torch.filter.predicates import wrap_box

            vals = [_const_value(a) for a in args[1:]]
            return wrap_box(args[0][1], *(float(v) for v in vals))
        raise _NotPushable()
    if len(args) != 2 and name != "st_dwithin":
        raise _NotPushable()
    if name == "st_dwithin":
        if len(args) == 3 and _is_geom_col(args[0], sft):
            g = _as_geom(_const_value(args[1]))
            return DWithin(args[0][1], g, float(_const_value(args[2])))
        raise _NotPushable()
    a, b = args
    if name == "st_intersects":
        if _is_geom_col(a, sft):
            return Intersects(a[1], _as_geom(_const_value(b)))
        if _is_geom_col(b, sft):
            return Intersects(b[1], _as_geom(_const_value(a)))
    if name == "st_contains":
        # st_contains(G, geomcol): G contains the feature -> Within
        if _is_geom_col(b, sft):
            return Within(b[1], _as_geom(_const_value(a)))
        if _is_geom_col(a, sft):
            from geomesa_tpu_torch.filter.predicates import Contains

            return Contains(a[1], _as_geom(_const_value(b)))
    if name == "st_within":
        if _is_geom_col(a, sft):
            return Within(a[1], _as_geom(_const_value(b)))
    raise _NotPushable()


def _as_geom(v) -> geo.Geometry:
    if isinstance(v, geo.Geometry):
        return v
    if isinstance(v, str):
        return geo.from_wkt(v)
    raise _NotPushable()


def _ast_text(node) -> str:
    """AST -> converter-DSL expression text for residual row evaluation."""
    kind = node[0]
    if kind == "lit":
        v = node[1]
        if isinstance(v, str):
            return "'" + v.replace("'", "''") + "'"
        return "0" if v is None else repr(v)
    if kind == "col":
        return node[1]
    if kind == "call":
        return f"{node[1]}({', '.join(_ast_text(a) for a in node[2])})"
    if kind == "bool":
        return _ast_text(node[1])
    if kind == "cmp":
        return f"__cmp__('{node[1]}', {_ast_text(node[2])}, {_ast_text(node[3])})"
    if kind == "and":
        return "__all__(" + ", ".join(_ast_text(c) for c in node[1]) + ")"
    if kind == "or":
        return "__any__(" + ", ".join(_ast_text(c) for c in node[1]) + ")"
    if kind == "not":
        return f"__not__({_ast_text(node[1])})"
    raise ValueError(f"cannot render {node}")


_OPS = {
    "=": lambda a, b: a == b,
    "<>": lambda a, b: a != b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def _install_residual_fns():
    """Boolean combinators for residual expressions, registered once in
    the shared expression function table."""
    from geomesa_tpu_torch.io import converters as C

    base = C._compile_fns

    def patched(name, args):
        if name == "__cmp__":
            return lambda rec: _OPS[args[0](rec)](args[1](rec), args[2](rec))
        if name == "__all__":
            return lambda rec: all(bool(a(rec)) for a in args)
        if name == "__any__":
            return lambda rec: any(bool(a(rec)) for a in args)
        if name == "__not__":
            return lambda rec: not bool(args[0](rec))
        return base(name, args)

    C._compile_fns = patched
    _install_residual_fns.__wrapped__ = True


@dataclass
class SqlPlan:
    """Compiled SELECT: what pushed down, what stayed residual."""

    type_name: str
    filter: Filter
    residuals: list[str]
    transforms: "list[str] | None"
    order_by: "str | None"
    limit: "int | None"
    offset: "int | None"


def parse_select(sql: str, sft) -> SqlPlan:
    p = _Parser(sql)
    p.expect("kw", "SELECT")
    transforms: "list[str] | None" = []
    if p.accept("punct", "*"):
        transforms = None
    else:
        while True:
            expr_text = p._expr_text()
            if p.accept("kw", "AS"):
                name = p.expect("word").value
                transforms.append(f"{name}={expr_text}")
            else:
                transforms.append(expr_text)
            if not p.accept("punct", ","):
                break
    p.expect("kw", "FROM")
    type_name = str(p.expect("word").value)
    f: Filter = Include()
    residuals: list[str] = []
    if p.accept("kw", "WHERE"):
        ast = p.or_expr()
        f0, res = _compile_term(ast, sft)
        f = f0 if f0 is not None else Include()
        residuals = res or []
    order_by = None
    if p.accept("kw", "ORDER"):
        p.expect("kw", "BY")
        order_by = str(p.expect("word").value)
        if p.accept("kw", "DESC"):
            order_by = "-" + order_by
        else:
            p.accept("kw", "ASC")
    limit = offset = None
    if p.accept("kw", "LIMIT"):
        limit = int(p.expect("num").value)
    if p.accept("kw", "OFFSET"):
        offset = int(p.expect("num").value)
    if p.peek() is not None:
        raise ValueError(f"trailing SQL at {p.peek()}")
    return SqlPlan(type_name, f, residuals, transforms, order_by, limit, offset)


def sql_query(ds, sql: str):
    """Run one SELECT against a DataStore; returns a FeatureCollection.

    Pushable WHERE terms ride the planner/indexes; residual terms
    evaluate per row after the scan; the select list runs through the
    transform engine. LIMIT/OFFSET apply after residuals (exact
    semantics, like Spark applying limits above a filtered relation)."""
    from geomesa_tpu_torch.io.converters import compile_expression
    from geomesa_tpu_torch.planning.hints import QueryHints

    if not getattr(_install_residual_fns, "__wrapped__", False):
        _install_residual_fns()

    # FROM table name is needed to compile WHERE against the schema
    m = re.search(r"\bFROM\s+(\w+)", sql, re.IGNORECASE)
    if m is None:
        raise ValueError("SELECT needs a FROM <type_name>")
    sft = ds.get_schema(m.group(1))
    plan = parse_select(sql, sft)

    # ORDER BY on a SELECT alias (ORDER BY lon with lon=st_x(geom)) must
    # sort the TRANSFORMED output, so sorting/paging move past transform
    base_attr = plan.order_by.lstrip("-") if plan.order_by else None
    order_on_output = base_attr is not None and not sft.has(base_attr)
    pushdown_page = not plan.residuals and not order_on_output
    hints = QueryHints(
        sort_by=plan.order_by if pushdown_page else None,
        offset=plan.offset if pushdown_page else None,
    )
    out = ds.query(
        plan.type_name, plan.filter,
        limit=plan.limit if pushdown_page else None, hints=hints,
    )
    if plan.residuals:
        # evaluate residuals over {attr: value} dicts (geometry as objects)
        keep = np.ones(len(out), dtype=bool)
        base: dict[str, list] = {}
        from geomesa_tpu_torch.filter.predicates import PointColumn

        for aname, col in out.columns.items():
            if isinstance(col, PointColumn):
                base[aname] = [
                    geo.Point(float(px), float(py))
                    for px, py in zip(col.x, col.y)
                ]
            elif isinstance(col, geo.PackedGeometryColumn):
                base[aname] = col.geometries()
            else:
                base[aname] = np.asarray(col).tolist()
        for res in plan.residuals:
            fn = compile_expression(res)
            for i in range(len(out)):
                if keep[i]:
                    keep[i] = bool(fn({k: v[i] for k, v in base.items()}))
        out = out.mask(keep)

    def page(fc):
        lo = plan.offset or 0
        hi = len(fc) if plan.limit is None else min(lo + plan.limit, len(fc))
        return fc.take(np.arange(min(lo, len(fc)), hi))

    if plan.residuals and not order_on_output:
        if plan.order_by:
            out = out.sort_values(plan.order_by)
        out = page(out)
    if plan.transforms is not None:
        out = out.transform(plan.transforms)
    if order_on_output:
        out = out.sort_values(plan.order_by)
        out = page(out)
    return out
