"""Stat DSL: parse "Count();MinMax(attr);..." and evaluate over a batch.

The port's copy of geomesa_tpu/stats/stat_spec.py (reference: the
parseable Stat grammar, geomesa-utils stats/Stat.scala:30-120, driving
the server-side StatsScan aggregation). Supported here:

    Count()
    MinMax(attr)
    Enumeration(attr)            -> exact value counts (TopK with k=all)
    TopK(attr[,k])
    Frequency(attr[,width])      -> count-min sketch
    Histogram(attr,bins,lo,hi)
    DescriptiveStats(attr[,attr2,...]) -> moments + covariance/correlation
    GroupBy(attr,<stat>)         -> one sub-stat per distinct value

A ';'-separated list IS the reference's SeqStat: parse() returns one
sketch per term and merge is element-wise.

Stats evaluate column-at-a-time over a FeatureCollection (the reference
folds one feature at a time inside iterators) and merge with ``+=``.
"""

from __future__ import annotations

import re

import numpy as np

from geomesa_tpu_torch.stats.sketches import (
    CountStat,
    DescriptiveStats,
    Frequency,
    Histogram,
    MinMax,
    TopK,
)

_CALL = re.compile(r"^\s*(\w+)\((.*)\)\s*$", re.S)


def _split_args(s: str) -> list[str]:
    """Split top-level comma args (GroupBy nests parenthesized calls)."""
    args, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            args.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        args.append(tail)
    return args


def _strip(a: str) -> str:
    return a.strip().strip("'\"")


class _Eval:
    """One parsed stat term bound to an attribute."""

    def __init__(self, kind: str, attr: str | None, make, sub=None):
        self.kind = kind
        self.attr = attr
        self.make = make
        self.sub = sub  # GroupBy inner spec string

    def observe(self, fc) -> object:
        sk = self.make()
        if self.kind == "count":
            sk.observe(np.zeros(len(fc)))
            return sk
        if self.kind == "descriptive":  # attr is a LIST of attributes
            sk.observe(*[_column(fc, a) for a in self.attr])
            return sk
        col = _column(fc, self.attr)
        if self.kind == "groupby":
            groups = {}
            vals = np.asarray(col)
            for v in np.unique(vals):
                groups[v.item() if hasattr(v, "item") else v] = evaluate(
                    self.sub, fc.mask(vals == v)
                )
            return groups
        sk.observe(col)
        return sk


def _column(fc, attr: str) -> np.ndarray:
    col = fc.columns[attr]
    if hasattr(col, "x"):  # PointColumn: observe lon for MinMax-style stats
        return col.x
    return np.asarray(col)


def parse_one(spec: str) -> _Eval:
    m = _CALL.match(spec)
    if not m:
        raise ValueError(f"cannot parse stat {spec!r}")
    name, raw = m.group(1).lower(), m.group(2)
    args = _split_args(raw)
    if name == "count":
        return _Eval("count", None, CountStat)
    if name == "minmax":
        return _Eval("minmax", _strip(args[0]), MinMax)
    if name in ("enumeration", "enum"):
        # exact counts: disable both the top-k trim and the cap eviction
        return _Eval("topk", _strip(args[0]), lambda: TopK(k=1 << 30, cap=1 << 30))
    if name == "topk":
        k = int(args[1]) if len(args) > 1 else 10
        return _Eval("topk", _strip(args[0]), lambda: TopK(k=k))
    if name == "frequency":
        width = int(args[1]) if len(args) > 1 else 1024
        return _Eval("frequency", _strip(args[0]), lambda: Frequency(width=width))
    if name == "histogram":
        bins, lo, hi = int(args[1]), float(args[2]), float(args[3])
        return _Eval("histogram", _strip(args[0]), lambda: Histogram(bins, lo, hi))
    if name in ("descriptivestats", "descriptive", "stats"):
        attrs = [_strip(a) for a in args]
        if not attrs:
            raise ValueError("DescriptiveStats requires at least one attribute")
        return _Eval(
            "descriptive", attrs, lambda: DescriptiveStats(len(attrs))
        )
    if name == "groupby":
        # sub-stats re-enter the term grammar, which is ';'-separated
        return _Eval("groupby", _strip(args[0]), dict, sub=";".join(args[1:]))
    raise ValueError(f"unknown stat {name!r}")


def parse(spec: str) -> list[_Eval]:
    return [parse_one(s) for s in spec.split(";") if s.strip()]


def evaluate_terms(terms: list, fc) -> list:
    return [term.observe(fc) for term in terms]


def evaluate(spec: str, fc) -> list:
    """Evaluate a stat spec string over a FeatureCollection; returns one
    sketch (or GroupBy dict) per ';'-separated term."""
    return evaluate_terms(parse(spec), fc)


def to_json(results: list) -> list:
    def conv(r):
        if isinstance(r, dict):
            return {str(k): to_json(v) for k, v in r.items()}
        return r.to_json()

    return [conv(r) for r in results]
