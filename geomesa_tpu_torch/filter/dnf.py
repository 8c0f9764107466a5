"""Disjunctive-normal-form rewrite for union planning.

The port's copy of geomesa_tpu/filter/dnf.py. Reference: FilterSplitter
rewrites filters into DNF before computing query options, so each
disjunct can pick its own index and the results union
(geomesa-filter's ``rewriteFilterInDnf`` and geomesa-index-api's
planning/FilterSplitter.scala:61-147: ``(bbox AND a=1) OR (b=2)`` becomes
one spatial-index option and one attribute-index option with
deduplication).

The expansion is capped: distributing ANDs over ORs is exponential in the
worst case, and past a handful of disjuncts a union plan loses to a single
scan anyway (the reference caps at 32 options and falls back to a single
full-filter strategy the same way).
"""

from __future__ import annotations

from geomesa_tpu_torch.filter.predicates import And, Filter, Not, Or

MAX_DISJUNCTS = 16


def rewrite_dnf(f: Filter, limit: int = MAX_DISJUNCTS) -> list[Filter] | None:
    """``f`` as a bounded list of disjuncts (each free of top-level ORs),
    or None when the expansion would exceed ``limit`` disjuncts.

    NOT is pushed through And/Or by De Morgan; other predicates are leaves.
    A single-element result means the filter has no OR structure at all.
    """
    out = _dnf(_push_not(f), limit)
    return out


def _push_not(f: Filter) -> Filter:
    """De Morgan: push NOT down to the leaves so distribution sees the
    whole And/Or structure."""
    if isinstance(f, Not):
        inner = f.filter
        if isinstance(inner, And):
            return _push_not(Or([Not(c) for c in inner.filters]))
        if isinstance(inner, Or):
            return _push_not(And([Not(c) for c in inner.filters]))
        if isinstance(inner, Not):
            return _push_not(inner.filter)
        return f
    if isinstance(f, And):
        return And([_push_not(c) for c in f.filters])
    if isinstance(f, Or):
        return Or([_push_not(c) for c in f.filters])
    return f


def _dnf(f: Filter, limit: int) -> list[Filter] | None:
    if isinstance(f, Or):
        out: list[Filter] = []
        for c in f.filters:
            part = _dnf(c, limit)
            if part is None:
                return None
            out.extend(part)
            if len(out) > limit:
                return None
        return out
    if isinstance(f, And):
        # cross-product of the children's disjunct lists
        terms: list[list[Filter]] = [[]]
        for c in f.filters:
            part = _dnf(c, limit)
            if part is None:
                return None
            terms = [t + [d] for t in terms for d in part]
            if len(terms) > limit:
                return None
        return [t[0] if len(t) == 1 else And(t) for t in terms]
    return [f]
