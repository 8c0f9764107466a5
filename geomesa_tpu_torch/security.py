"""Visibility security: per-feature labels evaluated against auths.

The port's copy of geomesa_tpu/security.py (reference geomesa-security:
VisibilityEvaluator, AuthorizationsProvider). Visibility expressions use
the Accumulo grammar:

    admin                  requires the "admin" auth
    admin&user             both
    admin|ops              either
    a&(b|c)                grouping; & binds tighter than |

An empty visibility is visible to everyone. A store configured with
``auths`` masks every query result through the evaluator (row-level
security); the visibility column is named by the schema's
``geomesa.vis.field`` user-data key. Labels are evaluated on the host:
the device scan never reads them, so every aggregation that would run on
the card steps aside for the host path while visibility is active
(``DataStore._vis_active``).

Hostile input: the parser is bounded. Input over
:data:`MAX_EXPRESSION_LENGTH` or nested past :data:`MAX_EXPRESSION_DEPTH`
raises :class:`VisibilityError` (a ``ValueError``) instead of recursing
toward a ``RecursionError``; every rejection path raises that one type.
"""

from __future__ import annotations

import re
from functools import lru_cache

import numpy as np

VIS_FIELD_KEY = "geomesa.vis.field"

_TOKEN = re.compile(r"\s*(?:(?P<label>[\w.\-:]+)|(?P<op>[&|()]))")

#: hard cap on expression bytes accepted by the parser — a 4 KiB label
#: is already absurd; anything longer is an attack or a bug
MAX_EXPRESSION_LENGTH = 4096

#: hard cap on paren-nesting depth — the recursive-descent parser (and
#: the recursive evaluator) consume one stack frame per level, so an
#: unbounded "(((((..." from the network would otherwise RecursionError
MAX_EXPRESSION_DEPTH = 64


class VisibilityError(ValueError):
    """A visibility expression that does not parse (bad token,
    unbalanced parens, trailing input, over the length/depth caps).
    Subclasses ``ValueError`` so pre-existing callers keep working."""


def validate(expression: str) -> None:
    """Reject a malformed visibility label BEFORE it is stored: raises
    :class:`VisibilityError`, accepts empty/blank (public), so a hostile
    expression fails at the door instead of inside a later query's
    mask."""
    if expression and expression.strip():
        _compile(expression.strip())


@lru_cache(maxsize=4096)
def _compile(expression: str):
    """Parse a visibility expression into a nested tuple AST."""
    if len(expression) > MAX_EXPRESSION_LENGTH:
        raise VisibilityError(
            f"visibility expression over {MAX_EXPRESSION_LENGTH} chars "
            f"({len(expression)})"
        )
    pos = 0
    text = expression

    def parse_or(depth):
        nonlocal pos
        left = parse_and(depth)
        while True:
            m = _TOKEN.match(text, pos)
            if m and m.group("op") == "|":
                pos = m.end()
                left = ("or", left, parse_and(depth))
            else:
                return left

    def parse_and(depth):
        nonlocal pos
        left = parse_atom(depth)
        while True:
            m = _TOKEN.match(text, pos)
            if m and m.group("op") == "&":
                pos = m.end()
                left = ("and", left, parse_atom(depth))
            else:
                return left

    def parse_atom(depth):
        nonlocal pos
        m = _TOKEN.match(text, pos)
        if m is None:
            raise VisibilityError(
                f"bad visibility {expression!r} at {text[pos:]!r}"
            )
        if m.group("label"):
            pos = m.end()
            return ("label", m.group("label"))
        if m.group("op") == "(":
            if depth >= MAX_EXPRESSION_DEPTH:
                raise VisibilityError(
                    f"visibility expression nested past "
                    f"{MAX_EXPRESSION_DEPTH} levels"
                )
            pos = m.end()
            inner = parse_or(depth + 1)
            m2 = _TOKEN.match(text, pos)
            if not m2 or m2.group("op") != ")":
                raise VisibilityError(f"unbalanced parens in {expression!r}")
            pos = m2.end()
            return inner
        raise VisibilityError(
            f"bad visibility {expression!r} at {text[pos:]!r}"
        )

    ast = parse_or(0)
    if text[pos:].strip():
        # any leftover input is an error — a silently-truncated label like
        # "admin,ops" would otherwise grant access on its first token
        raise VisibilityError(f"trailing input in visibility {expression!r}")
    return ast


def _eval(ast, auths: frozenset) -> bool:
    kind = ast[0]
    if kind == "label":
        return ast[1] in auths
    if kind == "and":
        return _eval(ast[1], auths) and _eval(ast[2], auths)
    return _eval(ast[1], auths) or _eval(ast[2], auths)


def visible(expression: str, auths) -> bool:
    """Can ``auths`` see a feature labeled ``expression``? Empty/blank
    labels are public (reference VisibilityEvaluator)."""
    if not expression or not expression.strip():
        return True
    return _eval(_compile(expression.strip()), frozenset(auths))


def visibility_mask(labels: np.ndarray, auths) -> np.ndarray:
    """Boolean mask over a visibility-label column (distinct labels are
    few; evaluate each once). Object-dtype columns (mixed None/str from
    a network ingest) normalize first — ``None`` is public, like the
    empty label — so a hostile payload can neither crash ``np.unique``'s
    sort nor smuggle a non-string past the parser."""
    labels = np.asarray(labels)
    if labels.dtype == object:
        labels = np.array(
            ["" if v is None else str(v) for v in labels.tolist()]
        )
    auths = frozenset(auths)
    out = np.zeros(len(labels), dtype=bool)
    for v in np.unique(labels):
        out[labels == v] = visible(str(v), auths)
    return out
