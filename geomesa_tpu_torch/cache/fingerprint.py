"""Canonical query fingerprints: the result-cache key.

The port's copy of geomesa_tpu/cache/fingerprint.py; its keys equal the
JAX package's for the same query. A fingerprint covers everything that
can change a query's result: the feature type and schema generation
(spec hash x tracker schema generation, so a dropped-and-recreated type
never aliases), the chosen index, the canonically ordered filter
(filter.predicates.canonical_key: ``a AND b`` and ``b AND a`` collide),
the limit, the store auths (visibility filtering is baked into results)
and every result-affecting hint (transforms, sort, offset, sample,
loose, reproject). Deliberately excluded: timeout (it changes failure,
not results), explain, and the cache hint itself.
"""

from __future__ import annotations

import hashlib

from geomesa_tpu_torch.filter.predicates import canonical_key

# hint fields that change result bytes, in fingerprint order
_RESULT_HINTS = (
    "transforms", "sort_by", "offset", "sample", "sample_by", "loose",
    "reproject",
)


def schema_signature(sft) -> str:
    """Content hash of a schema: spec + user_data (user_data carries
    result-shaping options like visibility fields)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(sft.to_spec().encode())
    for k in sorted(sft.user_data, key=str):
        h.update(f"|{k}={sft.user_data[k]}".encode())
    return h.hexdigest()


_NO_HINTS = None  # lazy canonical QueryHints(): import cycle guard


def hints_token(hints) -> str:
    """Token over the result-affecting hint fields. ``hints=None`` and an
    explicit default ``QueryHints()`` render IDENTICALLY — both mean "no
    result-shaping hints", and a query carrying only a timeout must share
    the no-hints entry."""
    global _NO_HINTS
    if hints is None:
        if _NO_HINTS is None:
            from geomesa_tpu_torch.planning.hints import QueryHints

            _NO_HINTS = QueryHints()
        hints = _NO_HINTS
    parts = []
    for name in _RESULT_HINTS:
        v = getattr(hints, name, None)
        if isinstance(v, (list, tuple)):
            v = tuple(v)
        parts.append(f"{name}={v!r}")
    return ";".join(parts)


def fingerprint(
    type_name: str,
    schema_sig: str,
    schema_gen: int,
    strategy: str,
    f,
    limit,
    hints,
    auths,
) -> str:
    """The cache key for one planned query (hex blake2b)."""
    h = hashlib.blake2b(digest_size=16)
    auth_tok = "-" if auths is None else ",".join(sorted(str(a) for a in auths))
    payload = "\x00".join((
        type_name,
        schema_sig,
        str(schema_gen),
        strategy,
        canonical_key(f),
        str(limit),
        hints_token(hints),
        auth_tok,
    ))
    h.update(payload.encode())
    return h.hexdigest()


def fingerprint_plan(plan, hints, sft, auths, schema_gen: int = 0) -> str:
    """Assemble the canonical fingerprint for one QueryPlan: one argument
    assembly for every caller (QueryCache.fingerprint_plan; a cache-less
    caller fixes the schema generation at 0), so keys cannot drift."""
    return fingerprint(
        plan.type_name, schema_signature(sft), schema_gen,
        plan.strategy, plan.filter, plan.limit, hints, auths,
    )
