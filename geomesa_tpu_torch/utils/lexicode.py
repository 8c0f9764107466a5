"""Order-preserving u64 lexicoding of attribute values.

The port's copy of geomesa_tpu/utils/lexicode.py.

Reference: the attribute index lexicodes values into sortable row-key
strings (AttributeIndexKey.scala:21-70 over org.locationtech.geomesa.utils
lexicoders). The TPU redesign lexicodes into one u64 sort key — weakly
order-preserving (v1 <= v2 implies code(v1) <= code(v2)), so searchsorted
range pruning over the sorted key column is a correct superset and exact
semantics come from host refinement:

- strings: first 8 UTF-8 bytes big-endian (longer strings collide onto
  their prefix — collisions only widen the scanned span)
- signed ints: sign-bit flip
- floats: IEEE-754 total-order trick (flip sign bit for positives, all
  bits for negatives)
- dates: epoch-millis as signed ints
"""

from __future__ import annotations

import numpy as np

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
SIGN = np.uint64(0x8000000000000000)


def lex_int(col) -> np.ndarray:
    c = np.asarray(col).astype(np.int64)
    return c.view(np.uint64) ^ SIGN


def lex_float(col) -> np.ndarray:
    c = np.asarray(col, dtype=np.float64)
    b = c.view(np.uint64)
    neg = (b & SIGN) != 0
    return np.where(neg, ~b, b | SIGN)


def lex_string(col, word: int = 0) -> np.ndarray:
    """u64 lexicode word ``word`` of a string column: UTF-8 bytes
    [8*word, 8*word+8) big-endian, null-padded. Word 0 is the primary
    sort key; word 1 the tie-breaking secondary (WriteKeys.sub). Byte
    order of UTF-8 == code-point order, so each word is weakly
    order-preserving even when truncation splits a multi-byte sequence."""
    c = np.asarray(col)
    n = len(c)
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    # vectorized: encode enough chars to cover the byte window (a UTF-8
    # char is >= 1 byte, so (word+1)*8 chars always cover it), then slice
    # the window from a fixed-width bytes view
    width = (word + 1) * 8
    raw = np.char.encode(c.astype(f"U{width}"), "utf-8").astype(f"S{width}")
    b = np.frombuffer(raw.tobytes(), dtype=np.uint8).reshape(n, width)
    window = b[:, word * 8 : word * 8 + 8]
    return np.ascontiguousarray(window).view(">u8")[:, 0].astype(np.uint64)


def lex_column(col, attr_type: str) -> np.ndarray:
    """Lexicode one column according to its SFT attribute type."""
    if attr_type in ("Integer", "Int", "Long", "Date"):
        return lex_int(col)
    if attr_type in ("Float", "Double"):
        return lex_float(col)
    return lex_string(col)


def lex_value(v, attr_type: str):
    """Lexicode one scalar (query bounds); None maps to the open extreme."""
    return lex_column(np.array([v]), attr_type)[0]


def bounds_to_range(lo, hi, attr_type: str) -> tuple[np.uint64, np.uint64]:
    """Inclusive [lo, hi] u64 scan range for attribute value bounds; None
    means unbounded on that side. Exclusive query bounds still map to the
    inclusive code range (string prefixes collide; refinement is exact)."""
    code_lo = np.uint64(0) if lo is None else lex_value(lo, attr_type)
    code_hi = U64_MAX if hi is None else lex_value(hi, attr_type)
    return code_lo, code_hi


# cap on secondary sort words: 7 words -> values distinct within their
# first 64 UTF-8 bytes prune exactly; longer shared prefixes only widen
# the scanned span (host refinement stays exact)
MAX_SUB_WORDS = 7


def lex_string_words(col) -> "np.ndarray | None":
    """Variable-width secondary sort words for a string column: u64 words
    1..W of the lexicode ([n, W], big-endian bytes [8, 8+8W)), where W is
    just wide enough to cover the longest encoded value (capped at
    MAX_SUB_WORDS). None when every value fits the 8-byte primary word.
    Zero-padding IS the correct order semantics: a shorter string sorts
    before any extension of it, and 0 is the pad byte."""
    c = np.asarray(col)
    n = len(c)
    if n == 0:
        return None
    enc = np.char.encode(c.astype(str), "utf-8")
    max_len = int(np.char.str_len(enc).max()) if len(enc) else 0
    n_words = min(max(0, -(-(max_len - 8) // 8)), MAX_SUB_WORDS)
    if n_words == 0:
        return None
    # ONE encode pass at the full width, then slice every 8-byte window
    # from the same bytes view (np.char.encode is per-element; repeating
    # it per word made ingest pay W+1 full-column passes)
    width = (n_words + 1) * 8
    raw = np.char.encode(c.astype(f"U{width}"), "utf-8").astype(f"S{width}")
    b = np.frombuffer(raw.tobytes(), dtype=np.uint8).reshape(n, width)
    return np.stack(
        [
            np.ascontiguousarray(b[:, 8 * (j + 1) : 8 * (j + 2)])
            .view(">u8")[:, 0]
            .astype(np.uint64)
            for j in range(n_words)
        ],
        axis=1,
    )


def bounds_sub_words(lo, hi) -> tuple[np.ndarray, np.ndarray]:
    """[MAX_SUB_WORDS] secondary-word bounds for a string range: word j of
    each bound value (zero-padded past the value's length — its exact
    key), unbounded sides at the open extremes. Tables narrow with their
    own word count; extra config words are ignored."""
    lo_w = np.zeros(MAX_SUB_WORDS, dtype=np.uint64)
    hi_w = np.full(MAX_SUB_WORDS, U64_MAX, dtype=np.uint64)
    if lo is not None:
        a = np.array([lo])
        for j in range(MAX_SUB_WORDS):
            lo_w[j] = lex_string(a, 1 + j)[0]
    if hi is not None:
        a = np.array([hi])
        for j in range(MAX_SUB_WORDS):
            hi_w[j] = lex_string(a, 1 + j)[0]
    return lo_w, hi_w
