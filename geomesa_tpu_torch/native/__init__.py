"""The port's native host helpers: ``geomesa_native.cpp``, built with g++
on first use and bound with ctypes.

The port's copy of geomesa_tpu/native (the loader and its typed
wrappers). The helpers are host code, not device kernels: z-range and XZ
range decomposition, XZ codes, the write keys, the (bin, z) radix sort,
column and row gathers, the bit-plane decodes, the span merge, a counting
sort and point-in-polygon. The library builds into
``geomesa_tpu_torch/build/`` at the first call; a failed build raises
with g++'s output. Concurrent builds (several processes importing a fresh
checkout) compile to a private file and rename it into place under a file
lock.

Each wrapper returns None only where the reference's does for its inputs
(a calendar period, more than 2**32 rows, an unsupported dtype) or inside
:func:`disabled`, the test switch that routes every caller to its numpy
version (the plain version the tests hold the helpers against). Every
call into the library counts in :data:`calls`, so a caller can show which
helpers a path ran.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "geomesa_native.cpp"
BUILD_DIR = _DIR.parent / "build"
LIB_PATH = BUILD_DIR / "libgeomesa_native.so"

# -ffp-contract=off: the point-in-polygon ray cast is bit-exact with
# numpy's two-rounding float sequence only without fused multiply-adds
GXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")

HELPERS = (
    "morton2", "morton3", "morton3_decode", "z3_write_keys", "z2_write_keys",
    "sort_bins_z", "take", "take_rows", "bitmask_decode_pair", "bitmask_decode",
    "xz_index", "xz_ranges", "merge_rows_spans", "counting_argsort", "zranges",
    "points_in_polygon",
)
# calls into the library per helper since the last reset_counts()
calls: dict = dict.fromkeys(HELPERS, 0)

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
_disabled = 0


def reset_counts() -> None:
    for k in calls:
        calls[k] = 0


@contextlib.contextmanager
def disabled():
    """Route every caller to its numpy version inside the block (tests
    only: the numpy versions are the helpers' plain versions); the library
    is back on exit."""
    global _disabled
    with _lock:
        _disabled += 1
    try:
        yield
    finally:
        with _lock:
            _disabled -= 1


def _stale() -> bool:
    return not LIB_PATH.exists() or LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime


def build() -> Path:
    """Compile the library if it is missing or older than its source;
    raises RuntimeError with g++'s output when the build fails. Safe
    across processes: each compiles to a private file and renames it over
    the library under an exclusive lock on ``build/.native.lock``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".native.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if not _stale():
                return LIB_PATH
            tmp = BUILD_DIR / f".libgeomesa_native.{os.getpid()}.so"
            errors = []
            for extra in (("-fopenmp",), ()):  # threaded first
                r = subprocess.run(
                    ["g++", *GXX_FLAGS, *extra, str(_SRC), "-o", str(tmp)],
                    capture_output=True, text=True, timeout=300,
                )
                if r.returncode == 0:
                    os.replace(tmp, LIB_PATH)
                    return LIB_PATH
                errors.append(r.stderr)
            tmp.unlink(missing_ok=True)
            raise RuntimeError("g++ failed to build the native helpers:\n" + "\n".join(errors))
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def _bind(lib: ctypes.CDLL) -> None:
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64, i32, f64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_double
    lib.morton2.argtypes = [u64p, u64p, i64, u64p]
    lib.morton2_decode.argtypes = [u64p, i64, u64p, u64p]
    lib.morton3.argtypes = [u64p, u64p, u64p, i64, u64p]
    lib.morton3_decode.argtypes = [u64p, i64, u64p, u64p, u64p]
    lib.z3_write_keys.argtypes = [
        f64p, f64p, i64p, i64, i64, i64, f64, i32, u64p, i32p, f32p, f32p, i32p,
    ]
    lib.z3_write_keys.restype = i32
    lib.z2_write_keys.argtypes = [f64p, f64p, i64, u64p, f32p, f32p]
    lib.sort_bins_z.argtypes = [i32p, u64p, i64, u32p]
    for name, tp in (
        ("gather_f32", f32p), ("gather_i32", i32p), ("gather_i64", i64p),
        ("gather_u64", u64p), ("gather_f64", f64p),
    ):
        getattr(lib, name).argtypes = [tp, u32p, i64, tp]
    for name, tp in (("gather_rows_f32", f32p), ("gather_rows_f64", f64p)):
        getattr(lib, name).argtypes = [tp, u32p, i64, i64, tp]
    lib.points_in_polygon_cpp.argtypes = [f64p, f64p, i64, f64p, i64p, i64, i32p, u8p]
    lib.zranges_cpp.argtypes = [
        i32, i32, i64, u64p, u64p, u64p, u64p, i64, i64, u64p, u64p, u8p, i64,
    ]
    lib.zranges_cpp.restype = i64
    lib.bitmask_count.argtypes = [i32p, i64, i64]
    lib.bitmask_count.restype = i64
    lib.bitmask_decode_pair.argtypes = [i32p, i32p, i64p, i64, i64, i64, i64p, u8p]
    lib.bitmask_decode_pair.restype = i64
    lib.merge_rows_spans.argtypes = [i64p, i64p, i64, i64p, u8p, i64, i64p, u8p]
    lib.merge_rows_spans.restype = i64
    lib.counting_argsort.argtypes = [i32p, i64, i64, u32p]
    lib.bitmask_decode.argtypes = [i32p, i64p, i64, i64, i64, i64p]
    lib.bitmask_decode.restype = i64
    lib.xz_index.argtypes = [f64p, f64p, i64, i32, i32, i64p, i64p]
    lib.xz_ranges.argtypes = [i32, i32, i64p, f64p, f64p, i64, i64, u64p, u64p, u8p, i64]
    lib.xz_ranges.restype = i64


def library() -> ctypes.CDLL:
    """The loaded library, built first where needed (raises on failure)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                if _stale():
                    build()
                lib = ctypes.CDLL(str(LIB_PATH))
                _bind(lib)
                _lib = lib
    return _lib


def loaded() -> bool:
    """Whether the library is loaded in this process."""
    return _lib is not None


def _load() -> "ctypes.CDLL | None":
    return None if _disabled else library()


def morton2(x, y) -> "np.ndarray | None":
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.uint64)
    y = np.ascontiguousarray(y, dtype=np.uint64)
    out = np.empty(len(x), dtype=np.uint64)
    calls["morton2"] += 1
    lib.morton2(x, y, len(x), out)
    return out


def morton3(x, y, t) -> "np.ndarray | None":
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.uint64)
    y = np.ascontiguousarray(y, dtype=np.uint64)
    t = np.ascontiguousarray(t, dtype=np.uint64)
    out = np.empty(len(x), dtype=np.uint64)
    calls["morton3"] += 1
    lib.morton3(x, y, t, len(x), out)
    return out


def morton3_decode(z):
    lib = _load()
    if lib is None:
        return None
    z = np.ascontiguousarray(z, dtype=np.uint64)
    x = np.empty(len(z), dtype=np.uint64)
    y = np.empty(len(z), dtype=np.uint64)
    t = np.empty(len(z), dtype=np.uint64)
    calls["morton3_decode"] += 1
    lib.morton3_decode(z, len(z), x, y, t)
    return x, y, t


# fixed-width periods the native binning supports: millis/bin, offset divisor
_FIXED_PERIODS = {"day": (86_400_000, 1), "week": (604_800_000, 1000)}


def z3_write_keys(x, y, millis, period: str, max_offset: int, max_bin: int):
    """Fused (bins, zs, device cols) for fixed-width periods, or None for a
    calendar-based period."""
    cfg = _FIXED_PERIODS.get(period)
    lib = _load() if cfg is not None else None
    if lib is None:
        return None
    bin_ms, off_div = cfg
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    millis = np.ascontiguousarray(millis, dtype=np.int64)
    n = len(x)
    z = np.empty(n, dtype=np.uint64)
    bins = np.empty(n, dtype=np.int32)
    xf = np.empty(n, dtype=np.float32)
    yf = np.empty(n, dtype=np.float32)
    toff = np.empty(n, dtype=np.int32)
    calls["z3_write_keys"] += 1
    status = lib.z3_write_keys(
        x, y, millis, n, bin_ms, off_div, float(max_offset), max_bin,
        z, bins, xf, yf, toff,
    )
    if status == 1:
        raise ValueError(f"pre-epoch timestamp(s) not supported by period {period}")
    if status == 2:
        raise ValueError(f"timestamp(s) past the max representable date for period {period}")
    return bins, z, {"x": xf, "y": yf, "tbin": bins, "toff": toff}


def z2_write_keys(x, y):
    """Fused (zs, device cols) for the z2 index."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    n = len(x)
    z = np.empty(n, dtype=np.uint64)
    xf = np.empty(n, dtype=np.float32)
    yf = np.empty(n, dtype=np.float32)
    calls["z2_write_keys"] += 1
    lib.z2_write_keys(x, y, n, z, xf, yf)
    return z, {"x": xf, "y": yf}


def sort_bins_z(bins, zs) -> "np.ndarray | None":
    """Stable argsort by (bin, z) through an LSD radix sort (equal to
    ``np.lexsort((zs, bins))``): u32 perm, or None at 2**32 rows or more."""
    if len(zs) >= (1 << 32):
        return None
    lib = _load()
    if lib is None:
        return None
    bins = np.ascontiguousarray(bins, dtype=np.int32)
    zs = np.ascontiguousarray(zs, dtype=np.uint64)
    perm = np.empty(len(zs), dtype=np.uint32)
    calls["sort_bins_z"] += 1
    lib.sort_bins_z(bins, zs, len(zs), perm)
    return perm


_GATHERS = {
    np.dtype(np.float32): "gather_f32",
    np.dtype(np.int32): "gather_i32",
    np.dtype(np.int64): "gather_i64",
    np.dtype(np.uint64): "gather_u64",
    np.dtype(np.float64): "gather_f64",
}


def take(src: np.ndarray, idx: np.ndarray) -> "np.ndarray | None":
    """out[i] = src[idx[i]] for the supported dtypes (u32 indices), or
    None for another dtype or shape."""
    name = _GATHERS.get(src.dtype)
    if name is None or src.ndim != 1:
        return None
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, dtype=np.uint32)
    out = np.empty(len(idx), dtype=src.dtype)
    calls["take"] += 1
    getattr(lib, name)(src, idx, len(idx), out)
    return out


_ROW_GATHERS = {
    np.dtype(np.float32): "gather_rows_f32",
    np.dtype(np.float64): "gather_rows_f64",
}


def take_rows(src: np.ndarray, idx: np.ndarray) -> "np.ndarray | None":
    """out[i, :] = src[idx[i], :] for f32/f64 [n, width] arrays, or None."""
    name = _ROW_GATHERS.get(src.dtype)
    if name is None or src.ndim != 2:
        return None
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, dtype=np.uint32)
    out = np.empty((len(idx), src.shape[1]), dtype=src.dtype)
    calls["take_rows"] += 1
    getattr(lib, name)(src, idx, len(idx), src.shape[1], out)
    return out


def bitmask_decode_pair(wide, inner, bids, n_real: int, block: int):
    """(rows i64, certain bool) from the wide and inner bit planes
    ([n, PACK, 128] int32 on the host), or None for no real slot."""
    if n_real == 0:
        return None
    lib = _load()
    if lib is None:
        return None
    wide = np.ascontiguousarray(wide[:n_real], dtype=np.int32)
    inner = np.ascontiguousarray(inner[:n_real], dtype=np.int32)
    bids = np.ascontiguousarray(bids[:n_real], dtype=np.int64)
    pack = wide.shape[1]
    calls["bitmask_decode_pair"] += 1
    count = lib.bitmask_count(wide, n_real, pack)
    rows = np.empty(count, dtype=np.int64)
    cert = np.empty(count, dtype=np.uint8)
    k = lib.bitmask_decode_pair(wide, inner, bids, n_real, pack, block, rows, cert)
    assert k == count
    return rows, cert.astype(bool)


def bitmask_decode(wide, bids, n_real: int, block: int):
    """Ascending rows from a wide bit plane, or None for no real slot."""
    if n_real == 0:
        return None
    lib = _load()
    if lib is None:
        return None
    wide = np.ascontiguousarray(wide[:n_real], dtype=np.int32)
    bids = np.ascontiguousarray(bids[:n_real], dtype=np.int64)
    pack = wide.shape[1]
    calls["bitmask_decode"] += 1
    count = lib.bitmask_count(wide, n_real, pack)
    rows = np.empty(count, dtype=np.int64)
    k = lib.bitmask_decode(wide, bids, n_real, pack, block, rows)
    assert k == count
    return rows


def xz_index(lo, hi, dims: int, g: int, subtree) -> "np.ndarray | None":
    """Element boxes ([n, dims] normalized lo/hi) -> XZ sequence codes, or
    None past 4 dims. ``subtree`` is XZSFC.subtree_size (len g+2)."""
    if dims > 4:  # the C++ cell buffers are fixed at 4 dims
        return None
    lib = _load()
    if lib is None:
        return None
    lo = np.ascontiguousarray(lo, dtype=np.float64)
    hi = np.ascontiguousarray(hi, dtype=np.float64)
    sub = np.ascontiguousarray(subtree, dtype=np.int64)
    n = lo.shape[0]
    out = np.empty(n, dtype=np.int64)
    calls["xz_index"] += 1
    lib.xz_index(lo.reshape(-1), hi.reshape(-1), n, int(dims), int(g), sub, out)
    return out


def xz_ranges(dims: int, g: int, subtree, qlo, qhi, max_ranges: int):
    """Covering XZ sequence-code ranges of normalized query boxes: (lo
    u64[k], hi u64[k], contained bool[k]), or None past 4 dims or when the
    output buffer overflows."""
    if dims > 4:
        return None
    lib = _load()
    if lib is None:
        return None
    qlo = np.ascontiguousarray(qlo, dtype=np.float64)
    qhi = np.ascontiguousarray(qhi, dtype=np.float64)
    sub = np.ascontiguousarray(subtree, dtype=np.int64)
    nq = qlo.shape[0] if qlo.ndim == 2 else len(qlo) // dims
    cap = max(int(max_ranges) * 2 + 64, 256)
    lo = np.empty(cap, dtype=np.uint64)
    hi = np.empty(cap, dtype=np.uint64)
    cont = np.empty(cap, dtype=np.uint8)
    calls["xz_ranges"] += 1
    n = lib.xz_ranges(
        dims, g, sub, qlo.reshape(-1), qhi.reshape(-1), nq,
        int(max_ranges), lo, hi, cont, cap,
    )
    if n < 0:
        return None
    return lo[:n].copy(), hi[:n].copy(), cont[:n].astype(bool)


def merge_rows_spans(spans, rows, cert):
    """(rows, certain): the union of contained spans (certain) and
    ascending kernel rows, deduplicated, in one two-pointer pass."""
    lib = _load()
    if lib is None:
        return None
    lo = np.ascontiguousarray([s[0] for s in spans], dtype=np.int64)
    hi = np.ascontiguousarray([s[1] for s in spans], dtype=np.int64)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cert8 = np.ascontiguousarray(cert, dtype=np.uint8)
    cap = int((hi - lo).sum()) + len(rows)
    out_rows = np.empty(cap, dtype=np.int64)
    out_cert = np.empty(cap, dtype=np.uint8)
    calls["merge_rows_spans"] += 1
    k = lib.merge_rows_spans(lo, hi, len(lo), rows, cert8, len(rows), out_rows, out_cert)
    return out_rows[:k], out_cert[:k].astype(bool)


def counting_argsort(keys, n_buckets: int) -> "np.ndarray | None":
    """Stable O(n) argsort of int keys in [0, n_buckets): u32 perm, or None
    at 2**32 keys or more, or when a key is out of range (the C++ indexes
    its offsets by key unchecked)."""
    if len(keys) >= (1 << 32) or n_buckets > (1 << 31) - 2:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if len(keys) and (keys.min() < 0 or keys.max() >= n_buckets):
        return None
    lib = _load()
    if lib is None:
        return None
    keys = keys.astype(np.int32)
    perm = np.empty(len(keys), dtype=np.uint32)
    calls["counting_argsort"] += 1
    lib.counting_argsort(keys, len(keys), int(n_buckets), perm)
    return perm


def zranges(dims, bits_per_dim, mins, maxes, inner_mins, inner_maxes,
            max_ranges, max_recurse):
    """Covering z-ranges of a union of ordinal boxes (BFS + zdiv
    tightening), containment classified against the inner boxes: (lo
    u64[k], hi u64[k], contained bool[k]), or None when the output buffer
    overflows."""
    lib = _load()
    if lib is None:
        return None
    mins = np.ascontiguousarray(mins, dtype=np.uint64)
    maxes = np.ascontiguousarray(maxes, dtype=np.uint64)
    inner_mins = np.ascontiguousarray(inner_mins, dtype=np.uint64)
    inner_maxes = np.ascontiguousarray(inner_maxes, dtype=np.uint64)
    nbox = len(mins) // dims if mins.ndim == 1 else len(mins)
    cap = max(int(max_ranges) * 2 + 64, 256)
    lo = np.empty(cap, dtype=np.uint64)
    hi = np.empty(cap, dtype=np.uint64)
    cont = np.empty(cap, dtype=np.uint8)
    calls["zranges"] += 1
    n = lib.zranges_cpp(
        dims, bits_per_dim, nbox,
        mins.reshape(-1), maxes.reshape(-1),
        inner_mins.reshape(-1), inner_maxes.reshape(-1),
        int(max_ranges), int(max_recurse), lo, hi, cont, cap,
    )
    if n < 0:
        return None
    return lo[:n].copy(), hi[:n].copy(), cont[:n].astype(bool)


def points_in_polygon(px, py, rings, ring_part) -> "np.ndarray | None":
    """Even-odd point-in-polygon over flattened rings: ``rings`` is a list
    of closed [k, 2] f64 rings, ``ring_part[r]`` groups rings into
    multipolygon parts (parity XORs within a part; parts OR). Crossing
    semantics are geometry.points_in_ring's exactly."""
    lib = _load()
    if lib is None:
        return None
    px = np.ascontiguousarray(px, dtype=np.float64)
    py = np.ascontiguousarray(py, dtype=np.float64)
    verts = np.ascontiguousarray(np.concatenate(rings, axis=0), dtype=np.float64)
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in rings])]).astype(np.int64)
    part = np.ascontiguousarray(ring_part, dtype=np.int32)
    out = np.empty(len(px), dtype=np.uint8)
    calls["points_in_polygon"] += 1
    lib.points_in_polygon_cpp(px, py, len(px), verts, offsets, len(rings), part, out)
    return out.astype(bool)
