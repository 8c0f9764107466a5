"""Candidate-block scan: one kernel launch per query, bit planes out.

The port of geomesa_tpu/scan/block_kernels.py. Layout and output contract
are the JAX package's: device columns are [n_blocks, SUB, 128] tensors
(BLOCK = SUB*128 rows, local row = sublane*128 + lane); the host prunes
the sorted table to candidate blocks, pads the block-id list to a static
M bucket, and gets back two int32 bit planes [M, SUB/32, 128] — bit b of
word [j, lane] is local row (j*32 + b)*128 + lane:

- ``wide``: the f32/i32 predicate over widened bounds, a superset of the
  true hits;
- ``inner``: the predicate over shrunk bounds, rows certain to be hits at
  f64 precision, so host refinement touches only ``wide & ~inner``.

On extent (XZ) tables the box leg is bbox-*intersects* over the four
extent columns (gxmin, gymin, gxmax, gymax), which can never certify the
true geometry predicate: an extent box scan has no inner plane
(:func:`skip_inner_plane`), so the kernels write, and the host pulls, the
wide plane alone.

This module holds the numpy parameter packers and decode (copies of the
JAX package's), the plain PyTorch versions of the scan and of the fused
multi-query scan, and the wrappers of their CUDA kernels
(csrc/block_scan.cu, csrc/block_scan_multi.cu). The wrappers route by the
device of the columns: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or the call raises. Parameters (block ids and
the [8, 128] box and window blocks; for a fused chunk also the query ids
and the [Q, 8, 128] stacks) travel in one host->device copy per call.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch import native
from geomesa_tpu_torch.timing import NULL_CLOCK

LANES = 128
BLOCK = 16384  # default rows per scan block (4096 minimum: SUB % 32 == 0)
# candidate-block list sizes (static per table; the JAX package's ladder)
M_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)

# packed-time device column: one i32 tw = bin << TW_BITS | (offset >> period
# shift) replaces the (tbin, toff) pair (index.z3.PACKED_SHIFT)
TW_BITS = 16
TW_MASK = (1 << TW_BITS) - 1

# polygon legs (the JAX package's ladders): a query polygon's packed edge
# block pads to a static E (pack_edges declines past the largest bucket,
# and the query refines on host); its raster interval stack to a static R.
# A fused chunk carries one [Q, E, 128] edge stack and one [Q, 1 + R, 128]
# interval stack sized by the smaller fused ladders. The CUDA kernels loop
# at run time over each query's real edges and intervals, so every bucket
# runs there (the TPU's unrolled kernel capped E and R at 64).
E_BUCKETS = (16, 32, 64, 128, 256)
FUSED_E_BUCKETS = (16, 64, 256)
R_BUCKETS = (16, 32, 64, 256)
FUSED_R_BUCKETS = (16, 32, 64, 256)
# lanes the legs read: an edge row (y0, y1, x0, inverse slope, eps_x,
# eps_y), the raster header (x0, y0, 1/cell_w, 1/cell_h, nx, ny) and an
# interval row (lo, hi, cls)
EDGE_LANES = 6
RAST_HEAD_LANES = 6
RINT_LANES = 3

# kernel flag bits (csrc/masks.cuh)
_HAS_BOXES = 1
_HAS_WINDOWS = 2
_PACKED_TW = 4
_VALID_ON_T = 8
_HAS_EDGES = 16
_HAS_RAST = 32
_EXTENT = 64  # the box leg (and the aggregations' coordinates) read the extent columns
_VALID_ON_G = 128  # the validity leg reads gxmin

# the extent columns of XZ tables, in the kernels' argument order
EXTENT_COLS = ("gxmin", "gymin", "gxmax", "gymax")


# --------------------------------------------------------------- params


def pack_boxes(wide: np.ndarray | None, inner: np.ndarray | None) -> np.ndarray:
    """[8, 128] f32 param block: lanes 0-3 wide box, 4-7 inner box.

    Pad slots can never match: wide xmin=+inf/xmax=-inf. Overflow past the
    8 kernel slots takes the safe direction per plane: wide boxes collapse
    into their bounding union (superset -> refined), inner boxes drop the
    smallest (subset -> rows just lose the certainty shortcut).
    """
    p = np.zeros((8, LANES), np.float32)
    p[:, 0] = np.inf
    p[:, 2] = -np.inf
    p[:, 4] = np.inf
    p[:, 6] = -np.inf
    if wide is not None and len(wide):
        w = np.asarray(wide, np.float32)
        if len(w) > 8:
            union = np.array(
                [[w[7:, 0].min(), w[7:, 1].min(), w[7:, 2].max(), w[7:, 3].max()]],
                np.float32,
            )
            w = np.concatenate([w[:7], union])
        p[: len(w), 0:4] = w
    if inner is not None and len(inner):
        i = np.asarray(inner, np.float32)
        if len(i) > 8:
            areas = np.maximum(i[:, 2] - i[:, 0], 0) * np.maximum(i[:, 3] - i[:, 1], 0)
            i = i[np.argsort(-areas)[:8]]
        p[: len(i), 4:8] = i
    return p


def pack_windows(wide: np.ndarray | None, inner: np.ndarray | None) -> np.ndarray:
    """[8, 128] i32 param block: lanes 0-3 wide slot, 4-7 inner slot.

    A slot is (bin_lo, bin_hi, off_lo, off_hi), all inclusive: one interval
    covering bins [b0, b1] costs at most 3 slots (partial first bin,
    full-interior run, partial last bin). Pad slots have bin_lo=1 > bin_hi=0.
    """
    p = np.zeros((8, LANES), np.int32)
    p[:, 0] = 1
    p[:, 1] = 0
    p[:, 4] = 1
    p[:, 5] = 0
    if wide is not None and len(wide):
        p[: len(wide), 0:4] = wide
    if inner is not None and len(inner):
        p[: len(inner), 4:8] = inner
    return p


def merge_window_slots(
    windows: np.ndarray | None, overflow: str = "widen"
) -> np.ndarray | None:
    """Per-bin [W, 3] (bin, off_lo, off_hi) windows -> merged [k, 4] slots
    (bin_lo, bin_hi, off_lo, off_hi), consecutive bins with identical
    offset ranges collapsed into one slot.

    If k would exceed the 8 kernel slots, ``overflow`` picks the safe
    direction for the plane being built:
    - "widen" (wide plane): union adjacent slots — a *superset*, corrected
      by refinement;
    - "drop" (inner plane): discard the smallest slots — a *subset*, so no
      row is ever wrongly marked certain; dropped rows just get refined.
    """
    if windows is None or len(windows) == 0:
        return None
    w = np.asarray(windows)
    order = np.lexsort((w[:, 1], w[:, 0]))
    w = w[order]
    slots: list[list[int]] = []
    for b, lo, hi in w.tolist():
        if slots and slots[-1][1] == b - 1 and slots[-1][2] == lo and slots[-1][3] == hi:
            slots[-1][1] = b
        else:
            slots.append([b, b, lo, hi])
    if len(slots) > 8 and overflow == "drop":
        slots.sort(key=lambda s: (s[1] - s[0]) * (s[3] - s[2] + 1), reverse=True)
        slots = sorted(slots[:8])
    while len(slots) > 8:
        # widen: merge the two adjacent slots with the smallest bin gap
        gaps = [slots[i + 1][0] - slots[i][1] for i in range(len(slots) - 1)]
        i = int(np.argmin(gaps))
        a, b = slots[i], slots[i + 1]
        slots[i : i + 2] = [[a[0], b[1], min(a[2], b[2]), max(a[3], b[3])]]
    return np.array(slots, dtype=np.int32)


def merge_window_slots_wide(config) -> np.ndarray | None:
    return merge_window_slots(config.windows, overflow="widen")


def merge_window_slots_inner(config) -> np.ndarray | None:
    """Inner slots from config.windows_inner; None (no certainty) when the
    index did not compute inner windows. Degenerate inner windows
    (off_lo > off_hi) never match — their rows stay uncertain. Overflow
    drops slots (subset) — widening an inner window would mark non-hits
    certain."""
    if config.windows_inner is None:
        return None
    w = np.asarray(config.windows_inner)
    w = w[w[:, 1] <= w[:, 2]] if len(w) else w
    return merge_window_slots(w, overflow="drop") if len(w) else None


def fused_e_bucket(n: int) -> int:
    """Static fused-chunk edge bucket: the smallest FUSED_E_BUCKETS entry
    >= n, or 0 for a chunk with no polygon member."""
    if n <= 0:
        return 0
    return next(b for b in FUSED_E_BUCKETS if n <= b)


def fused_r_bucket(n: int) -> int:
    """Static fused-chunk interval bucket: the smallest FUSED_R_BUCKETS
    entry >= n, or 0 for a chunk with no raster member."""
    if n <= 0:
        return 0
    return next(b for b in FUSED_R_BUCKETS if n <= b)


def r_bucket_of(n: int) -> int:
    """Static single-query interval bucket (R_BUCKETS); run counts past
    the largest bucket coalesce into it (RasterApprox.pack_block)."""
    if n <= 0:
        return 0
    return next((b for b in R_BUCKETS if n <= b), R_BUCKETS[-1])


def n_rints_of(rast: "np.ndarray | None") -> int:
    """Interval-bucket size of a pack_block stack (row 0 is the grid
    header; 0 = no raster)."""
    return 0 if rast is None else rast.shape[0] - 1


def pack_edges(geom) -> "np.ndarray | None":
    """A Polygon/MultiPolygon's edges as the point-in-polygon leg's [E, 128]
    f32 block, or None when the geometry has more edges than the largest
    bucket. Lanes per edge k:

    0: y0   1: y1   2: x0   3: inverse slope (dx/dy; 0 for horizontals)
    4: eps_x (crossing-abscissa uncertainty, scaled by |islope|)
    5: eps_y (vertex-latitude uncertainty; 0 on pad rows)

    Even-odd parity over all rings (shells, holes, every part) is the
    test; rows within the eps bands are *near*: their f32 parity may
    differ from the f64 truth, so they come back uncertain and refine on
    host. Pad rows (zeros) never cross and are never near.
    """
    from geomesa_tpu_torch import geometry as geo

    rings = []
    if isinstance(geom, geo.Polygon):
        rings = [geom.shell] + list(geom.holes)
    elif isinstance(geom, geo.MultiPolygon):
        for p in geom.parts:
            rings.extend([p.shell] + list(p.holes))
    else:
        return None
    segs = []
    for r in rings:
        c = np.asarray(r, np.float64)
        if len(c) < 2:
            continue
        if c[0, 0] != c[-1, 0] or c[0, 1] != c[-1, 1]:
            c = np.vstack([c, c[:1]])  # close the ring
        segs.append(np.stack([c[:-1, 0], c[:-1, 1], c[1:, 0], c[1:, 1]], axis=1))
    if not segs:
        return None
    return pack_edge_segments(np.concatenate(segs))


def pack_edge_segments(e: np.ndarray) -> "np.ndarray | None":
    """:func:`pack_edges` from raw [n, 4] (x0, y0, x1, y1) segments over
    all rings, already concatenated."""
    n = len(e)
    if n == 0 or n > E_BUCKETS[-1]:
        return None
    E = next(b for b in E_BUCKETS if n <= b)
    out = np.zeros((E, LANES), np.float32)
    dy = e[:, 3] - e[:, 1]
    horizontal = dy == 0.0
    islope = np.where(horizontal, 0.0, (e[:, 2] - e[:, 0]) / np.where(horizontal, 1.0, dy))
    out[:n, 0] = e[:, 1]  # y0
    out[:n, 1] = e[:, 3]  # y1
    out[:n, 2] = e[:, 0]  # x0
    out[:n, 3] = islope
    # conservative f32-uncertainty bands (coordinates are degrees, so the
    # absolute ulp scale is bounded by ulp(360) ~ 2.7e-5): points whose
    # crossing decision could flip under f32 rounding land inside them
    out[:n, 4] = 1e-3 + 3e-5 * np.abs(islope)
    out[:n, 5] = 1e-4
    return out


def n_edges_of(edges: "np.ndarray | None") -> int:
    """Edge-bucket size of a pack_edges block (0 = no polygon)."""
    return 0 if edges is None else edges.shape[0]


def bucket_of(n: int) -> int:
    """Static M bucket for an n-block candidate list: the smallest fixed
    bucket >= n, or the next power of two past the largest bucket."""
    for m in M_BUCKETS:
        if n <= m:
            return m
    m = M_BUCKETS[-1]
    while m < n:
        m *= 2
    return m


def m_bucket_of(n: int) -> int:
    """Single-query candidate-list bucket: :func:`bucket_of` raised to the
    link-derived M floor (set_link_constants). The floor applies to this
    ladder only, never to the fused-chunk slot sizing that also derives
    from bucket_of (flooring slots would inflate small tables' chunks
    with pad-slot work)."""
    return max(bucket_of(n), int(_LINK_CONSTANTS["m_floor"]))


# -- the measured-link seam ------------------------------------------------
# Two floor-amortization constants re-derived from a measured pull RTT
# (dimensionless ratios against the 66 ms design link, so the rule gives
# the compiled values on a link like that one): the fused-chunk slot cap
# scales with the pull floor (a chunk must hold enough slots that one
# launch's fixed cost stays amortized), and the single-query M floor rises
# on a fast link (the 32/64 buckets only shave pull bytes on a slow one).
# With no profile installed and geomesa.scan.fused.slots unset, every
# shape is the compiled one.
DESIGN_LINK_RTT_MS = 66.0
_LINK_CONSTANTS = {
    "fused_chunk_slots": None,  # None = the compiled FUSED_CHUNK_SLOTS
    "m_floor": M_BUCKETS[0],
    "link_rtt_ms": None,
}


def derive_link_constants(rtt_ms: float, pull_mb_s: "float | None" = None) -> dict:
    """Pure derivation (no state change): the fused-chunk slot cap and the
    M-bucket floor a measured link profile calls for."""
    from geomesa_tpu_torch.storage.table import FUSED_CHUNK_SLOTS
    from geomesa_tpu_torch.tuning.primitives import doubling_ladder

    want = FUSED_CHUNK_SLOTS * max(float(rtt_ms), 1e-3) / DESIGN_LINK_RTT_MS
    slots = doubling_ladder(want, 256, FUSED_CHUNK_SLOTS)
    fast = rtt_ms <= 5.0 or (pull_mb_s is not None and pull_mb_s >= 200.0)
    return {
        "fused_chunk_slots": slots,
        "m_floor": 128 if fast else M_BUCKETS[0],
        "link_rtt_ms": round(float(rtt_ms), 2),
    }


def set_link_constants(constants: "dict | None") -> None:
    """Install (or, with None, reset) a derived link profile. Install it
    before tables are queried: the constants set launch shapes."""
    if constants is None:
        _LINK_CONSTANTS.update(fused_chunk_slots=None, m_floor=M_BUCKETS[0], link_rtt_ms=None)
    else:
        _LINK_CONSTANTS.update(constants)


def link_constants() -> dict:
    """The active link-derived constants."""
    from geomesa_tpu_torch.storage.table import FUSED_CHUNK_SLOTS

    out = dict(_LINK_CONSTANTS)
    if out["fused_chunk_slots"] is None:
        out["fused_chunk_slots"] = FUSED_CHUNK_SLOTS
    return out


def fused_slot_cap(local_cap: "int | None" = None) -> int:
    """The fused-chunk slot cap in force (IndexTable.fused_slots clamps it
    to the table's own block-count bucket): the ``geomesa.scan.fused.slots``
    knob when pinned nonzero (how the tuning tier's fused_chunk_slots
    controller actuates), else ``local_cap`` (a per-host probed cap), else
    the installed link constants, else the compiled default."""
    from geomesa_tpu_torch import conf

    pinned = int(conf.SCAN_FUSED_SLOTS.get() or 0)
    if pinned > 0:
        return pinned
    if local_cap is not None:
        return int(local_cap)
    cap = _LINK_CONSTANTS["fused_chunk_slots"]
    if cap is not None:
        return int(cap)
    from geomesa_tpu_torch.storage.table import FUSED_CHUNK_SLOTS

    return FUSED_CHUNK_SLOTS


def pad_bids(
    blocks: np.ndarray, n_blocks_table: int, pad: int = 0, bucket: int | None = None
) -> tuple[np.ndarray, int]:
    """Pad a sorted block-id list to a static M bucket (m_bucket_of).
    Returns (padded [M] i32, n_real).

    ``pad=0`` repeats block 0 (scan kernels: the decode ignores pad slots);
    ``pad=-1`` marks pads explicitly (aggregation kernels mask them).
    ``bucket`` forces the bucket.
    """
    n = len(blocks)
    m = bucket if bucket is not None else m_bucket_of(n)
    out = np.full(m, pad, np.int32)
    out[:n] = blocks
    return out, n


# the packers' pad slots (lanes 0-7), which no row can match
_PAD_BOX = np.array([np.inf, 0, -np.inf, 0, np.inf, 0, -np.inf, 0], np.float32)
_PAD_WIN = np.array([1, 0, 0, 0, 1, 0, 0, 0], np.int32)


def active_slots(slots: np.ndarray, pad: np.ndarray) -> int:
    """Slots before the trailing run of pad slots: the kernels loop over
    these only, which leaves the planes unchanged since a pad slot never
    matches."""
    return int(active_slots_many(np.asarray(slots)[None], pad)[0])


def active_slots_many(slots: np.ndarray, pad: np.ndarray) -> np.ndarray:
    """:func:`active_slots` of every query of a [Q, k, 8] slot stack."""
    return _rows_before_pad(~np.all(slots == pad, axis=-1))


def _rows_before_pad(real: np.ndarray) -> np.ndarray:
    """Per query of a [Q, k] "row does something" mask: the rows before
    the trailing run of rows that do nothing."""
    if real.shape[1] == 0:
        return np.zeros(real.shape[0], np.int32)
    last = real.shape[1] - np.argmax(real[:, ::-1], axis=1)
    return np.where(real.any(axis=1), last, 0).astype(np.int32)


def active_edges_many(edges: np.ndarray) -> np.ndarray:
    """Real edges of each [E, 128] block of a [Q, E, 128] stack: the rows
    before the trailing run of all-zero rows (pad rows never cross and are
    never near, so the legs loop over the real edges only)."""
    e = np.asarray(edges, np.float32)[..., :EDGE_LANES]
    return _rows_before_pad(np.any(e != 0, axis=-1))


def active_rints_many(rasts: np.ndarray) -> np.ndarray:
    """Real intervals of each [1 + R, 128] block of a [Q, 1 + R, 128]
    stack: the rows before the trailing run of rows that never match
    (lo > hi, as pack_block pads) or never classify (cls 0, as a chunk's
    zero padding)."""
    r = np.asarray(rasts, np.float32)[:, 1:, :RINT_LANES]
    return _rows_before_pad((r[..., 0] <= r[..., 1]) & (r[..., 2] != 0))


def slot_words(boxes, wins) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(box slots [8, 8] f32, window slots [8, 8] i32, [active box slots,
    active window slots] i32): lanes 0-7 of the packed param blocks."""
    box8 = np.ascontiguousarray(np.asarray(boxes, np.float32)[:, :8])
    win8 = np.ascontiguousarray(np.asarray(wins, np.int32)[:, :8])
    counts = np.array([active_slots(box8, _PAD_BOX), active_slots(win8, _PAD_WIN)], np.int32)
    return box8, win8, counts


def stage_params(bids, boxes, wins, extra_f32=None, poly=None) -> np.ndarray:
    """One int32 host buffer per query: bids[m] | box slots [8][8] (f32
    bits) | window slots [8][8] | active box and window slot counts |
    optional f32 words, or the query's polygon block (``poly``, from
    :func:`poly_words`) (csrc/masks.cuh)."""
    box8, win8, counts = slot_words(boxes, wins)
    parts = [np.asarray(bids, np.int32).ravel(), box8.view(np.int32).ravel(), win8.ravel(), counts]
    if extra_f32 is not None:
        parts.append(np.ascontiguousarray(extra_f32, np.float32).view(np.int32).ravel())
    if poly is not None:
        parts.append(np.asarray(poly, np.int32).ravel())
    return np.concatenate(parts)


def stage_multi_params(bids, qids, boxes, wins, spip=None, poly=None) -> np.ndarray:
    """One int32 host buffer per fused chunk: bids[m] | qids[m] | (spip[m]
    when the chunk carries polygon stacks) | box slots [Q][8][8] (f32
    bits) | window slots [Q][8][8] | active box and window slot counts
    [Q][2] | (the polygon blocks [q][words] of :func:`poly_words`), from
    [Q, 8, 128] param stacks (csrc/masks.cuh)."""
    box8 = np.ascontiguousarray(np.asarray(boxes, np.float32)[:, :, :8])
    win8 = np.ascontiguousarray(np.asarray(wins, np.int32)[:, :, :8])
    counts = np.stack(
        [active_slots_many(box8, _PAD_BOX), active_slots_many(win8, _PAD_WIN)], axis=1
    )
    parts = [np.asarray(bids, np.int32).ravel(), np.asarray(qids, np.int32).ravel()]
    if spip is not None:
        parts.append(np.asarray(spip, np.int32).ravel())
    parts += [box8.view(np.int32).ravel(), win8.ravel(), counts.ravel()]
    if poly is not None:
        parts.append(np.asarray(poly, np.int32).ravel())
    return np.concatenate(parts)


def poly_words(edges, rasts, e_cap: int, r_cap: int) -> np.ndarray:
    """[Q, 2 + 6 e_cap + 6 + 3 r_cap] int32 polygon blocks of a [Q, E, 128]
    edge stack and a [Q, 1 + R, 128] raster stack (either None): per query
    its real edge and interval counts, the six used lanes of its first
    ``e_cap`` edges, the raster header's six lanes and the three used lanes
    of its first ``r_cap`` intervals, as f32 bits (csrc/masks.cuh). Only
    these lanes travel, never the 128-lane rows; caps must cover every
    query's real counts."""
    q = (edges if edges is not None else rasts).shape[0]
    counts = np.zeros((q, 2), np.int32)
    e6 = np.zeros((q, e_cap, EDGE_LANES), np.float32)
    head = np.zeros((q, RAST_HEAD_LANES), np.float32)
    r3 = np.zeros((q, r_cap, RINT_LANES), np.float32)
    if edges is not None:
        edges = np.asarray(edges, np.float32)
        counts[:, 0] = active_edges_many(edges)
        k = min(e_cap, edges.shape[1])
        e6[:, :k] = edges[:, :k, :EDGE_LANES]
    if rasts is not None:
        rasts = np.asarray(rasts, np.float32)
        counts[:, 1] = active_rints_many(rasts)
        head[:] = rasts[:, 0, :RAST_HEAD_LANES]
        k = min(r_cap, rasts.shape[1] - 1)
        r3[:, :k] = rasts[:, 1 : 1 + k, :RINT_LANES]
    if (counts[:, 0] > e_cap).any() or (counts[:, 1] > r_cap).any():
        raise ValueError(f"polygon blocks exceed their caps (E {e_cap}, R {r_cap})")
    return np.concatenate([
        counts, e6.reshape(q, -1).view(np.int32), head.view(np.int32),
        r3.reshape(q, -1).view(np.int32),
    ], axis=1)


def bucket_q(q: int) -> int:
    """Static Q bucket: power of two >= q, floor 8. For hand-built param
    stacks in tests; the table pads every fused chunk's stacks to
    FUSED_CHUNK_Q (storage.table). Pad query rows are all-zero params no
    slot references (pad slots carry qid 0 and are ignored at decode)."""
    m = 8
    while m < q:
        m *= 2
    return m


# ------------------------------------------------------- plain PyTorch


def _slot_lanes(p, k: int):
    """Lanes 0-7 of slot ``k`` of a [k, 128] param block (scalars), or of
    per-slot [M, k, 128] blocks (one [M, 1, 1] value each)."""
    v = p[..., k, :8]
    if v.dim() == 1:
        return v.unbind()
    return v.reshape(-1, 1, 1, 8).unbind(-1)


def _pip_plain(x, y, edges):
    """(parity, near) even-odd ray cast against every row of an [E, 128]
    edge block (or [M, E, 128], one per gathered block), in the op order
    of the JAX package's ``_pip_edge_step``."""
    parity = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    near = torch.zeros_like(parity)
    for k in range(edges.shape[-2]):
        y0, y1, x0, isl, ex, ey = _slot_lanes(edges, k)[:EDGE_LANES]
        in_win = (y0 > y) != (y1 > y)
        xc = x0 + (y - y0) * isl
        parity ^= in_win & (x < xc)
        near |= ((y - y0).abs() < ey) | ((y - y1).abs() < ey) | (in_win & ((x - xc).abs() < ex))
    return parity, near


def _raster_plain(x, y, rast):
    """(full, part) cell classification against every interval row of a
    [1 + R, 128] raster block (or [M, 1 + R, 128]), in the op order of the
    JAX package's ``_raster_cell`` and ``_rint_step``. Sentinel pad rows
    (x = inf) and a zero header (nx = ny = 0) fall outside the grid."""
    x0, y0, icx, icy, nx, ny = _slot_lanes(rast, 0)[:RAST_HEAD_LANES]
    cx = torch.floor((x - x0) * icx)
    cy = torch.floor((y - y0) * icy)
    in_grid = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
    c = cy * nx + cx
    full = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    part = torch.zeros_like(full)
    for k in range(rast.shape[-2] - 1):
        lo, hi, cl = _slot_lanes(rast, k + 1)[:RINT_LANES]
        hit = in_grid & (c >= lo) & (c <= hi)
        full |= hit & (cl > 0)
        part |= hit & (cl < 0)
    return full, part


def _polygon_legs(x, y, edges, rast):
    """(wide, inner) of the point-in-polygon and raster legs, as the JAX
    package's ``_masks`` combines them: raster alone, full | part and
    full; PIP alone, parity | near and parity & ~near; both, the PIP
    decides the partial cells."""
    if rast is not None:
        full, part = _raster_plain(x, y, rast)
        if edges is None:
            return full | part, full
        parity, near = _pip_plain(x, y, edges)
        return full | (part & (parity | near)), full | (part & parity & ~near)
    parity, near = _pip_plain(x, y, edges)
    return parity | near, parity & ~near


def masks_plain(cols: dict, boxes, wins, has_boxes: bool, has_windows: bool,
                edges=None, rast=None, extent: bool = False):
    """(wide, inner) bool tensors for gathered column blocks: the legs of
    the JAX package's ``_masks`` (box, extent, window, packed-time,
    validity, and the point-in-polygon and raster legs, which replace the
    box leg). ``boxes``/``wins`` are [k, 128] slot blocks (k = 8 from the
    packers), ``edges`` an [E, 128] and ``rast`` a [1 + R, 128] block, or
    each with a leading [M] axis, one per gathered block; tensors on the
    columns' device, ``edges``/``rast`` None when the leg is off.
    ``extent``: the box leg is bbox-intersects over the extent columns,
    and its inner plane is all false."""
    w_parts, i_parts = [], []
    if edges is not None or rast is not None:
        wide, inner = _polygon_legs(cols["x"], cols["y"], edges, rast)
        w_parts.append(wide)
        i_parts.append(inner)
    elif has_boxes and extent:
        gx0, gy0, gx1, gy1 = (cols[k] for k in EXTENT_COLS)
        hit = torch.zeros(gx0.shape, dtype=torch.bool, device=gx0.device)
        for k in range(boxes.shape[-2]):
            b = _slot_lanes(boxes, k)
            hit |= (gx0 <= b[2]) & (gx1 >= b[0]) & (gy0 <= b[3]) & (gy1 >= b[1])
        w_parts.append(hit)
        i_parts.append(torch.zeros_like(hit))
    elif has_boxes:
        x, y = cols["x"], cols["y"]
        wide = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        inner = torch.zeros_like(wide)
        for k in range(boxes.shape[-2]):
            b = _slot_lanes(boxes, k)
            wide |= (x >= b[0]) & (x <= b[2]) & (y >= b[1]) & (y <= b[3])
            inner |= (x >= b[4]) & (x <= b[6]) & (y >= b[5]) & (y <= b[7])
        w_parts.append(wide)
        i_parts.append(inner)
    if has_windows:
        if "tw" in cols:
            tw = cols["tw"]
            # arithmetic shift: the pad sentinel -1 keeps bin -1
            tb = tw >> TW_BITS
            to = tw & TW_MASK
        else:
            tb, to = cols["tbin"], cols["toff"]
        wide = torch.zeros(tb.shape, dtype=torch.bool, device=tb.device)
        inner = torch.zeros_like(wide)
        for k in range(wins.shape[-2]):
            s = _slot_lanes(wins, k)
            wide |= (tb >= s[0]) & (tb <= s[1]) & (to >= s[2]) & (to <= s[3])
            inner |= (tb >= s[4]) & (tb <= s[5]) & (to >= s[6]) & (to <= s[7])
        w_parts.append(wide)
        i_parts.append(inner)
    if not w_parts:
        # no predicate: the row-validity test (pad rows carry sentinels)
        if "x" in cols:
            v = torch.isfinite(cols["x"])
        elif "gxmin" in cols:
            v = torch.isfinite(cols["gxmin"])
        elif "tw" in cols:
            v = cols["tw"] >= 0
        else:
            v = cols["tbin"] >= 0
        return v, v
    w, i = w_parts[0], i_parts[0]
    for p, q in zip(w_parts[1:], i_parts[1:]):
        w = w & p
        i = i & q
    return w, i


def skip_inner_plane(has_boxes: bool, extent: bool) -> bool:
    """Extent box scans have an identically false inner plane (bbox
    intersection never certifies the true geometry predicate), so the
    kernels write only the wide plane and the host pulls only it (the
    JAX package's rule)."""
    return extent and has_boxes


def pack_bits_plain(m: torch.Tensor) -> torch.Tensor:
    """[M, SUB, 128] bool -> [M, SUB/32, 128] int32: bit b of word
    [j, lane] is local row (j*32 + b)*128 + lane."""
    n, sub, _ = m.shape
    u = m.reshape(n, sub // 32, 32, LANES).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=m.device).view(1, 1, 32, 1)
    v = (u << shifts).sum(dim=2)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def block_scan_plain(cols: dict, bids, boxes, wins, *, has_boxes, has_windows,
                     edges=None, rast=None, extent=False):
    """Plain PyTorch scan: gather the candidate blocks, apply the legs,
    pack bits. ``bids``/``boxes``/``wins`` (and ``edges`` [E, 128] and
    ``rast`` [1 + R, 128] where the polygon legs are on) are tensors on the
    columns' device. Returns (wide, inner) int32 [M, SUB/32, 128]; inner is
    None where :func:`skip_inner_plane` (extent box scans)."""
    b = bids.to(torch.int64)
    gathered = {k: v[b] for k, v in cols.items()}
    w, i = masks_plain(gathered, boxes, wins, has_boxes, has_windows, edges, rast, extent)
    if skip_inner_plane(has_boxes, extent):
        return pack_bits_plain(w), None
    return pack_bits_plain(w), pack_bits_plain(i)


def block_scan_multi_plain(cols: dict, bids, qids, boxes, wins, *, has_boxes, has_windows,
                           edges=None, rasts=None, spip=None, extent=False):
    """Plain PyTorch fused scan: slot i gathers block ``bids[i]`` and
    query ``qids[i]``'s [8, 128] param blocks out of the [Q, 8, 128]
    stacks, then the single-query legs per slot. With a [Q, E, 128]
    ``edges`` or [Q, 1 + R, 128] ``rasts`` stack, a slot whose ``spip`` is
    > 0 takes the polygon legs with its query's blocks instead of the box
    leg. Tensors on the columns' device. Returns (wide, inner) int32
    [M, SUB/32, 128]; inner is None where :func:`skip_inner_plane`."""
    b = bids.to(torch.int64)
    q = qids.to(torch.int64)
    gathered = {k: v[b] for k, v in cols.items()}
    bq, wq = boxes[q], wins[q]
    w, i = masks_plain(gathered, bq, wq, has_boxes, has_windows, extent=extent)
    if edges is not None or rasts is not None:
        wp, ip = masks_plain(
            gathered, bq, wq, has_boxes, has_windows,
            None if edges is None else edges[q], None if rasts is None else rasts[q],
        )
        sel = (spip > 0).view(-1, 1, 1)
        w = torch.where(sel, wp, w)
        i = torch.where(sel, ip, i)
    if skip_inner_plane(has_boxes, extent):
        return pack_bits_plain(w), None
    return pack_bits_plain(w), pack_bits_plain(i)


# ------------------------------------------------------- CUDA wrapper


def device_of(cols3) -> torch.device:
    devs = {c.device for c in cols3}
    if len(devs) != 1:
        raise ValueError(f"columns span devices {sorted(map(str, devs))}")
    return devs.pop()


# the kernels' shared-memory capacity for one query's polygon blocks
# (csrc/masks.cuh GM_MAX_EDGES, GM_MAX_RINTS): the largest buckets
MAX_EDGES = E_BUCKETS[-1]
MAX_RINTS = R_BUCKETS[-1]


def polygon_blocks(edges, n_edges: int, rast, n_rints: int, stacked: bool = False):
    """(edges, rast) as f32 numpy blocks, each None where its leg is off
    (a leg is on when its static size is > 0, as in the JAX package),
    checked against the kernels' capacity: [n_edges, 128] and
    [1 + n_rints, 128], or with a leading query axis when ``stacked``."""
    out = []
    for block, n, head, cap, name in (
        (edges, n_edges, 0, MAX_EDGES, "edges"), (rast, n_rints, 1, MAX_RINTS, "rast"),
    ):
        if not n:
            out.append(None)
            continue
        if n > cap:
            raise ValueError(f"{name}: {n} rows exceed the kernels' {cap}")
        a = np.asarray(block, np.float32)
        if a.shape[-2:] != (head + n, LANES) or a.ndim != (3 if stacked else 2):
            raise ValueError(f"{name} block must be [{'Q, ' if stacked else ''}"
                             f"{head + n}, {LANES}]: {a.shape}")
        out.append(a)
    return tuple(out)


def _poly_flags(edges, rast) -> int:
    return (_HAS_EDGES if edges is not None else 0) | (_HAS_RAST if rast is not None else 0)


def leg_name(flags: int) -> "str | None":
    """The counter a launch with kernel ``flags`` bumps besides its
    kernel's (kernels/build.py): 'pip', 'raster' or 'pip+raster' for the
    polygon legs, 'extent' where it reads the extent columns; None for the
    point box, window and validity legs."""
    if flags & (_EXTENT | _VALID_ON_G):
        return "extent"
    return {_HAS_EDGES: "pip", _HAS_RAST: "raster", _HAS_EDGES | _HAS_RAST: "pip+raster"}.get(
        flags & (_HAS_EDGES | _HAS_RAST)
    )


def kernel_columns(cols: dict, has_boxes: bool, has_windows: bool, need_xy: bool = False,
                   extent: bool = False):
    """Validated column pointers + flags for the kernels: (pointers,
    flags, sub, n_blocks), the pointers (x, y, gxmin, gymin, gxmax, gymax,
    t0, t1), None for a column the launch does not read. Columns are
    contiguous [n_blocks, SUB, 128] tensors, f32 coordinates and extents,
    i32 time parts. ``need_xy``: a leg other than the box leg reads the
    coordinates (the polygon legs; the aggregations' representative
    point). ``extent``: the coordinates are the extent columns (the box
    leg is bbox-intersects, the representative point the bbox centre)."""
    shapes = {tuple(c.shape) for c in cols.values()}
    if len(shapes) != 1:
        raise ValueError(f"columns disagree on shape: {sorted(shapes)}")
    shape = shapes.pop()
    if len(shape) != 3 or shape[2] != LANES or shape[1] % 32:
        raise ValueError(f"columns must be [n_blocks, SUB, 128] with SUB % 32 == 0: {shape}")
    for name, c in cols.items():
        want = torch.float32 if name in ("x", "y", *EXTENT_COLS) else torch.int32
        if c.dtype != want or not c.is_contiguous():
            raise ValueError(f"column {name!r} must be contiguous {want}: {c.dtype}")
    flags = (_HAS_BOXES if has_boxes else 0) | (_HAS_WINDOWS if has_windows else 0)
    coords = EXTENT_COLS if extent else ("x", "y")
    if (has_boxes or need_xy) and not set(coords) <= set(cols):
        raise ValueError(f"the box leg reads columns {', '.join(coords)}")
    if extent and (has_boxes or need_xy):
        flags |= _EXTENT
    t0 = t1 = None
    if "tw" in cols:
        t0 = cols["tw"]
        flags |= _PACKED_TW
    elif "tbin" in cols:
        t0, t1 = cols["tbin"], cols.get("toff")
    if has_windows and (t0 is None or (not flags & _PACKED_TW and t1 is None)):
        raise ValueError("the window leg reads tw, or tbin and toff")
    if not (has_boxes or has_windows) and "x" not in cols:
        if "gxmin" in cols:
            flags |= _VALID_ON_G
        elif t0 is None:
            raise ValueError("the validity leg reads x, gxmin, tw or tbin")
        else:
            flags |= _VALID_ON_T

    def ptr(t):
        return None if t is None else t.data_ptr()

    ptrs = tuple(ptr(cols.get(k)) for k in ("x", "y", *EXTENT_COLS)) + (ptr(t0), ptr(t1))
    return ptrs, flags, shape[1], shape[0]


def check_aligned(cols: dict) -> None:
    """The scan kernels read each column 16 bytes at a time from every
    block's base (csrc/scan_tile.cuh): a column must start on 16 bytes,
    as a tensor of its own does (a view at an offset may not)."""
    for name, c in cols.items():
        if c.data_ptr() % 16:
            raise ValueError(f"column {name!r} is not 16-byte aligned: {c.data_ptr():#x}")


def check_bids(bids: np.ndarray, n_blocks: int, allow_pad: bool) -> None:
    lo = -1 if allow_pad else 0
    if len(bids) and (int(bids.min()) < lo or int(bids.max()) >= n_blocks):
        raise ValueError(f"block ids outside [{lo}, {n_blocks})")


def upload_params(staged: np.ndarray, device: torch.device, clock=NULL_CLOCK) -> torch.Tensor:
    """The query's one host->device copy."""
    with clock.device("h2d", device):
        return torch.from_numpy(staged).to(device)


def _stack_planes(w, i) -> torch.Tensor:
    """The planes of one scan as one tensor [n_planes, M, SUB/32, 128]:
    (wide, inner), or (wide,) where there is no inner plane."""
    return w[None] if i is None else torch.stack([w, i])


def _check_extent_legs(extent: bool, edges, rast) -> None:
    if extent and (edges is not None or rast is not None):
        raise ValueError("the polygon legs read points: extent tables take the box leg")


def scan_planes(
    cols3, bids, boxes, wins, *, col_names, has_boxes, has_windows,
    extent=False, edges=None, n_edges=0, rast=None, n_rints=0, clock=NULL_CLOCK,
) -> torch.Tensor:
    """The planes in one int32 tensor [n_planes, M, SUB/32, 128] on the
    columns' device, so the host pulls them in one copy: (wide, inner), or
    (wide,) alone for an extent box scan (:func:`skip_inner_plane`).
    ``bids``/``boxes``/``wins`` are numpy arrays (block ids [M]; [8, 128]
    param blocks); ``edges`` [n_edges, 128] and ``rast`` [1 + n_rints, 128]
    turn on the point-in-polygon and raster legs; ``extent``: the box leg
    is bbox-intersects over the extent columns."""
    edges, rast = polygon_blocks(edges, n_edges, rast, n_rints)
    _check_extent_legs(extent, edges, rast)
    cols = dict(zip(col_names, cols3))
    device = device_of(cols3)
    bids = np.asarray(bids, np.int32)
    if device.type == "cpu":
        with clock.device("kernel", device):
            return _stack_planes(*block_scan_plain(
                cols, torch.from_numpy(bids),
                torch.as_tensor(np.asarray(boxes, np.float32)),
                torch.as_tensor(np.asarray(wins, np.int32)),
                has_boxes=has_boxes, has_windows=has_windows,
                edges=None if edges is None else torch.from_numpy(edges),
                rast=None if rast is None else torch.from_numpy(rast), extent=extent,
            ))
    planes, launch = scan_launcher(
        cols, bids, boxes, wins, has_boxes=has_boxes, has_windows=has_windows,
        edges=edges, rast=rast, extent=extent, clock=clock,
    )
    with clock.device("kernel", device):
        launch()
    return planes


def _plane_ptrs(planes: torch.Tensor):
    """(wide, inner) data pointers of a [n_planes, ...] planes tensor; the
    inner pointer is None (the kernel writes no inner plane) when there is
    one plane."""
    return planes[0].data_ptr(), planes[1].data_ptr() if len(planes) == 2 else None


def scan_launcher(cols: dict, bids, boxes, wins, *, has_boxes, has_windows,
                  edges=None, rast=None, extent=False, clock=NULL_CLOCK):
    """Stage one CUDA scan: check the columns and block ids, copy the
    params (and the polygon blocks' used lanes, ``edges`` [E, 128] and
    ``rast`` [1 + R, 128] or None) to the card (the query's one
    host->device copy) and allocate the planes. Returns (planes
    [n_planes, M, SUB/32, 128], launch): each launch() runs the kernel on
    the current stream into ``planes``."""
    device = device_of(tuple(cols.values()))
    if device.type != "cuda":
        raise ValueError(f"no scan kernel for device {device}")
    from geomesa_tpu_torch.kernels import BLOCK_SCAN

    _check_extent_legs(extent, edges, rast)
    poly_flags = _poly_flags(edges, rast)
    ptrs, flags, sub, n_blocks = kernel_columns(
        cols, has_boxes, has_windows, need_xy=bool(poly_flags), extent=extent
    )
    flags |= poly_flags
    check_aligned(cols)
    bids = np.asarray(bids, np.int32)
    check_bids(bids, n_blocks, allow_pad=False)
    m = len(bids)
    poly = None
    e_cap = r_cap = 0
    if poly_flags:
        # one query: the caps are its real counts, so only real rows travel
        e_cap = int(active_edges_many(edges[None])[0]) if edges is not None else 0
        r_cap = int(active_rints_many(rast[None])[0]) if rast is not None else 0
        poly = poly_words(
            None if edges is None else edges[None], None if rast is None else rast[None],
            e_cap, r_cap,
        )
    n_planes = 1 if skip_inner_plane(has_boxes, extent) else 2
    with torch.cuda.device(device):
        params = upload_params(stage_params(bids, boxes, wins, poly=poly), device, clock)
        planes = torch.empty((n_planes, m, sub // 32, LANES), dtype=torch.int32, device=device)

    def launch() -> None:
        BLOCK_SCAN.launch(
            *ptrs, params.data_ptr(), m, sub, flags, e_cap, r_cap, *_plane_ptrs(planes),
            torch.cuda.current_stream(device).cuda_stream, leg=leg_name(flags),
        )

    return planes, launch


def block_scan(
    cols3, bids, boxes, wins, *, col_names, has_boxes, has_windows,
    extent=False, edges=None, n_edges=0, rast=None, n_rints=0,
):
    """The JAX package's ``block_scan`` contract: (wide, inner) int32
    planes [M, SUB/32, 128] on the columns' device; inner is None where
    :func:`skip_inner_plane` (extent box scans)."""
    planes = scan_planes(
        cols3, bids, boxes, wins, col_names=col_names, has_boxes=has_boxes,
        has_windows=has_windows, extent=extent, edges=edges, n_edges=n_edges,
        rast=rast, n_rints=n_rints,
    )
    return planes[0], planes[1] if len(planes) == 2 else None


# ------------------------------------------------ fused multi-query scan


def scan_planes_multi(
    cols3, bids, qids, boxes, wins, *, col_names, has_boxes, has_windows,
    extent=False, edges=None, spip=None, n_edges=0, rasts=None, n_rints=0,
    clock=NULL_CLOCK,
) -> torch.Tensor:
    """Fused form of :func:`scan_planes`: slot i scans block ``bids[i]``
    with query ``qids[i]``'s params from the [Q, 8, 128] ``boxes``/``wins``
    stacks (numpy). With a [Q, n_edges, 128] ``edges`` or
    [Q, 1 + n_rints, 128] ``rasts`` stack, slot i takes the polygon legs
    with its query's blocks where ``spip[i]`` > 0 and the box leg
    elsewhere. The planes in one int32 tensor [n_planes, M, SUB/32, 128]
    on the columns' device (one plane for an extent box chunk); each
    query's rows decode from its own slot segment."""
    edges, rasts = polygon_blocks(edges, n_edges, rasts, n_rints, stacked=True)
    _check_extent_legs(extent, edges, rasts)
    cols = dict(zip(col_names, cols3))
    device = device_of(cols3)
    bids = np.asarray(bids, np.int32)
    qids = np.asarray(qids, np.int32)
    if edges is not None or rasts is not None:
        spip = np.asarray(spip, np.int32)
        if spip.shape != bids.shape:
            raise ValueError(f"bids {bids.shape} and spip {spip.shape} differ")
    else:
        spip = None  # no polygon stack: every slot takes the box leg
    if device.type == "cpu":
        with clock.device("kernel", device):
            return _stack_planes(*block_scan_multi_plain(
                cols, torch.from_numpy(bids), torch.from_numpy(qids),
                torch.as_tensor(np.asarray(boxes, np.float32)),
                torch.as_tensor(np.asarray(wins, np.int32)),
                has_boxes=has_boxes, has_windows=has_windows,
                edges=None if edges is None else torch.from_numpy(edges),
                rasts=None if rasts is None else torch.from_numpy(rasts),
                spip=None if spip is None else torch.from_numpy(spip), extent=extent,
            ))
    planes, launch = multi_launcher(
        cols, bids, qids, boxes, wins, has_boxes=has_boxes, has_windows=has_windows,
        edges=edges, rasts=rasts, spip=spip, extent=extent, clock=clock,
    )
    with clock.device("kernel", device):
        launch()
    return planes


def multi_launcher(cols: dict, bids, qids, boxes, wins, *, has_boxes, has_windows,
                   edges=None, rasts=None, spip=None, extent=False, clock=NULL_CLOCK):
    """Stage one CUDA fused scan: check the columns, block and query ids,
    copy the chunk's params (and, with an ``edges`` [Q, E, 128] or
    ``rasts`` [Q, 1 + R, 128] stack, ``spip`` and the used lanes of the
    polygon blocks of the queries its polygon slots read) to the card (its
    one host->device copy) and allocate the planes. Returns (planes
    [n_planes, M, SUB/32, 128], launch)."""
    device = device_of(tuple(cols.values()))
    if device.type != "cuda":
        raise ValueError(f"no fused scan kernel for device {device}")
    from geomesa_tpu_torch.kernels import BLOCK_SCAN_MULTI

    _check_extent_legs(extent, edges, rasts)
    poly_flags = _poly_flags(edges, rasts)
    ptrs, flags, sub, n_blocks = kernel_columns(
        cols, has_boxes, has_windows, need_xy=bool(poly_flags), extent=extent
    )
    flags |= poly_flags
    check_aligned(cols)
    bids = np.asarray(bids, np.int32)
    qids = np.asarray(qids, np.int32)
    boxes = np.asarray(boxes, np.float32)
    wins = np.asarray(wins, np.int32)
    n_q = boxes.shape[0]
    if boxes.shape != (n_q, 8, LANES) or wins.shape != boxes.shape:
        raise ValueError(f"param stacks must be [Q, 8, 128]: {boxes.shape}, {wins.shape}")
    if qids.shape != bids.shape:
        raise ValueError(f"bids {bids.shape} and qids {qids.shape} differ")
    check_bids(bids, n_blocks, allow_pad=False)
    if len(qids) and (int(qids.min()) < 0 or int(qids.max()) >= n_q):
        raise ValueError(f"query ids outside [0, {n_q})")
    m = len(bids)
    poly = None
    e_cap = r_cap = 0
    if poly_flags:
        for stack in (edges, rasts):
            if stack is not None and stack.shape[0] != n_q:
                raise ValueError(f"polygon stack of {stack.shape[0]} queries, params of {n_q}")
        spip = np.asarray(spip, np.int32)
        # the chunk's buckets set the per-query stride; only the queries
        # its polygon slots read travel
        e_cap = 0 if edges is None else edges.shape[1]
        r_cap = 0 if rasts is None else rasts.shape[1] - 1
        used = qids[spip > 0]
        n_used = int(used.max()) + 1 if len(used) else 0
        poly = poly_words(
            None if edges is None else edges[:n_used], None if rasts is None else rasts[:n_used],
            e_cap, r_cap,
        )
    n_planes = 1 if skip_inner_plane(has_boxes, extent) else 2
    with torch.cuda.device(device):
        params = upload_params(
            stage_multi_params(bids, qids, boxes, wins, spip=spip if poly_flags else None,
                               poly=poly),
            device, clock,
        )
        planes = torch.empty((n_planes, m, sub // 32, LANES), dtype=torch.int32, device=device)

    def launch() -> None:
        BLOCK_SCAN_MULTI.launch(
            *ptrs, params.data_ptr(), m, n_q, sub, flags, e_cap, r_cap, *_plane_ptrs(planes),
            torch.cuda.current_stream(device).cuda_stream, leg=leg_name(flags),
        )

    return planes, launch


def block_scan_multi(
    cols3, bids, qids, boxes, wins, *, col_names, has_boxes, has_windows,
    extent=False, edges=None, spip=None, n_edges=0, rasts=None, n_rints=0,
):
    """The JAX package's ``block_scan_multi`` contract: (wide, inner)
    int32 planes [M, SUB/32, 128] on the columns' device; inner is None
    where :func:`skip_inner_plane`."""
    planes = scan_planes_multi(
        cols3, bids, qids, boxes, wins, col_names=col_names, has_boxes=has_boxes,
        has_windows=has_windows, extent=extent, edges=edges, spip=spip,
        n_edges=n_edges, rasts=rasts, n_rints=n_rints,
    )
    return planes[0], planes[1] if len(planes) == 2 else None


# --------------------------------------------------------------- decode


def unpack_plane(plane: np.ndarray, n_real: int) -> np.ndarray:
    """[M, pack, 128] i32 plane -> [n_real, block] bool rows (inverts the
    packing: bit b of word [blk, j, lane] = local row (j*32+b)*128+lane)."""
    pack = plane.shape[1]
    p = np.ascontiguousarray(plane[:n_real])
    bits = np.unpackbits(
        p.view(np.uint8).reshape(n_real, pack, LANES, 4), axis=-1, bitorder="little"
    )  # [m, pack, 128, 32]
    return bits.transpose(0, 1, 3, 2).reshape(n_real, pack * 32 * LANES)


def decode_bits_pair(wide_plane, inner_plane, bids, n_real):
    """(rows, certain) — rows ascending, certain[i] True when row i is in
    the inner plane (no host refinement needed). ``inner_plane=None``
    (extent box scans, :func:`skip_inner_plane`) decodes the wide plane
    alone with certain all False. The planes are host int32 arrays; the
    native decode (``native.bitmask_decode_pair`` / ``bitmask_decode``)
    runs unless ``native.disabled()``, the numpy unpack below otherwise."""
    if n_real == 0:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    block = wide_plane.shape[1] * 32 * LANES
    bids64 = np.asarray(bids, np.int64)
    if inner_plane is None:
        rows = native.bitmask_decode(wide_plane, bids64, n_real, block)
        nat = None if rows is None else (rows, np.zeros(len(rows), bool))
    else:
        nat = native.bitmask_decode_pair(wide_plane, inner_plane, bids64, n_real, block)
    if nat is not None:
        rows, certain = nat
        if not _bids_sorted(bids, n_real):
            order = np.argsort(rows, kind="stable")
            rows, certain = rows[order], certain[order]
        return rows, certain
    wb = unpack_plane(wide_plane, n_real)
    blk, local = np.nonzero(wb)
    rows = bids[:n_real][blk].astype(np.int64) * block + local
    if inner_plane is None:
        certain = np.zeros(len(rows), bool)
    else:
        certain = unpack_plane(inner_plane, n_real)[blk, local].astype(bool)
    if not _bids_sorted(bids, n_real):
        order = np.argsort(rows, kind="stable")
        rows, certain = rows[order], certain[order]
    return rows, certain


def _bids_sorted(bids: np.ndarray, n_real: int) -> bool:
    b = bids[:n_real]
    return bool(np.all(b[1:] > b[:-1])) if len(b) > 1 else True
