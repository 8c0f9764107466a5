#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of geomesa on one CUDA card and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card (nvidia-smi name and power limit, torch's device
   name) and the kernels' build time — every CUDA kernel builds from
   geomesa_tpu_torch/csrc with nvcc for sm_90a;
2. kernels: each kernel's wrapper against its plain PyTorch version on
   the card, at the main path's shapes (SUB = 128 over as many blocks as
   the 100M-row table; K1 at M in {32, 256, 4096} and the whole table
   padded to its bucket; the fused scan K2 at M in {32, 2048} with 48
   queries of differing slot counts, interleaved; the count K1p at M in
   {32, 4096} and the whole table; K1's point-in-polygon and raster legs
   at M = 4096 (PIP at E 16, 64, 256, the raster at R 16, 64, 256, both
   legs at R 16 + E 64) and K2's edge and raster stacks at M = 2048 with
   48 polygon queries, each with and without the window); results must
   be equal word for word; each kernel's time (CUDA events, median of 25
   runs after warm-up: the launch alone, and the whole wrapper with its
   staging) beside its bound and the plain version's time;
3. main path: a GDELT-shaped Z3 point table of 100,000,000 rows (the
   reference benchmark's configuration 1, cut from 500M for the run's
   time) in ``DataStore(device="cuda")``, 16 warm-up and 64 measured
   BBOX + DURING queries (latency untraced, then a traced pass of the same
   queries for the per-phase split), 8 of them checked against an f64 brute-force
   filter, 4 density grids and 4 bounds estimates checked against the
   plain versions on the same device table;
4. batch path, on the same store: ``query_many`` over the 64 queries (a
   warm call, a timed one, then a traced one for the per-phase split),
   the serving scheduler under 8 client threads of 8 queries each,
   ``density_many`` over the 4 busiest queries' envelopes and 8
   ``stats_query("Count()", estimate=True)``;
   ids equal the sequential queries', grids the sequential ``density``
   grids, and each count the table's count arithmetic over the plain
   popcount;
5. polygon path, on the same store: 8 warm-up and 48 measured
   ``INTERSECTS(geom, <star polygon>) AND dtg DURING`` queries (4 with a
   hole, 2 MultiPolygons, 2 past 256 edges), untraced then traced,
   ``query_many``, the scheduler (8 threads x 6 queries), 16 of them
   again with ``geomesa.raster.residue=device`` and with
   ``geomesa.raster.enabled=false`` (and all 48 through ``query_many``
   under each), count / bounds / Count() / density
   over 4 of them, and the full-table host scan the port used to run on
   2; ids, counts, envelopes and grids checked against an f64 brute
   force, every other path's ids against the sequential queries';
6. a 10,000,000-row table with packed time, 16 queries, ``query_many``
   and two count estimates;
7. a Z2 table of 20,000,000 points (the reference benchmark's
   configuration 4): the polygon path with 32 queries and no time.

Launch counts (and the polygon legs' counts) are zeroed just before each
of the five paths and read just after it; each path must have launched
the kernels and legs it names (main: K1, K3, K4; batch: K2, K1p, K3; Z3
polygon: K1 and K2 each with PIP, raster and both legs; packed time:
all five; Z2 polygon: K1's raster leg, K2 with stacks).

Then the kernels line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits nonzero and prints no result; so does a machine without CUDA, and a
directory holding this script without the package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np

N_MAIN = 100_000_000
N_PACKED = 10_000_000
N_WARMUP = 16
N_MEASURED = 64
N_PACKED_QUERIES = 16
N_POLY_WARMUP = 8
N_POLY_MEASURED = 48
# the points of the reference benchmark's configuration 4 (points x admin
# polygons), on a Z2 table
N_Z2 = 20_000_000
N_Z2_POLY_QUERIES = 32
K2_SLOTS = 2048  # the fused chunk's slots at 100M rows (storage.table.fused_slots)
SEED = 42
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet); the
# kernels' int32 compares and bit operations are counted at this rate too
OPS_PER_S = 67e12
TIMED_RUNS = 25
T0_MS = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
SPAN_MS = 120 * 86_400_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


# -- GDELT-shaped data and queries (the reference benchmark's generators) --


def gdelt_points(n, rng):
    """World-wide events clustered around population centers: uniform
    background + gaussian clusters."""
    n_clustered = n // 2
    n_uniform = n - n_clustered
    cx = rng.uniform(-160, 160, 64)
    cy = rng.uniform(-55, 65, 64)
    which = rng.integers(0, 64, n_clustered)
    x = np.concatenate([
        rng.uniform(-180, 180, n_uniform),
        np.clip(cx[which] + rng.normal(0, 3.0, n_clustered), -180, 180),
    ])
    y = np.concatenate([
        rng.uniform(-90, 90, n_uniform),
        np.clip(cy[which] + rng.normal(0, 2.0, n_clustered), -90, 90),
    ])
    return x, y


def box_queries(rng, n_queries):
    """Selectivity mix: city-scale through continent-scale boxes."""
    out = []
    for _ in range(n_queries):
        w = float(rng.choice([1.0, 2.0, 5.0, 10.0, 20.0, 40.0]))
        h = w / 2
        qx = rng.uniform(-175, 175 - w)
        qy = rng.uniform(-85, 85 - h)
        out.append((qx, qy, qx + w, qy + h))
    return out


def time_windows(rng, n_queries, t0, span_ms):
    out = []
    for _ in range(n_queries):
        dur_ms = int(rng.choice([6, 24, 72, 168, 24 * 14]) * 3600_000)
        start = int(t0 + rng.integers(0, span_ms - dur_ms))
        out.append((start, start + dur_ms))
    return out


def query_set(seed, n):
    """[(ecql, (x0, y0, x1, y1, lo_ms, hi_ms))] for n BBOX + DURING queries."""
    r = np.random.default_rng(seed)
    boxes = box_queries(r, n)
    wins = time_windows(r, n, T0_MS, SPAN_MS)
    out = []
    for (x0, y0, x1, y1), (lo, hi) in zip(boxes, wins):
        q = (
            f"bbox(geom, {x0:.4f}, {y0:.4f}, {x1:.4f}, {y1:.4f}) AND dtg DURING "
            f"{np.datetime64(lo, 'ms')}Z/{np.datetime64(hi, 'ms')}Z"
        )
        # the filter as parsed: the printed 4-decimal box is the query
        box = tuple(float(f"{v:.4f}") for v in (x0, y0, x1, y1))
        out.append((q, (*box, lo, hi)))
    return out


# -- timing ----------------------------------------------------------------


def time_ms(torch, fn, runs=TIMED_RUNS, warmup=3) -> float:
    """Median device time of fn() over ``runs`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def max_abs_err(a, b) -> float:
    """Largest |a - b| over the elements (0 where equal, infinities included)."""
    d = (a.double() - b.double()).abs()
    d[a == b] = 0
    return float(d.max()) if d.numel() else 0.0


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes moved
    over the memory rate and the operations over the peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


def leg_ops(boxes, wins, has_boxes, has_windows, planes) -> int:
    """Operations per row of the predicate legs over the query's active
    slots: per slot and plane 4 compares, 3 ANDs and an OR."""
    from geomesa_tpu_torch.scan import block_kernels as bk

    n_box, n_win = bk.slot_words(boxes, wins)[2].tolist()
    return (n_box * has_boxes + n_win * has_windows) * 8 * planes + planes


# operations of the polygon legs (csrc/masks.cuh): per row and edge the ray
# cast's 2 compares and a XOR for the crossing window, a subtract, multiply
# and add for the crossing abscissa, a compare, AND and XOR for the
# parity, and 3 subtracts, 3 absolutes, 3 compares, an AND and 3 ORs for
# the near band; per row the raster cell (2 subtracts, 2 multiplies, 2
# floors, 4 compares, 3 ANDs, a multiply and an add); per row in the grid
# and interval 2 compares and an AND for the hit, and a compare, an AND
# and an OR for each of full and partial
PIP_OPS_PER_EDGE = 22
RASTER_CELL_OPS = 15
RASTER_OPS_PER_INTERVAL = 9


def polygon_ops(torch, x, y, edges, rast) -> int:
    """Operations the polygon legs do on rows ``x``, ``y`` (tensors on the
    card) with one query's ``edges`` [E, 128] and ``rast`` [1 + R, 128]
    blocks (numpy, either None), counted from this data: the intervals
    loop only for rows inside the grid, and with both legs the ray cast
    only for rows in partial cells, as the kernels do; edges and intervals
    are the real ones, before the pad rows."""
    from geomesa_tpu_torch.scan import block_kernels as bk

    rows = x.numel()
    pip_rows = rows
    ops = 0
    if rast is not None:
        n_r = int(bk.active_rints_many(rast[None])[0])
        x0, y0, icx, icy, nx, ny = (float(v) for v in rast[0, :6])
        cx = torch.floor((x - x0) * icx)
        cy = torch.floor((y - y0) * icy)
        in_grid = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
        ops += rows * RASTER_CELL_OPS + int(in_grid.sum()) * n_r * RASTER_OPS_PER_INTERVAL
        del cx, cy, in_grid
        if edges is not None:
            _, part = bk._raster_plain(x, y, torch.as_tensor(rast, device=x.device))
            pip_rows = int(part.sum())
    if edges is not None:
        ops += pip_rows * int(bk.active_edges_many(edges[None])[0]) * PIP_OPS_PER_EDGE
    return ops


def star(cx, cy, r, arms, rng, hole=False):
    """A star polygon of 2 * arms edges, as the reference benchmark's
    geofences (outer radius r, inner radii 0.3-0.7 r), optionally with a
    reversed hole ring of radius 0.15 r, inside every inner vertex."""
    from geomesa_tpu_torch import geometry as geo

    a = np.linspace(0, 2 * np.pi, 2 * arms + 1)[:-1]
    rad = np.where(np.arange(2 * arms) % 2 == 0, r, r * rng.uniform(0.3, 0.7, 2 * arms))
    shell = np.stack([cx + rad * np.cos(a), cy + rad * np.sin(a)], axis=1)
    holes = []
    if hole:
        h = 0.15 * r
        holes.append(np.stack([cx + h * np.cos(a[::-1]), cy + h * np.sin(a[::-1])], axis=1))
    return geo.Polygon(shell, holes)


# -- phase 2: kernels against their plain versions --------------------------


def synthetic_columns(torch, n_blocks, sub, device):
    """[n_blocks, sub, 128] columns made on the card from a seed; the last
    block's tail carries the table's pad sentinels."""
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    shape = (n_blocks, sub, 128)
    x = torch.rand(shape, generator=g, device=device) * 360 - 180
    y = torch.rand(shape, generator=g, device=device) * 180 - 90
    tb = torch.randint(2800, 2820, shape, generator=g, device=device, dtype=torch.int32)
    to = torch.randint(0, 604_800, shape, generator=g, device=device, dtype=torch.int32)
    tw = (tb << 16) | (to >> 5)
    tail = (slice(-1, None), slice(sub // 2, None))
    x[tail] = float("inf")
    y[tail] = float("inf")
    tb[tail] = -1
    to[tail] = 0
    tw[tail] = -1
    return {"x": x.contiguous(), "y": y.contiguous(), "tbin": tb, "toff": to, "tw": tw}


def kernel_phase(torch, device):
    from geomesa_tpu_torch.scan import aggregations as agg
    from geomesa_tpu_torch.scan import block_kernels as bk

    sub = 128
    n_blocks = -(-N_MAIN // (sub * 128))  # the main table's block count
    cols = synthetic_columns(torch, n_blocks, sub, device)
    boxes = bk.pack_boxes(
        np.array([[-60, -30, 40, 50], [100, -80, 170, -10]], np.float32),
        np.array([[-59, -29, 39, 49]], np.float32),
    )
    wins = bk.pack_windows(
        np.array([[2801, 2805, 0, 604_799], [2810, 2810, 1000, 90_000]]),
        np.array([[2801, 2805, 1, 604_798]]),
    )
    wins_tw = bk.pack_windows(
        np.array([[2801, 2805, 0, 18_899], [2810, 2810, 31, 2812]]),
        np.array([[2801, 2805, 1, 18_898]]),
    )
    predicates = [
        ("box+window", ("tbin", "toff", "x", "y"), True, True, wins),
        ("box+window:tw", ("tw", "x", "y"), True, True, wins_tw),
        ("box", ("x", "y"), True, False, wins),
        ("window", ("tbin", "toff"), False, True, wins),
        ("none", ("x",), False, False, wins),
    ]
    rng = np.random.default_rng(SEED)

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    out = {}
    err = {"block_scan": 0.0, "density": 0.0, "bounds": 0.0}
    # K1: every predicate at every M of the ladder the main path uses, and
    # at the whole table (past the largest bucket the table scans every
    # block, padded to the next power of two)
    scan_checks = 0
    for m in (32, 256, 4096, n_blocks):
        blocks = np.sort(rng.choice(n_blocks, size=m, replace=False))
        bids, _ = bk.pad_bids(blocks, n_blocks)
        for name, names, hb, hw, w in predicates:
            c3 = tuple(cols[k] for k in names)
            kw = dict(col_names=names, has_boxes=hb, has_windows=hw)
            kw_, ki = bk.block_scan(c3, bids, boxes, w, **kw)
            pw, pi = bk.block_scan_plain(
                dict(zip(names, c3)), dev(bids, torch.int32), dev(boxes, torch.float32),
                dev(w, torch.int32), has_boxes=hb, has_windows=hw,
            )
            err["block_scan"] = max(err["block_scan"], max_abs_err(kw_, pw), max_abs_err(ki, pi))
            check(torch.equal(kw_, pw) and torch.equal(ki, pi), f"block_scan {name} M={len(bids)}")
            check(bool(kw_.any()), f"block_scan {name} M={len(bids)} selects rows")
            scan_checks += 1
    # timing at the largest bucket, all slots real, box + window on
    # (tbin, toff): the launch alone (params staged once), then the wrapper
    names = ("tbin", "toff", "x", "y")
    c3 = tuple(cols[k] for k in names)
    tcols = dict(zip(names, c3))
    t_m = bk.M_BUCKETS[-1]
    bids, _ = bk.pad_bids(np.arange(t_m), n_blocks)
    kw = dict(col_names=names, has_boxes=True, has_windows=True)
    flags = dict(has_boxes=True, has_windows=True)
    pargs = (tcols, dev(bids, torch.int32), dev(boxes, torch.float32), dev(wins, torch.int32))
    rows = t_m * sub * 128
    # per row: both planes' legs, then a shift and an OR per plane to pack
    scan_ops = rows * (leg_ops(boxes, wins, True, True, planes=2) + 4)
    _, launch = bk.scan_launcher(tcols, bids, boxes, wins, **flags)
    out["block_scan"] = {
        "ms": time_ms(torch, launch),
        "wrapper_ms": time_ms(torch, lambda: bk.block_scan(c3, bids, boxes, wins, **kw)),
        "plain_ms": time_ms(torch, lambda: bk.block_scan_plain(*pargs, **flags)),
        **bound(rows * 4 * len(names) + 2 * rows // 8 + bids.nbytes, scan_ops),
        "library_ms": None,
        "checks": scan_checks,
        "shape": f"M={t_m} SUB={sub} cols={','.join(names)}",
    }

    # K3 / K4: grids and stats with -1 pads, both time layouts, over 3000
    # blocks (padded to 4096) and over the whole table (padded to 8192)
    agg_checks = 0
    gb = np.array([-100, -60, 120, 70], np.float32)
    for n_real in (3000, n_blocks):
        blocks = np.sort(rng.choice(n_blocks, size=n_real, replace=False))
        pbids, _ = bk.pad_bids(blocks, n_blocks, pad=-1)
        for name, names_, hb, hw, w in predicates[:2]:
            c3_ = tuple(cols[k] for k in names_)
            kw_ = dict(col_names=names_, has_boxes=hb, has_windows=hw)
            pl = (dict(zip(names_, c3_)), dev(pbids, torch.int32), dev(boxes, torch.float32),
                  dev(w, torch.int32))
            m = len(pbids)
            for width, height in ((256, 256), (33, 17)):
                got = agg.block_density(c3_, pbids, boxes, w, gb, width=width, height=height, **kw_)
                ref = agg.density_plain(*pl, dev(gb, torch.float32), has_boxes=hb,
                                        has_windows=hw, width=width, height=height)
                err["density"] = max(err["density"], max_abs_err(got, ref))
                check(torch.equal(got, ref) and float(got.sum()) > 0,
                      f"density {name} M={m} {width}x{height}")
                agg_checks += 1
            st = agg.block_bounds(c3_, pbids, boxes, w, **kw_)
            sp = agg.bounds_plain(*pl, has_boxes=hb, has_windows=hw)
            err["bounds"] = max(err["bounds"], max_abs_err(st[:n_real], sp[:n_real]))
            check(np.array_equal(st[:n_real].cpu().numpy(), sp[:n_real].cpu().numpy()),
                  f"bounds {name} M={m}")
            agg_checks += 1

    # timing at the largest bucket, all slots real
    col_bytes = rows * 4 * len(names)
    # the library yardstick: one bincount over this query's hit pixels
    g = {k: v[pargs[1].to(torch.int64)] for k, v in tcols.items()}
    wm, _ = bk.masks_plain(g, pargs[2], pargs[3], True, True)
    wide_hits = int(wm.sum())
    xs, ys = g["x"][wm], g["y"][wm]
    x0, y0, x1, y1 = (float(v) for v in gb)
    inside = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
    xs, ys = xs[inside], ys[inside]
    px = ((xs - x0) / (x1 - x0) * 256).to(torch.int32).clamp(0, 255)
    py = ((ys - y0) / (y1 - y0) * 256).to(torch.int32).clamp(0, 255)
    flat = py.to(torch.int64) * 256 + px.to(torch.int64)
    del g, wm
    wide_ops = rows * leg_ops(boxes, wins, True, True, planes=1)
    # per row the closed envelope (4 compares, 4 ANDs); per hit in it two
    # pixels (subtract, divide, multiply, truncate, 2 clips) and the
    # flat index (multiply, add) before one increment
    density_ops = wide_ops + rows * 8 + flat.numel() * 15
    # per wide hit a count and four min/max
    bounds_ops = wide_ops + wide_hits * 5
    _, d_launch = agg.density_launcher(tcols, bids, boxes, wins, gb, width=256, height=256,
                                       **flags)
    out["density"] = {
        "ms": time_ms(torch, d_launch),
        "wrapper_ms": time_ms(torch, lambda: agg.block_density(
            c3, bids, boxes, wins, gb, width=256, height=256, **kw)),
        "plain_ms": time_ms(torch, lambda: agg.density_plain(
            *pargs, dev(gb, torch.float32), width=256, height=256, **flags)),
        **bound(col_bytes + 256 * 256 * 4 + bids.nbytes, density_ops),
        "library_ms": time_ms(torch, lambda: torch.bincount(flat, minlength=256 * 256)),
        "checks": agg_checks,
        "hits": int(flat.numel()),
        "shape": f"M={t_m} SUB={sub} grid=256x256 cols={','.join(names)}",
    }
    _, b_launch = agg.bounds_launcher(tcols, bids, boxes, wins, **flags)
    out["bounds"] = {
        "ms": time_ms(torch, b_launch),
        "wrapper_ms": time_ms(torch, lambda: agg.block_bounds(c3, bids, boxes, wins, **kw)),
        "plain_ms": time_ms(torch, lambda: agg.bounds_plain(*pargs, **flags)),
        **bound(col_bytes + t_m * 8 * 4 + bids.nbytes, bounds_ops),
        "library_ms": None,
        "checks": agg_checks,
        "shape": f"M={t_m} SUB={sub} cols={','.join(names)}",
    }
    for name, e in err.items():
        out[name]["max_abs_err"] = e
    del c3, tcols, pargs, flat
    out.update(fused_and_pops_kernels(torch, cols, n_blocks, sub, predicates, boxes, wins, dev))
    k1, k2, err1, err2, n_poly = polygon_kernels(torch, cols, n_blocks, sub, boxes, wins, dev)
    out["block_scan"]["legs"] = k1
    out["block_scan_multi"]["legs"] = k2
    out["block_scan"]["max_abs_err"] = max(out["block_scan"]["max_abs_err"], err1)
    out["block_scan_multi"]["max_abs_err"] = max(out["block_scan_multi"]["max_abs_err"], err2)
    out["polygon_leg_checks"] = n_poly
    del cols
    torch.cuda.empty_cache()
    return out


def query_stacks(n_q: int, seed: int):
    """[128, 8, 128] box stack and window stacks (seconds, and 32 s ticks
    for tw) of n_q queries; query q uses 1 + q % 8 box slots and
    1 + (3q + 1) % 8 window slots, so the queries of one chunk differ in
    both counts. Rows past n_q stay zero, as in the table's stacks."""
    from geomesa_tpu_torch.scan import block_kernels as bk
    from geomesa_tpu_torch.storage.table import FUSED_CHUNK_Q

    r = np.random.default_rng(seed)
    boxes = np.zeros((FUSED_CHUNK_Q, 8, 128), np.float32)
    wins = np.zeros((FUSED_CHUNK_Q, 8, 128), np.int32)
    wins_tw = np.zeros_like(wins)
    for q in range(n_q):
        nb, nw = 1 + q % 8, 1 + (3 * q + 1) % 8
        lo = r.uniform(-175, 120, (nb, 2)).astype(np.float32)
        wide = np.concatenate([lo, lo + r.uniform(5, 60, (nb, 2)).astype(np.float32)], axis=1)
        boxes[q] = bk.pack_boxes(wide, wide[:1] + np.array([1, 1, -1, -1], np.float32))
        b = r.integers(2800, 2820, nw)
        b1 = b + r.integers(0, 3, nw)
        for stack, top in ((wins, 604_799), (wins_tw, 18_899)):
            o = np.sort(r.integers(0, top, (nw, 2)), axis=1)
            ws = np.stack([b, b1, o[:, 0], o[:, 1]], axis=1)
            stack[q] = bk.pack_windows(ws, ws[:1] + np.array([0, 0, 1, -1]))
    return boxes, wins, wins_tw


def fused_and_pops_kernels(torch, cols, n_blocks, sub, predicates, boxes1, wins1, dev):
    """K2 and K1p against their plain versions on the synthetic columns,
    then their times. K2 at M = 32 and M = 2048 (the fused chunk at 100M
    rows) with 48 queries of differing slot counts in a [128, 8, 128]
    stack, qids interleaved, pads bid 0 / qid 0; K1p at M = 32, 4096 and
    the whole table padded to its bucket, -1 pads (clamped to block 0)."""
    from geomesa_tpu_torch.scan import aggregations as agg
    from geomesa_tpu_torch.scan import block_kernels as bk

    n_q = 48
    boxes, wins, wins_tw = query_stacks(n_q, SEED + 7)
    rng = np.random.default_rng(SEED + 8)
    out = {}
    err = {"block_scan_multi": 0.0, "block_pops": 0.0}
    multi_checks = 0
    for m in (32, 2048):
        n_real = m - max(4, m // 40)
        blocks = rng.integers(0, n_blocks, n_real)
        bids, _ = bk.pad_bids(blocks, n_blocks, bucket=m)
        qids = np.zeros(m, np.int32)
        qids[:n_real] = rng.permutation(np.arange(n_real) % n_q)
        for name, names, hb, hw, _ in predicates:
            w = wins_tw if "tw" in names else wins
            c3 = tuple(cols[k] for k in names)
            got_w, got_i = bk.block_scan_multi(c3, bids, qids, boxes, w, col_names=names,
                                               has_boxes=hb, has_windows=hw)
            pw, pi = bk.block_scan_multi_plain(
                dict(zip(names, c3)), dev(bids, torch.int32), dev(qids, torch.int32),
                dev(boxes, torch.float32), dev(w, torch.int32), has_boxes=hb, has_windows=hw,
            )
            err["block_scan_multi"] = max(err["block_scan_multi"], max_abs_err(got_w, pw),
                                          max_abs_err(got_i, pi))
            check(torch.equal(got_w, pw) and torch.equal(got_i, pi),
                  f"block_scan_multi {name} M={m}")
            check(bool(got_w.any()), f"block_scan_multi {name} M={m} selects rows")
            multi_checks += 1
    pops_checks = 0
    for m_real in (32, 4096, n_blocks):
        blocks = np.sort(rng.choice(n_blocks, size=m_real - 3, replace=False))
        bids, _ = bk.pad_bids(blocks, n_blocks, pad=-1)
        for name, names, hb, hw, w in predicates:
            c3 = tuple(cols[k] for k in names)
            got = agg.block_pops(c3, bids, boxes1, w, col_names=names, has_boxes=hb,
                                 has_windows=hw)
            ref = agg.block_pops_plain(
                dict(zip(names, c3)), dev(bids, torch.int32), dev(boxes1, torch.float32),
                dev(w, torch.int32), has_boxes=hb, has_windows=hw,
            )
            err["block_pops"] = max(err["block_pops"], max_abs_err(got, ref))
            check(torch.equal(got, ref) and int(got.sum()) > 0,
                  f"block_pops {name} M={len(bids)}")
            pops_checks += 1

    # timing: K2 at the fused chunk's M = 2048, every slot real; K1p at
    # M = 4096 as K1. Box + window on (tbin, toff, x, y).
    names = ("tbin", "toff", "x", "y")
    c3 = tuple(cols[k] for k in names)
    tcols = dict(zip(names, c3))
    flags = dict(has_boxes=True, has_windows=True)
    kw = dict(col_names=names, **flags)
    m = 2048
    bids = np.sort(rng.choice(n_blocks, size=m, replace=False)).astype(np.int32)
    qids = rng.permutation(np.arange(m) % n_q).astype(np.int32)
    rows = m * sub * 128
    per_query = np.array([leg_ops(boxes[q], wins[q], True, True, planes=2) + 4
                          for q in range(len(boxes))])
    multi_ops = sub * 128 * int(per_query[qids].sum())
    staged = bk.stage_multi_params(bids, qids, boxes, wins)
    _, launch = bk.multi_launcher(tcols, bids, qids, boxes, wins, **flags)
    pargs = (tcols, dev(bids, torch.int32), dev(qids, torch.int32), dev(boxes, torch.float32),
             dev(wins, torch.int32))
    out["block_scan_multi"] = {
        "ms": time_ms(torch, launch),
        "wrapper_ms": time_ms(torch, lambda: bk.block_scan_multi(c3, bids, qids, boxes, wins,
                                                                 **kw)),
        "plain_ms": time_ms(torch, lambda: bk.block_scan_multi_plain(*pargs, **flags)),
        **bound(rows * 4 * len(names) + 2 * rows // 8 + staged.nbytes, multi_ops),
        "library_ms": None,
        "checks": multi_checks,
        "shape": f"M={m} Q=128 ({n_q} real) SUB={sub} cols={','.join(names)}",
    }
    del pargs
    m = bk.M_BUCKETS[-1]
    bids, _ = bk.pad_bids(np.arange(m), n_blocks)
    rows = m * sub * 128
    # per row the wide plane's legs, then a shift and an OR to build the
    # word; per word a popcount and an add
    pops_ops = rows * (leg_ops(boxes1, wins1, True, True, planes=1) + 2) + rows // 16
    _, p_launch = agg.pops_launcher(tcols, bids, boxes1, wins1, **flags)
    pargs = (tcols, dev(bids, torch.int32), dev(boxes1, torch.float32), dev(wins1, torch.int32))
    out["block_pops"] = {
        "ms": time_ms(torch, p_launch),
        "wrapper_ms": time_ms(torch, lambda: agg.block_pops(c3, bids, boxes1, wins1, **kw)),
        "plain_ms": time_ms(torch, lambda: agg.block_pops_plain(*pargs, **flags)),
        **bound(rows * 4 * len(names) + m * 4 + bids.nbytes, pops_ops),
        "library_ms": None,
        "checks": pops_checks,
        "shape": f"M={m} SUB={sub} cols={','.join(names)}",
    }
    for name, e in err.items():
        out[name]["max_abs_err"] = e
    return out


def polygon_kernels(torch, cols, n_blocks, sub, boxes, wins, dev):
    """K1's point-in-polygon and raster legs and K2's per-query stacks
    against their plain versions on the synthetic columns, each case with
    the window on (tbin, toff) and without it, then timed with the window:
    K1 at M = 4096 with PIP alone at E 16, 64 and 256 (stars of 12, 56
    with a hole, and 200 edges), the raster alone at R 16, 64 and 256, and
    both legs at R 16 + E 64; K2 at M = 2048 with 48 polygon queries of
    differing edge and interval counts (E bucket 64, R bucket 16),
    interleaved, one chunk per leg combination, pads spip 0. The plain
    versions take seconds at E 256, so they are timed over 3 runs."""
    from geomesa_tpu_torch.filter import raster as fr
    from geomesa_tpu_torch.scan import block_kernels as bk
    from geomesa_tpu_torch.storage.table import FUSED_CHUNK_Q

    rng = np.random.default_rng(SEED + 9)
    polys = {
        16: star(-20, 10, 75, 6, rng),
        64: star(30, -5, 70, 14, rng, hole=True),
        256: star(0, 0, 80, 100, rng),
    }
    cases = [(f"pip:E{e}", bk.pack_edges(p), None) for e, p in polys.items()]
    cases += [(f"raster:R{r}", None, fr.build_raster(polys[256]).pack_block(r))
              for r in (16, 64, 256)]
    cases.append(("pip+raster:R16+E64", bk.pack_edges(polys[64]),
                  fr.build_raster(polys[64]).pack_block(16)))
    windowed = ("tbin", "toff", "x", "y")
    variants = [(windowed, True), (("x", "y"), False)]
    m = bk.M_BUCKETS[-1]
    bids, _ = bk.pad_bids(np.sort(rng.choice(n_blocks, size=m, replace=False)), n_blocks)
    tbids = dev(bids, torch.int32)
    rows = m * sub * 128
    n_win = int(bk.slot_words(wins, wins)[2][1])
    gx, gy = cols["x"][tbids.long()], cols["y"][tbids.long()]
    err, checks, k1 = 0.0, 0, {}
    for name, edges, rast in cases:
        kw = dict(edges=edges, n_edges=bk.n_edges_of(edges), rast=rast,
                  n_rints=bk.n_rints_of(rast))
        pkw = dict(edges=None if edges is None else dev(edges, torch.float32),
                   rast=None if rast is None else dev(rast, torch.float32))
        for names, hw in variants:
            c3 = tuple(cols[k] for k in names)
            got_w, got_i = bk.block_scan(c3, bids, boxes, wins, col_names=names,
                                         has_boxes=True, has_windows=hw, **kw)
            pw, pi = bk.block_scan_plain(
                dict(zip(names, c3)), tbids, dev(boxes, torch.float32), dev(wins, torch.int32),
                has_boxes=True, has_windows=hw, **pkw,
            )
            err = max(err, max_abs_err(got_w, pw), max_abs_err(got_i, pi))
            check(torch.equal(got_w, pw) and torch.equal(got_i, pi),
                  f"block_scan {name} windows={hw} M={m}")
            # certain rows too where the ray cast runs (a coarse raster
            # alone may certify none)
            check(bool(got_w.any()) and (edges is None or bool(got_i.any())),
                  f"block_scan {name} windows={hw} selects rows")
            checks += 1
            del got_w, got_i, pw, pi
        c3 = tuple(cols[k] for k in windowed)
        tcols = dict(zip(windowed, c3))
        _, launch = bk.scan_launcher(tcols, bids, boxes, wins, has_boxes=True,
                                     has_windows=True, edges=edges, rast=rast)
        # per row both planes' window legs and the packing
        ops = rows * (n_win * 16 + 2 + 4) + polygon_ops(torch, gx, gy, edges, rast)
        n_e = int(bk.active_edges_many(edges[None])[0]) if edges is not None else 0
        n_r = int(bk.active_rints_many(rast[None])[0]) if rast is not None else 0
        # the staged params with the polygon block's real rows
        staged = bk.stage_params(bids, boxes, wins).nbytes + 4 * (2 + 6 * n_e + 6 + 3 * n_r)
        k1[name] = {
            "ms": time_ms(torch, launch),
            "wrapper_ms": time_ms(torch, lambda: bk.block_scan(
                c3, bids, boxes, wins, col_names=windowed, has_boxes=True, has_windows=True,
                **kw)),
            "plain_ms": time_ms(torch, lambda: bk.block_scan_plain(
                tcols, tbids, dev(boxes, torch.float32), dev(wins, torch.int32),
                has_boxes=True, has_windows=True, **pkw), runs=3, warmup=1),
            **bound(rows * 4 * len(windowed) + 2 * rows // 8 + staged, ops),
            "library_ms": None,
            "real_edges": n_e,
            "real_intervals": n_r,
            "shape": f"M={m} SUB={sub} cols={','.join(windowed)}",
        }
    del gx, gy

    # K2: 48 polygon queries in one [128, ...] chunk per leg combination
    n_q = 48
    qboxes, wins_q, _ = query_stacks(n_q, SEED + 10)
    edges = np.zeros((FUSED_CHUNK_Q, 64, 128), np.float32)
    rasts = np.zeros((FUSED_CHUNK_Q, 17, 128), np.float32)
    for q in range(n_q):
        hole = q % 4 == 0
        arms = int(rng.integers(3, 17 if hole else 33))  # E bucket 64 with or without a hole
        p = star(rng.uniform(-150, 150), rng.uniform(-60, 60), rng.uniform(10, 40), arms, rng,
                 hole=hole)
        e = bk.pack_edges(p)
        edges[q, : len(e)] = e
        r = fr.build_raster(p).pack_block(16)
        rasts[q, : len(r)] = r
    m2 = K2_SLOTS
    n_real = m2 - m2 // 40
    bids2, _ = bk.pad_bids(rng.integers(0, n_blocks, n_real), n_blocks, bucket=m2)
    qids = np.zeros(m2, np.int32)
    qids[:n_real] = rng.permutation(np.arange(n_real) % n_q)
    spip = np.zeros(m2, np.int32)
    spip[:n_real] = 1
    tb2, tq = dev(bids2, torch.int32), dev(qids, torch.int32)
    gx, gy = cols["x"][tb2.long()], cols["y"][tb2.long()]
    k2, err2 = {}, 0.0
    for name, es, rs in (("pip:E64", edges, None), ("raster:R16", None, rasts),
                         ("pip+raster:R16+E64", edges, rasts)):
        kw = dict(edges=es, spip=spip, n_edges=0 if es is None else 64, rasts=rs,
                  n_rints=0 if rs is None else 16)
        pkw = dict(edges=None if es is None else dev(es, torch.float32),
                   rasts=None if rs is None else dev(rs, torch.float32),
                   spip=dev(spip, torch.int32))
        for names, hw in variants:
            w = wins_q
            c3 = tuple(cols[k] for k in names)
            got_w, got_i = bk.block_scan_multi(c3, bids2, qids, qboxes, w, col_names=names,
                                               has_boxes=True, has_windows=hw, **kw)
            pw, pi = bk.block_scan_multi_plain(
                dict(zip(names, c3)), tb2, tq, dev(qboxes, torch.float32), dev(w, torch.int32),
                has_boxes=True, has_windows=hw, **pkw,
            )
            err2 = max(err2, max_abs_err(got_w, pw), max_abs_err(got_i, pi))
            check(torch.equal(got_w, pw) and torch.equal(got_i, pi),
                  f"block_scan_multi {name} windows={hw} M={m2}")
            check(bool(got_w.any()), f"block_scan_multi {name} windows={hw} selects rows")
            checks += 1
            del got_w, got_i, pw, pi
        c3 = tuple(cols[k] for k in windowed)
        tcols = dict(zip(windowed, c3))
        _, launch = bk.multi_launcher(tcols, bids2, qids, qboxes, wins_q, has_boxes=True,
                                      has_windows=True, edges=es, rasts=rs, spip=spip)
        ops = 0
        for q in range(n_q):
            sel = torch.from_numpy(np.flatnonzero(qids[:n_real] == q)).to(gx.device)
            nw = int(bk.slot_words(qboxes[q], wins_q[q])[2][1])
            ops += len(sel) * sub * 128 * (nw * 16 + 2 + 4) + polygon_ops(
                torch, gx[sel], gy[sel], None if es is None else es[q],
                None if rs is None else rs[q])
        rows2 = m2 * sub * 128
        k2[name] = {
            "ms": time_ms(torch, launch),
            "wrapper_ms": time_ms(torch, lambda: bk.block_scan_multi(
                c3, bids2, qids, qboxes, wins_q, col_names=windowed, has_boxes=True,
                has_windows=True, **kw)),
            "plain_ms": time_ms(torch, lambda: bk.block_scan_multi_plain(
                tcols, tb2, tq, dev(qboxes, torch.float32), dev(wins_q, torch.int32),
                has_boxes=True, has_windows=True, **pkw), runs=3, warmup=1),
            **bound(rows2 * 4 * len(windowed) + 2 * rows2 // 8 + bk.stage_multi_params(
                bids2, qids, qboxes, wins_q, spip=spip, poly=bk.poly_words(
                    None if es is None else es[:n_q], None if rs is None else rs[:n_q],
                    0 if es is None else 64, 0 if rs is None else 16)).nbytes, ops),
            "library_ms": None,
            "shape": f"M={m2} Q=128 ({n_q} polygon queries) SUB={sub} "
                     f"cols={','.join(windowed)}",
        }
    del gx, gy
    return k1, k2, err, err2, checks


# -- phase 3: the main path --------------------------------------------------


def build_store(torch, device, n, packed: bool = False, index: str = "z3", seed: int = SEED):
    """A GDELT-shaped point table of n rows: (dtg, geom) on Z3, or geom
    alone on Z2 (the reference benchmark's points of its configuration 4).
    Returns (store, (x, y, t | None), ingest seconds)."""
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType

    rng = np.random.default_rng(seed)
    x, y = gdelt_points(n, rng)
    t = T0_MS + rng.integers(0, SPAN_MS, n) if index == "z3" else None
    spec = "dtg:Date,*geom:Point:srid=4326" if index == "z3" else "*geom:Point:srid=4326"
    sft = FeatureType.from_spec("gdelt", spec)
    sft.user_data["geomesa.indices.enabled"] = index
    if packed:
        sft.user_data["geomesa.z3.packed-time"] = "true"
    ds = DataStore(device=device)
    ds.create_schema(sft)
    cols = {"geom": (x, y)} if t is None else {"dtg": t, "geom": (x, y)}
    fc = FeatureCollection.from_columns(sft, np.arange(n), cols)
    t_in = time.perf_counter()
    ds.write("gdelt", fc, check_ids=False)
    torch.cuda.synchronize()
    return ds, (x, y, t), time.perf_counter() - t_in


def brute_ids(src, box) -> np.ndarray:
    x, y, t = src
    x0, y0, x1, y1, lo, hi = box
    return np.flatnonzero(
        (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1) & (t >= lo) & (t < hi)
    )


def check_queries(ds, src, measured, results, n_check) -> int:
    """ids vs an f64 brute-force filter, and count vs len, for the first
    n_check queries; returns how many were checked."""
    checked = list(zip(measured, results))[:n_check]
    for (q, box), out in checked:
        got = np.sort(np.asarray(out.ids, dtype=np.int64))
        check(np.array_equal(got, brute_ids(src, box)), f"query ids vs brute force: {q}")
        check(ds.count("gdelt", q) == len(out), f"count == len(query): {q}")
    return len(checked)


def check_aggregations(torch, ds, queries):
    """density / bounds(estimate=True) through the store against the plain
    versions over the same device table and candidate blocks."""
    from geomesa_tpu_torch.scan import aggregations as agg

    table = ds.table("gdelt", "z3")
    n = 0
    for q, (x0, y0, x1, y1, _, _) in queries:
        env = (x0, y0, x1, y1)
        grid = ds.density("gdelt", q, envelope=env, width=256, height=256)
        env_stats = ds.bounds("gdelt", q, estimate=True)
        plan = ds.planner.plan("gdelt", q)
        cols3, bids, n_real, boxes, wins, kw = table.agg_launch_args(plan.config)
        cols = dict(zip(kw["col_names"], cols3))
        dv = table.device
        targs = (cols, torch.from_numpy(bids).to(dv), torch.from_numpy(boxes).to(dv),
                 torch.from_numpy(wins).to(dv))
        flags = dict(has_boxes=kw["has_boxes"], has_windows=kw["has_windows"])
        ref = agg.density_plain(
            *targs, torch.tensor(env, dtype=torch.float32, device=dv),
            width=256, height=256, **flags,
        ).cpu().numpy()
        check(np.array_equal(grid, ref), f"density vs plain: {q}")
        st = agg.bounds_plain(*targs, **flags).cpu().numpy()
        check(env_stats == agg.reduce_bounds(st, n_real)[1], f"bounds vs plain: {q}")
        check(float(grid.sum()) > 0 and env_stats is not None, f"aggregations see hits: {q}")
        n += 1
    return n


def busiest(queries, outs, k):
    """The k queries with the most hits (aggregations over them see data)."""
    order = np.argsort([-len(o) for o in outs], kind="stable")[:k]
    return [queries[i] for i in order]


def run_queries(ds, queries):
    lat, outs = [], []
    t_all = time.perf_counter()
    for q, *_ in queries:
        s = time.perf_counter()
        outs.append(ds.query("gdelt", q))
        lat.append(time.perf_counter() - s)
    return np.array(lat), outs, time.perf_counter() - t_all


def zero_launches() -> None:
    from geomesa_tpu_torch.kernels import KERNELS

    for k in KERNELS:
        k.reset_counts()


def read_launches() -> dict:
    from geomesa_tpu_torch.kernels import KERNELS

    return {k.name: k.launches for k in KERNELS}


def read_leg_launches() -> dict:
    """Launches per polygon leg of the kernels that have them."""
    from geomesa_tpu_torch.kernels import KERNELS

    return {k.name: dict(k.leg_launches) for k in KERNELS if k.leg_launches}


@contextmanager
def chunk_recorder():
    """Record the members of every fused chunk the table launches (one
    entry per scan_planes_multi call: its queries, max qid + 1)."""
    from geomesa_tpu_torch.scan import block_kernels as bk

    members: list = []
    launch = bk.scan_planes_multi

    def recording(cols3, bids, qids, *args, **kw):
        members.append(int(np.max(qids)) + 1)
        return launch(cols3, bids, qids, *args, **kw)

    bk.scan_planes_multi = recording
    try:
        yield members
    finally:
        bk.scan_planes_multi = launch


@contextmanager
def plain_pops(torch):
    """IndexTable.count's own arithmetic with block_pops_plain in place of
    the K1p kernel (straddling blocks still decode through K1)."""
    from geomesa_tpu_torch.scan import aggregations as agg

    kernel = agg.block_pops

    def plain(cols3, bids, boxes, wins, *, col_names, has_boxes, has_windows, **_):
        dv = cols3[0].device
        return agg.block_pops_plain(
            dict(zip(col_names, cols3)), torch.from_numpy(np.asarray(bids, np.int32)).to(dv),
            torch.from_numpy(boxes).to(dv), torch.from_numpy(wins).to(dv),
            has_boxes=has_boxes, has_windows=has_windows,
        )

    agg.block_pops = plain
    try:
        yield
    finally:
        agg.block_pops = kernel


def check_counts(torch, ds, queries, outs, estimates) -> int:
    """Count estimates against the count arithmetic over block_pops_plain,
    and against the exact hits."""
    table = ds.table("gdelt", "z3")
    for (q, _), out, n in zip(queries, outs, estimates):
        with plain_pops(torch):
            ref = table.count(ds.planner.plan("gdelt", q).config)
        check(n == ref, f"count estimate {n} vs plain {ref}: {q}")
        check(n >= len(out), f"count estimate {n} >= hits {len(out)}: {q}")
    return len(estimates)


def check_same_ids(got, ref, what: str) -> None:
    for k, (a, b) in enumerate(zip(got, ref)):
        check(np.array_equal(np.sort(np.asarray(a.ids, np.int64)),
                             np.sort(np.asarray(b.ids, np.int64))), f"{what}: query {k}")
    check(len(got) == len(ref), f"{what}: one result per query")


def count_estimates(ds, queries) -> list:
    return [ds.stats_query("gdelt", "Count()", q, estimate=True)[0].count for q, _ in queries]


def batch_path(torch, ds, measured, outs, seq_wall: float) -> dict:
    """The many-query path on the main path's store: query_many (a warm
    call, a timed one, a traced one), the serving scheduler under 8 client threads,
    density_many over the 4 busiest envelopes and 8 count estimates;
    launch counts zeroed before, read after, checks after that."""
    from concurrent.futures import ThreadPoolExecutor

    from geomesa_tpu_torch.timing import NULL_CLOCK, PhaseClock

    filters = [q for q, _ in measured]
    zero_launches()
    ds.query_many("gdelt", filters)
    before = read_launches()
    with chunk_recorder() as members:
        t0 = time.perf_counter()
        many = ds.query_many("gdelt", filters)
        many_s = time.perf_counter() - t0
    timed = {k: v - before[k] for k, v in read_launches().items()}
    # a traced pass of the same call splits its time by phase
    ds.clock = clock = PhaseClock()
    t0 = time.perf_counter()
    ds.query_many("gdelt", filters)
    traced_s = time.perf_counter() - t0
    phases = {k: v * 1e3 for k, v in clock.settle().items()}
    ds.clock = NULL_CLOCK
    device_ms = sum(phases.get(k, 0.0) for k in ("h2d", "kernel", "d2h"))

    sched = ds.serve()
    try:
        def client(k):
            futs = [sched.submit("gdelt", q) for q in filters[k * 8:(k + 1) * 8]]
            return [f.result(600) for f in futs]

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            served = [o for outs_k in ex.map(client, range(8)) for o in outs_k]
        serve_s = time.perf_counter() - t0
    finally:
        sched.close()

    tiles = busiest(measured, outs, 4)
    requests = [(q, (x0, y0, x1, y1)) for q, (x0, y0, x1, y1, _, _) in tiles]
    t0 = time.perf_counter()
    grids = ds.density_many("gdelt", requests, width=256, height=256)
    density_s = time.perf_counter() - t0
    counted = measured[:8]
    t0 = time.perf_counter()
    estimates = count_estimates(ds, counted)
    count_s = time.perf_counter() - t0
    launches = read_launches()

    check_same_ids(many, outs, "query_many vs sequential query")
    check_same_ids(served, outs, "scheduler vs sequential query")
    for (q, env), grid in zip(requests, grids):
        ref = ds.density("gdelt", q, envelope=env, width=256, height=256)
        check(np.array_equal(grid, ref) and float(grid.sum()) > 0, f"density_many vs density: {q}")
    n_counts = check_counts(torch, ds, counted, outs[:8], estimates)
    hits = sum(len(o) for o in many)
    return {
        "phase": "batch_path", "cell": "gdelt-z3-100M-batch", "launches": launches,
        "n_queries": len(filters), "hits_total": hits,
        "query_many_s": many_s, "query_many_queries_per_s": len(filters) / many_s,
        "query_many_features_per_s": hits / many_s,
        "sequential_queries_per_s": len(filters) / seq_wall,
        "chunks": len(members), "members_per_chunk": members,
        "members_to_k1": timed["block_scan"], "query_many_launches": timed,
        "query_many_phase_ms": phases, "query_many_traced_s": traced_s,
        "query_many_device_busy_share": device_ms / (traced_s * 1e3),
        "scheduler_wall_s": serve_s, "scheduler_queries_per_s": len(served) / serve_s,
        "scheduler_batches": sched.batches, "scheduler_batched_queries": sched.batched_queries,
        "density_many_s": density_s, "count_estimate_ms": count_s / len(counted) * 1e3,
        "count_estimates": estimates, "exact_counts": [len(o) for o in outs[:8]],
        "checked_query_many": len(many), "checked_scheduler": len(served),
        "checked_density_many": len(grids), "checked_counts": n_counts,
    }


# -- polygon paths ---------------------------------------------------------


def cluster_centres(seed):
    """The gaussian cluster centres gdelt_points draws first from the
    store's seed."""
    r = np.random.default_rng(seed)
    return r.uniform(-160, 160, 64), r.uniform(-55, 65, 64)


def polygon_query_set(seed, n, centres, timed: bool, specials: bool):
    """[(ecql, geometry as parsed, (lo_ms, hi_ms) | None, kind)] for n
    INTERSECTS queries: stars of 3-60 arms (6-120 edges), radii 1-12
    degrees, every other one centred on a cluster; ``timed`` adds a
    DURING window of 6 h - 14 d; ``specials``: the first four carry a
    hole, the next two are MultiPolygons, the next two have more than 256
    edges."""
    from geomesa_tpu_torch import geometry as geo

    r = np.random.default_rng(seed)
    wins = time_windows(r, n, T0_MS, SPAN_MS) if timed else [None] * n
    out = []
    for k in range(n):
        if k % 2 == 0:
            c = int(r.integers(0, 64))
            cx, cy = centres[0][c] + r.normal(0, 2), centres[1][c] + r.normal(0, 1.5)
        else:
            cx, cy = r.uniform(-165, 165), r.uniform(-75, 75)
        rad = float(r.uniform(1, 12))
        arms = int(r.integers(3, 61))
        # whole polygons inside the lon/lat domain (no antimeridian split)
        cx = float(np.clip(cx, -178 + rad, 178 - rad))
        cy = float(np.clip(cy, -88 + rad, 88 - rad))
        kind = "star"
        if specials and k < 4:
            g, kind = star(cx, cy, rad, arms, r, hole=True), "hole"
        elif specials and k < 6:
            other = star(cx - np.sign(cx) * 3 * rad, cy, rad / 2, arms, r)  # disjoint parts
            g, kind = geo.MultiPolygon([star(cx, cy, rad, arms, r), other]), "multi"
        elif specials and k < 8:
            g, kind = star(cx, cy, rad, int(r.integers(130, 141)), r), "e>256"
        else:
            g = star(cx, cy, rad, arms, r)
        q = f"INTERSECTS(geom, {geo.to_wkt(g)})"
        if wins[k] is not None:
            lo, hi = wins[k]
            q += f" AND dtg DURING {np.datetime64(lo, 'ms')}Z/{np.datetime64(hi, 'ms')}Z"
        # the geometry as the filter parses it
        out.append((q, geo.from_wkt(geo.to_wkt(g)), wins[k], kind))
    return out


def brute_polygon_ids(src, geom, window) -> np.ndarray:
    """f64 brute force: the bbox and the window first, then the even-odd
    point-in-polygon test over every ring."""
    from geomesa_tpu_torch import geometry as geo

    x, y, t = src
    x0, y0, x1, y1 = geom.bounds()
    m = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
    if window is not None:
        m &= (t >= window[0]) & (t < window[1])
    cand = np.flatnonzero(m)
    return cand[geo.points_in_polygon(x[cand], y[cand], geom)]


def leg_of(config) -> str:
    """The scan legs a polygon config rides: pip, raster, pip+raster, or
    bbox (host refinement alone)."""
    legs = [n for n, b in (("pip", config.poly), ("raster", config.rast)) if b is not None]
    return "+".join(legs) or "bbox"


@contextmanager
def raster_knob(name, value):
    """One raster knob set for the block (the raster cache dropped around
    it)."""
    from geomesa_tpu_torch import conf
    from geomesa_tpu_torch.filter import raster as fr

    prop = getattr(conf, name)
    prop.set(value)
    fr.clear_cache()
    try:
        yield
    finally:
        prop.clear()
        fr.clear_cache()


def host_density(x, y, envelope, width, height) -> np.ndarray:
    """The reference's pixel rule over hit coordinates (numpy)."""
    x0, y0, x1, y1 = envelope
    grid = np.zeros(height * width, np.float32)
    m = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
    px = np.clip(((x - x0) / (x1 - x0) * width).astype(np.int64), 0, width - 1)
    py = np.clip(((y - y0) / (y1 - y0) * height).astype(np.int64), 0, height - 1)
    np.add.at(grid, (py * width + px)[m], 1)
    return grid.reshape(height, width)


def polygon_path(torch, ds, src, index: str, warm, measured, n_brute: int, n_settings: int,
                 n_agg: int, n_full_scan: int) -> dict:
    """Polygon queries through query (untraced, then traced), query_many,
    the scheduler (8 threads), the same queries under the two other raster
    settings, count / bounds / density, and the old full-table host scan
    for comparison; launch counts zeroed before, read after, checks after
    that."""
    from concurrent.futures import ThreadPoolExecutor

    from geomesa_tpu_torch.planning.planner import QueryPlan
    from geomesa_tpu_torch.timing import NULL_CLOCK, PhaseClock

    table = ds.table("gdelt", index)
    filters = [q for q, *_ in measured]
    zero_launches()
    run_queries(ds, warm)
    lat, outs, wall = run_queries(ds, measured)
    ds.clock = clock = PhaseClock()
    _, _, traced_wall = run_queries(ds, measured)
    phases = {k: v / len(measured) * 1e3 for k, v in clock.settle().items()}
    ds.clock = NULL_CLOCK
    device_ms = sum(phases.get(k, 0.0) for k in ("h2d", "kernel", "d2h"))

    legs: dict = {}
    cand_blocks, cont_rows = [], []
    for q in filters:
        cfg = ds.planner.plan("gdelt", q).config
        check(cfg is not None and ds.planner.plan("gdelt", q).index == index,
              f"polygon query plans to the {index} index scan: {q[:60]}")
        legs[leg_of(cfg)] = legs.get(leg_of(cfg), 0) + 1
        overlap, contained = table.candidate_spans_split(cfg)
        cand_blocks.append(len(table.candidate_blocks(overlap)))
        cont_rows.append(sum(z - a for a, z in contained))

    with chunk_recorder() as members:
        t0 = time.perf_counter()
        many = ds.query_many("gdelt", filters)
        many_s = time.perf_counter() - t0

    sched = ds.serve()
    try:
        def client(k):
            futs = [sched.submit("gdelt", q) for q in filters[k * 6:(k + 1) * 6]]
            return [f.result(600) for f in futs]

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            served = [o for outs_k in ex.map(client, range(8)) for o in outs_k]
        serve_s = time.perf_counter() - t0
    finally:
        sched.close()

    settings = {}
    for label, name, value in (("device_residue", "RASTER_RESIDUE", "device"),
                               ("raster_off", "RASTER_ENABLED", False)):
        with raster_knob(name, value):
            s_lat, s_outs, _ = run_queries(ds, measured[:n_settings])
            # every query through query_many: groups of more than 8
            # members fuse (smaller ones go to K1), so the chunks of this
            # setting's leg combination run
            s_many = ds.query_many("gdelt", filters)
            s_legs: dict = {}
            for q in filters[:n_settings]:
                leg = leg_of(ds.planner.plan("gdelt", q).config)
                s_legs[leg] = s_legs.get(leg, 0) + 1
        settings[label] = (s_lat, s_outs, s_many, s_legs)

    brute = [brute_polygon_ids(src, g, w) for _, g, w, _ in measured[:n_brute]]
    with_hits = [k for k in np.argsort([-len(b) for b in brute], kind="stable")[:n_agg]]
    aggs = []
    t0 = time.perf_counter()
    for k in with_hits:
        q = filters[k]
        env = measured[k][1].bounds()
        aggs.append((ds.count("gdelt", q), ds.bounds("gdelt", q, estimate=False),
                     ds.bounds("gdelt", q, estimate=True),
                     ds.stats_query("gdelt", "Count()", q, estimate=True)[0].count,
                     ds.density("gdelt", q, envelope=env, width=128, height=128)))
    agg_s = time.perf_counter() - t0
    launches, leg_launches = read_launches(), read_leg_launches()

    # the full-table host scan the port ran for every polygon before this
    # slice, on the smallest polygons (it reads every row)
    full_ms = []
    for k in np.argsort([len(b) for b in brute], kind="stable")[:n_full_scan]:
        t0 = time.perf_counter()
        full = ds.planner.execute(QueryPlan("gdelt", ds.planner.plan("gdelt", filters[k]).filter,
                                            None, None))
        full_ms.append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(np.sort(np.asarray(full.ids, np.int64)), brute[k]),
              f"full-table host scan vs brute force: {filters[k][:60]}")

    for k, ids in enumerate(brute):
        got = np.sort(np.asarray(outs[k].ids, np.int64))
        check(np.array_equal(got, ids), f"polygon ids vs brute force ({measured[k][3]}): "
                                        f"{filters[k][:60]}")
    check_same_ids(many, outs, f"{index} polygon query_many vs sequential query")
    check_same_ids(served, outs, f"{index} polygon scheduler vs sequential query")
    for label, (_, s_outs, s_many, _) in settings.items():
        check_same_ids(s_outs, outs[:n_settings], f"{index} polygon ids under {label}")
        check_same_ids(s_many, outs, f"{index} polygon query_many under {label}")
    x, y, _ = src
    for k, (n, env, env_est, est, grid) in zip(with_hits, aggs):
        ids = brute[k]
        check(n == len(ids) == est, f"polygon count {n} / Count() {est} vs brute {len(ids)}")
        ref_env = (float(x[ids].min()), float(y[ids].min()), float(x[ids].max()),
                   float(y[ids].max())) if len(ids) else None
        check(env == env_est == ref_env, f"polygon bounds {env} / {env_est} vs brute {ref_env}")
        ref = host_density(x[ids], y[ids], measured[k][1].bounds(), 128, 128)
        check(np.array_equal(grid, ref) and grid.sum() == len(ids), "polygon density vs brute")
    hits = sum(len(o) for o in outs)
    return {
        "launches": launches, "leg_launches": leg_launches,
        "n_points": table.n, "index": index, "n_blocks": table.n_blocks,
        "n_queries": len(measured), "hits_total": hits,
        "query_kinds": {kd: sum(1 for *_, k2 in measured if k2 == kd)
                        for kd in sorted({m[3] for m in measured})},
        "queries_by_leg": legs,
        "candidate_blocks_mean": float(np.mean(cand_blocks)),
        "candidate_blocks_max": int(np.max(cand_blocks)),
        "contained_rows_mean": float(np.mean(cont_rows)),
        "full_scan_blocks": table.n_blocks,
        "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
        "latency_p84_ms": float(np.percentile(lat, 84) * 1e3),
        "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
        "latency_mean_ms": float(lat.mean() * 1e3),
        "features_per_s": hits / wall,
        "phase_ms_per_query": phases,
        "traced_ms_per_query": traced_wall / len(measured) * 1e3,
        "device_busy_share": device_ms / (traced_wall / len(measured) * 1e3),
        "query_many_s": many_s, "query_many_queries_per_s": len(filters) / many_s,
        "chunks": len(members), "members_per_chunk": members,
        "scheduler_wall_s": serve_s, "scheduler_queries_per_s": len(served) / serve_s,
        "settings": {label: {"n_queries": len(s_outs),
                             "latency_p50_ms": float(np.percentile(s_lat, 50) * 1e3),
                             "queries_by_leg": s_legs}
                     for label, (s_lat, s_outs, _, s_legs) in settings.items()},
        "settings_default_latency_p50_ms": float(np.percentile(lat[:n_settings], 50) * 1e3),
        "aggregations_s": agg_s,
        "full_scan_ms": full_ms,
        "pruned_latency_ms_same_queries": [
            float(lat[k] * 1e3)
            for k in np.argsort([len(b) for b in brute], kind="stable")[:n_full_scan]],
        "checked_vs_brute_force": len(brute), "checked_query_many": len(many),
        "checked_scheduler": len(served),
        "checked_settings": sum(len(v[1]) + len(v[2]) for v in settings.values()),
        "checked_aggregations": len(aggs),
    }


def main_path(torch, device):
    """Five paths, each with its own launch counts (zeroed just before it
    runs, read just after): the single-query main path, the batch path
    and the polygon path on the same store, the packed-time cell and the
    Z2 polygon cell."""
    from geomesa_tpu_torch.timing import NULL_CLOCK, PhaseClock

    zero_launches()
    ds, src, ingest_s = build_store(torch, device, N_MAIN, packed=False)
    table = ds.table("gdelt", "z3")
    warm = query_set(SEED + 1, N_WARMUP)
    measured = query_set(SEED + 2, N_MEASURED)
    run_queries(ds, warm)
    lat, outs, wall = run_queries(ds, measured)  # untraced: the end-to-end numbers
    # a second, traced pass over the same queries splits the time by phase
    ds.clock = clock = PhaseClock()
    _, _, traced_wall = run_queries(ds, measured)
    phases = {k: v / len(measured) * 1e3 for k, v in clock.settle().items()}
    ds.clock = NULL_CLOCK
    device_ms = sum(phases.get(k, 0.0) for k in ("h2d", "kernel", "d2h"))
    hits = sum(len(o) for o in outs)
    n_brute = check_queries(ds, src, measured, outs, 8)
    n_agg = check_aggregations(torch, ds, busiest(measured, outs, 4))
    launches = read_launches()
    rec = {
        "phase": "main_path", "cell": "gdelt-z3-100M", "launches": launches,
        "n_points": N_MAIN, "index": "z3",
        "ingest_s": ingest_s, "ingest_rows_per_s": N_MAIN / ingest_s,
        "device_gb": table.nbytes_device / 1e9,
        "n_blocks": table.n_blocks, "n_queries": len(measured), "hits_total": hits,
        "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
        "latency_p84_ms": float(np.percentile(lat, 84) * 1e3),
        "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
        "latency_mean_ms": float(lat.mean() * 1e3),
        "features_per_s": hits / wall,
        "phase_ms_per_query": phases,
        "traced_ms_per_query": traced_wall / len(measured) * 1e3,
        "device_busy_share": device_ms / (traced_wall / len(measured) * 1e3),
        "checked_vs_brute_force": n_brute, "checked_aggregations": n_agg,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    batch = batch_path(torch, ds, measured, outs, wall)
    centres = cluster_centres(SEED)
    poly = polygon_path(
        torch, ds, src, "z3", polygon_query_set(SEED + 21, N_POLY_WARMUP, centres, True, False),
        polygon_query_set(SEED + 22, N_POLY_MEASURED, centres, True, True),
        n_brute=8, n_settings=16, n_agg=4, n_full_scan=2,
    )
    poly = {"phase": "polygon_path", "cell": "gdelt-z3-100M-polygon", **poly}
    del ds, src, outs, table
    torch.cuda.empty_cache()

    zero_launches()
    ds, src, ingest_s = build_store(torch, device, N_PACKED, packed=True)
    table = ds.table("gdelt", "z3")
    check(table.col_names == ("tw", "x", "y"), "packed-time table holds tw")
    queries = query_set(SEED + 3, N_PACKED_QUERIES)
    lat, outs, wall = run_queries(ds, queries)
    n_brute = check_queries(ds, src, queries, outs, 4)
    n_agg = check_aggregations(torch, ds, busiest(queries, outs, 2))
    many = ds.query_many("gdelt", [q for q, _ in queries])
    counted = busiest(queries, outs, 2)
    estimates = count_estimates(ds, counted)
    launches = read_launches()
    check_same_ids(many, outs, "packed query_many vs sequential query")
    exact = {q: o for (q, _), o in zip(queries, outs)}
    n_counts = check_counts(torch, ds, counted, [exact[q] for q, _ in counted], estimates)
    packed = {
        "phase": "main_path_packed_time", "cell": "gdelt-z3-packed-10M",
        "launches": launches, "n_points": N_PACKED,
        "ingest_s": ingest_s, "device_gb": table.nbytes_device / 1e9,
        "n_queries": len(queries), "hits_total": sum(len(o) for o in outs),
        "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
        "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
        "features_per_s": sum(len(o) for o in outs) / wall,
        "checked_vs_brute_force": n_brute, "checked_aggregations": n_agg,
        "checked_query_many": len(many), "checked_counts": n_counts,
    }
    del ds, src, outs, table, many
    torch.cuda.empty_cache()

    zero_launches()
    ds, src, ingest_s = build_store(torch, device, N_Z2, index="z2", seed=SEED + 30)
    centres = cluster_centres(SEED + 30)
    z2 = polygon_path(
        torch, ds, src, "z2", polygon_query_set(SEED + 31, 4, centres, False, False),
        polygon_query_set(SEED + 32, N_Z2_POLY_QUERIES, centres, False, True),
        n_brute=4, n_settings=8, n_agg=2, n_full_scan=1,
    )
    z2 = {"phase": "polygon_path_z2", "cell": "gdelt-z2-20M-polygon", "ingest_s": ingest_s,
          "device_gb": ds.table("gdelt", "z2").nbytes_device / 1e9, **z2}
    del ds, src
    torch.cuda.empty_cache()
    return rec, batch, poly, packed, z2


# -- entry point -------------------------------------------------------------


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from geomesa_tpu_torch.kernels import KERNELS, build_all

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = nvidia_smi()
    build_s = build_all()
    emit({"phase": "device", "nvidia_smi": smi, "torch_device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda, "build_s": build_s})

    timings = kernel_phase(torch, device)
    emit({"phase": "kernels_vs_plain", **{k: v for k, v in timings.items()}})

    records = main_path(torch, device)
    for rec in records:
        emit(rec)
    paths = {r["cell"]: r["launches"] for r in records}
    # each path names the kernels it is meant to run
    expected = {
        "gdelt-z3-100M": ("block_scan", "density", "bounds"),
        "gdelt-z3-100M-batch": ("block_scan_multi", "block_pops", "density"),
        "gdelt-z3-100M-polygon": ("block_scan", "block_scan_multi"),
        "gdelt-z3-packed-10M": tuple(k.name for k in KERNELS),
        "gdelt-z2-20M-polygon": ("block_scan", "block_scan_multi"),
    }
    for cell, names in expected.items():
        for name in names:
            check(paths[cell][name] > 0, f"kernel {name} launched on the {cell} path")
    # ... and the polygon legs they are meant to run
    leg_paths = {r["cell"]: r["leg_launches"] for r in records if "leg_launches" in r}
    expected_legs = {
        "gdelt-z3-100M-polygon": {"block_scan": ("pip", "raster", "pip+raster"),
                                  "block_scan_multi": ("pip", "raster", "pip+raster")},
        "gdelt-z2-20M-polygon": {"block_scan": ("raster",), "block_scan_multi": ()},
    }
    for cell, kernels in expected_legs.items():
        for name, legs in kernels.items():
            counts = leg_paths[cell][name]
            for leg in legs:
                check(counts[leg] > 0, f"{name} leg {leg} launched on the {cell} path")
            check(sum(counts.values()) > 0, f"{name} polygon legs launched on the {cell} path")

    replaces = {
        "block_scan": "geomesa_tpu/scan/block_kernels.py:685 (_pallas_block_scan; pallas_call :727)",
        "density": "geomesa_tpu/scan/aggregations.py:244 (_pallas_density; pallas_call :273)",
        "bounds": "geomesa_tpu/scan/aggregations.py:358 (_pallas_bounds; pallas_call :378)",
        "block_scan_multi": "geomesa_tpu/scan/block_kernels.py:847 "
                            "(_pallas_block_scan_multi; pallas_call :904)",
        "block_pops": "geomesa_tpu/scan/aggregations.py:86 "
                      "(_pops_pallas; through _pallas_block_scan's pallas_call block_kernels.py:727)",
    }
    kernels = []
    for k in KERNELS:
        t = timings[k.name]
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"geomesa_tpu_torch/csrc/{k.name}.cu",
            "replaces": replaces[k.name],
            "launches": sum(launches[k.name] for launches in paths.values()),
            "launches_by_path": {cell: launches[k.name] for cell, launches in paths.items()},
            "equal_to_plain": t["max_abs_err"] == 0.0, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "kernel_ms": t["ms"], "wrapper_ms": t["wrapper_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"],
            **({"legs": t["legs"],
                "leg_launches_by_path": {cell: legs[k.name] for cell, legs in leg_paths.items()}}
               if "legs" in t else {}),
        })
    emit({"kernels": kernels, "wall_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    # the run drives one card, cuda:0
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
