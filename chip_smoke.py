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
   48 polygon queries, each with and without the window; then the
   extent leg of all five on synthetic extent columns: K1 and K1p at
   M = 4096 and K2 at M = 2048 with 48 extent queries of 1-8 box slots,
   each with and without the window, the window alone and the validity
   leg, K3 and K4 over the bbox centres); results must be equal word for
   word; each kernel's and leg's time (CUDA events, median of 25 runs
   after warm-up: the launch alone, and the whole wrapper with its
   staging) beside its bound and the plain version's time;
3. probes: the chip-side design probes at the JAX probes' sizes, each
   through its own ``run`` (geomesa_tpu_torch/scripts/): P1
   (``probe_pallas``: 64 Mi rows of x, y, tbin, toff, 1.07 GB on the
   card, M = 128 and 1024: the scan kernel with all 8 box and window
   slots, its end-to-end query, and K1 on the same columns as the
   yardstick, on the probe's params and on the same predicate split
   into 8 real slots of each leg, where K1 does P1's slot work) and P2 (``probe_agg``: 4096 blocks of x, y, 0.54 GB, M =
   256 and 1024: the bounds kernel, the one-hot density kernel on the
   tensor cores in its two chunk variants, K1, K3 and ``bincount`` as
   yardsticks); every probe kernel equal to its plain version word for
   word at both M, pad slots included, P1's rows at M = 128 equal to
   numpy's; the columns are freed before the main path;
4. main path: a GDELT-shaped Z3 point table of 100,000,000 rows (the
   reference benchmark's configuration 1, cut from 500M for the run's
   time) in ``DataStore(device="cuda")``, 16 warm-up and 64 measured
   BBOX + DURING queries (latency untraced, then a traced pass of the same
   queries for the per-phase split), 8 of them checked against an f64 brute-force
   filter, 4 density grids and 4 bounds estimates checked against the
   plain versions on the same device table;
5. batch path, on the same store: ``query_many`` over the 64 queries (a
   warm call, a timed one, then a traced one for the per-phase split),
   the serving scheduler under 8 client threads of 8 queries each,
   ``density_many`` over the 4 busiest queries' envelopes and 8
   ``stats_query("Count()", estimate=True)``;
   ids equal the sequential queries', grids the sequential ``density``
   grids, and each count the table's count arithmetic over the plain
   popcount;
6. polygon path, on the same store: 8 warm-up and 48 measured
   ``INTERSECTS(geom, <star polygon>) AND dtg DURING`` queries (4 with a
   hole, 2 MultiPolygons, 2 past 256 edges), untraced then traced,
   ``query_many``, the scheduler (8 threads x 6 queries), 16 of them
   again with ``geomesa.raster.residue=device`` and with
   ``geomesa.raster.enabled=false`` (and all 48 through ``query_many``
   under each), count / bounds / Count() / density
   over 4 of them, and the full-table host scan the port used to run on
   2; ids, counts, envelopes and grids checked against an f64 brute
   force, every other path's ids against the sequential queries';
7. a 10,000,000-row table with packed time, 16 queries, ``query_many``
   and two count estimates;
8. a Z2 table of 20,000,000 points (the reference benchmark's
   configuration 4): the polygon path with 32 queries and no time;
9. osm-xz2-50M: the reference benchmark's configuration 3, building
   footprints on an XZ2 table, cut from 200M to 50,000,000 rectangles;
   8 warm-up and 40 measured INTERSECTS rectangle queries untraced, then
   traced, ``query_many``, the scheduler (8 threads x 5 queries),
   ``IndexTable.count`` / ``density`` / ``bounds_stats`` over 4 of them
   against the plain versions on the same device table, and 8 queries'
   ids and counts against an f64 brute force;
10. xz3-10M-mixed: 10,000,000 extent features with dates over 120 days
   on an XZ3 table, 99 % footprint rectangles and 1 % triangles, stars,
   LineStrings and MultiPolygons; 8 warm-up and 32 measured INTERSECTS
   (rectangle, star) and BBOX queries AND DURING, and DURING alone,
   untraced then traced, ``query_many``, and 8 queries' ids against an
   f64 brute force written here (box algebra, even-odd vertex tests and
   edge crossings).

Launch counts (and the legs' counts) are zeroed just before each of the
seven paths and read just after it; each path must have launched the
kernels and legs it names (main: K1, K3, K4; batch: K2, K1p, K3; Z3
polygon: K1 and K2 each with PIP, raster and both legs; packed time:
all five; Z2 polygon: K1's raster leg, K2 with stacks; XZ2: all five
with the extent leg; XZ3: K1 and K2 with the extent leg); the probe
phase zeroes and reads its own (each probe kernel, and each density
variant, launched).

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

# the package beside this script: its timer and comparison, shared with the
# probes (in a directory without it, the import fails and nothing runs)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from geomesa_tpu_torch.timing import event_ms, max_abs_err  # noqa: E402

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
# the reference benchmark's configuration 3 (XZ2 building footprints), cut
# from 200M for the host's numpy ingest and the run's time, and an XZ3
# table of mixed extents with dates
N_XZ2 = 50_000_000
N_XZ2_MEASURED = 40
N_XZ3 = 10_000_000
N_XZ3_OTHER = 100_000
N_XZ3_MEASURED = 32
N_XZ_WARMUP = 8
K2_SLOTS = 2048  # the fused chunk's slots at 100M rows (storage.table.fused_slots)
SEED = 42
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet); the
# kernels' int32 compares and bit operations are counted at this rate too
OPS_PER_S = 67e12
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
        "ms": event_ms(launch),
        "wrapper_ms": event_ms(lambda: bk.block_scan(c3, bids, boxes, wins, **kw)),
        "plain_ms": event_ms(lambda: bk.block_scan_plain(*pargs, **flags)),
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
        "ms": event_ms(d_launch),
        "wrapper_ms": event_ms(lambda: agg.block_density(
            c3, bids, boxes, wins, gb, width=256, height=256, **kw)),
        "plain_ms": event_ms(lambda: agg.density_plain(
            *pargs, dev(gb, torch.float32), width=256, height=256, **flags)),
        **bound(col_bytes + 256 * 256 * 4 + bids.nbytes, density_ops),
        "library_ms": event_ms(lambda: torch.bincount(flat, minlength=256 * 256)),
        "checks": agg_checks,
        "hits": int(flat.numel()),
        "shape": f"M={t_m} SUB={sub} grid=256x256 cols={','.join(names)}",
    }
    _, b_launch = agg.bounds_launcher(tcols, bids, boxes, wins, **flags)
    out["bounds"] = {
        "ms": event_ms(b_launch),
        "wrapper_ms": event_ms(lambda: agg.block_bounds(c3, bids, boxes, wins, **kw)),
        "plain_ms": event_ms(lambda: agg.bounds_plain(*pargs, **flags)),
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
    for name, leg in extent_kernels(torch, device, n_blocks, sub, boxes, wins, dev).items():
        out[name].setdefault("legs", {})["extent"] = leg
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], leg["max_abs_err"])
    return out


# -- phase 3: the chip-side probes ------------------------------------------

# the probes' kernels in the kernels line: (entry name, kernel, density
# variant or None, replaced TPU kernel)
PROBE_ENTRIES = (
    ("probe_scan", "probe_scan", None,
     "scripts/probe_pallas.py:67 (block_scan, body scan_kernel :25; pallas_call :84)"),
    ("probe_bounds", "probe_bounds", None,
     "scripts/probe_agg.py:128 (make_pallas(_bounds_kernel), body :109; pallas_call :144)"),
    ("probe_density:reshape", "probe_density", "reshape",
     "scripts/probe_agg.py:128 (make_pallas(_density_kernel_reshape), body :58; "
     "pallas_call :144)"),
    ("probe_density:fori", "probe_density", "fori",
     "scripts/probe_agg.py:128 (make_pallas(_density_kernel_fori), body :85; "
     "pallas_call :144)"),
)


def probe_phase(torch, device):
    """P1 and P2 through their own ``run`` at the JAX probes' sizes, the
    launch counts zeroed just before and read just after. Checks: P1's
    rows at M = 128 equal numpy's, every probe kernel equals its plain
    version at both M (pad slots included), K1's planes equal P1's and
    K3's grid P2's density, and each probe kernel and density leg
    launched. Returns (record, kernel entries for the kernels line)."""
    from geomesa_tpu_torch.kernels import KERNELS, PROBE_DENSITY, PROBE_KERNELS
    from geomesa_tpu_torch.scripts import probe_agg, probe_pallas

    for k in (*KERNELS, *PROBE_KERNELS):
        k.reset_counts()
    t0 = time.perf_counter()
    p1 = probe_pallas.run(device)
    p2 = probe_agg.run(device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in (*KERNELS, *PROBE_KERNELS)}
    legs = dict(PROBE_DENSITY.leg_launches)
    torch.cuda.empty_cache()

    check(p1["check"]["ok"] and p1["check"]["rows"] > 0, "P1 rows at M=128 equal numpy's")
    for r in p1["records"]:
        check(r["max_abs_err"] == 0.0, f"probe_scan equals plain at M={r['M']}")
        check(r["k1_equal"], f"K1 planes equal P1's at M={r['M']}")
        check(r["split_equal"], f"P1 and K1 on the 8-slot split equal P1's planes at M={r['M']}")
    for r in p2["records"]:
        for name, e in r["max_abs_err"].items():
            check(e == 0.0, f"probe {name} equals plain at M={r['M']}")
        check(r["k3_equal"], f"K3 grid equals P2's density at M={r['M']}")
    for k in PROBE_KERNELS:
        check(launches[k.name] > 0, f"probe kernel {k.name} launched")
    for leg, n in legs.items():
        check(n > 0, f"probe_density leg {leg} launched")

    entries = []
    for name, kname, variant, replaces in PROBE_ENTRIES:
        by_m = {}
        if kname == "probe_scan":
            for r in p1["records"]:
                by_m[r["M"]] = {
                    "ms": r["kernel_ms"], "wrapper_ms": r["wrapper_ms"], "plain_ms": r["plain_ms"],
                    **bound(r["bytes"], r["ops"]), "library_ms": None,
                    "max_abs_err": r["max_abs_err"], "gb_per_s": r["gb_per_s"],
                    "query_ms": r["query_ms"], "k1_ms": r["k1_ms"],
                    "k1_wrapper_ms": r["k1_wrapper_ms"], "split_ms": r["split_kernel_ms"],
                    "split_k1_ms": r["split_k1_ms"], "rows": r["rows"],
                    "shape": f"M={r['M']} SUB=128 cols=x,y,tbin,toff slots=8+8",
                }
        else:
            for r in p2["records"]:
                if variant is None:
                    a = r["bounds"]
                    ms, wms, plain, lib = a["kernel_ms"], a["wrapper_ms"], r["plain_bounds_ms"], None
                    err, extra = r["max_abs_err"]["bounds"], {}
                else:
                    a = r["density"]
                    v = a[variant]
                    ms, wms, plain = v["kernel_ms"], v["wrapper_ms"], r["plain_density_ms"]
                    lib, err = r["bincount_ms"], r["max_abs_err"][variant]
                    extra = {"tc_flops": a["tc_flops"], "tc_tflops": v["tc_tflops"],
                             "tc_share": v["tc_share"],
                             "tc_bound_ms": a["tc_flops"] / probe_agg.TC_FLOPS_PER_S * 1e3,
                             "k3_ms": r["k3_ms"], "k3_wrapper_ms": r["k3_wrapper_ms"],
                             "chunk_sublanes": 32 if variant == "reshape" else 1}
                by_m[r["M"]] = {
                    "ms": ms, "wrapper_ms": wms, "plain_ms": plain, **bound(a["bytes"], a["ops"]),
                    "library_ms": lib, "max_abs_err": err, "hits": a["hits"],
                    "k1_ms": r["k1_ms"], **extra,
                    "shape": f"M={r['M']} SUB=128 cols=x,y boxes=8"
                             + (" grid=256x256" if variant else ""),
                }
        top = by_m[max(by_m)]  # the largest M heads the entry
        entries.append({
            "name": name, "route": "cuda", "source": f"geomesa_tpu_torch/csrc/{kname}.cu",
            "replaces": replaces,
            "launches": legs[variant] if variant else launches[kname],
            "launches_by_path": {"probes": legs[variant] if variant else launches[kname]},
            "equal_to_plain": all(b["max_abs_err"] == 0.0 for b in by_m.values()),
            "max_abs_err": max(b["max_abs_err"] for b in by_m.values()),
            "ms": top["ms"], "kernel_ms": top["ms"], "wrapper_ms": top["wrapper_ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "shape": top["shape"], "by_m": by_m,
        })
    rec = {"phase": "probes", "wall_s": wall, "launches": launches,
           "probe_density_legs": legs, "probe_pallas": p1, "probe_agg": p2}
    return rec, entries


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
        "ms": event_ms(launch),
        "wrapper_ms": event_ms(lambda: bk.block_scan_multi(c3, bids, qids, boxes, wins,
                                                                 **kw)),
        "plain_ms": event_ms(lambda: bk.block_scan_multi_plain(*pargs, **flags)),
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
        "ms": event_ms(p_launch),
        "wrapper_ms": event_ms(lambda: agg.block_pops(c3, bids, boxes1, wins1, **kw)),
        "plain_ms": event_ms(lambda: agg.block_pops_plain(*pargs, **flags)),
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
            "ms": event_ms(launch),
            "wrapper_ms": event_ms(lambda: bk.block_scan(
                c3, bids, boxes, wins, col_names=windowed, has_boxes=True, has_windows=True,
                **kw)),
            "plain_ms": event_ms(lambda: bk.block_scan_plain(
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
            "ms": event_ms(launch),
            "wrapper_ms": event_ms(lambda: bk.block_scan_multi(
                c3, bids2, qids, qboxes, wins_q, col_names=windowed, has_boxes=True,
                has_windows=True, **kw)),
            "plain_ms": event_ms(lambda: bk.block_scan_multi_plain(
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


def extent_columns(torch, n_blocks, sub, device):
    """[n_blocks, sub, 128] extent columns (gxmin, gymin, gxmax, gymax),
    and tbin / toff, made on the card from a seed: bboxes from a point up
    to a few degrees wide, widened one f32 ulp outward as the packed column
    stores them; the last block's tail carries the extent table's pad
    sentinels (an empty bbox, +inf / -inf)."""
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 40)
    shape = (n_blocks, sub, 128)
    inf = torch.tensor(float("inf"), device=device)
    x0 = torch.rand(shape, generator=g, device=device) * 356 - 180
    y0 = torch.rand(shape, generator=g, device=device) * 176 - 90
    w = -torch.log1p(-torch.rand(shape, generator=g, device=device)) * 0.5
    h = -torch.log1p(-torch.rand(shape, generator=g, device=device)) * 0.5
    cols = {"gxmin": torch.nextafter(x0, -inf), "gymin": torch.nextafter(y0, -inf),
            "gxmax": torch.nextafter(x0 + w, inf), "gymax": torch.nextafter(y0 + h, inf)}
    del x0, y0, w, h
    cols["tbin"] = torch.randint(2800, 2820, shape, generator=g, device=device, dtype=torch.int32)
    cols["toff"] = torch.randint(0, 604_800, shape, generator=g, device=device, dtype=torch.int32)
    tail = (slice(-1, None), slice(sub // 2, None))
    cols["gxmin"][tail] = cols["gymin"][tail] = float("inf")
    cols["gxmax"][tail] = cols["gymax"][tail] = float("-inf")
    cols["tbin"][tail] = -1
    cols["toff"][tail] = 0
    return {k: v.contiguous() for k, v in cols.items()}


EXT = ("gxmax", "gxmin", "gymax", "gymin")  # the extent columns, as a table projects them


def extent_kernels(torch, device, n_blocks, sub, boxes1, wins1, dev):
    """The extent leg of all five kernels against their plain versions on
    synthetic extent columns of the main table's block count, then timed:
    K1 and K1p at M = 4096 and K2 at M = 2048 with 48 extent queries of
    1-8 box slots (K1 and K1p take 8 of them one by one), each with and
    without the window on (tbin, toff), plus the window alone and the
    validity leg on gxmin; K3 (256 x 256 and 33 x 17 grids) and K4 at
    M = 4096 with -1 pads, over the bbox centres. Timed on the XZ2 path's
    shape: the box leg on the four extent columns, 2 box slots."""
    from geomesa_tpu_torch.scan import aggregations as agg
    from geomesa_tpu_torch.scan import block_kernels as bk

    cols = extent_columns(torch, n_blocks, sub, device)
    windowed = tuple(sorted(EXT + ("tbin", "toff")))
    variants = [("box+window", windowed, True, True), ("box", EXT, True, False)]
    others = [("window", ("tbin", "toff"), False, True), ("valid", ("gxmin",), False, False)]
    n_q = 48
    qboxes, qwins, _ = query_stacks(n_q, SEED + 41)
    rng = np.random.default_rng(SEED + 42)
    err = dict.fromkeys(("block_scan", "block_pops", "block_scan_multi", "density", "bounds"), 0.0)
    checks = dict.fromkeys(err, 0)

    def cmp(name, got, ref, what):
        if got is None or ref is None:
            check(got is None and ref is None, f"{name} extent {what}: plane count")
            return
        err[name] = max(err[name], max_abs_err(got, ref))
        check(torch.equal(got, ref), f"{name} extent {what}")

    m = bk.M_BUCKETS[-1]
    bids, _ = bk.pad_bids(np.sort(rng.choice(n_blocks, size=m, replace=False)), n_blocks)
    tbids = dev(bids, torch.int32)
    cases = [(f"{v[0]} q{q}", *v[1:], qboxes[q], qwins[q]) for q in range(8) for v in variants]
    cases += [(o[0], *o[1:], qboxes[0], qwins[0]) for o in others]
    selected: dict = {}  # per variant: some query of it selects rows
    for what, names, hb, hw, bx, wn in cases:
        c3 = tuple(cols[k] for k in names)
        kw = dict(col_names=names, has_boxes=hb, has_windows=hw, extent=True)
        flags = dict(has_boxes=hb, has_windows=hw, extent=True)
        pargs = (dict(zip(names, c3)), tbids, dev(bx, torch.float32), dev(wn, torch.int32))
        w, i = bk.block_scan(c3, bids, bx, wn, **kw)
        pw, pi = bk.block_scan_plain(*pargs, **flags)
        cmp("block_scan", w, pw, f"{what} M={m}")
        cmp("block_scan", i, pi, f"{what} M={m} inner")
        selected[what.split()[0]] = selected.get(what.split()[0], False) or bool(w.any())
        check((i is None) == hb, f"block_scan extent {what}: one plane with boxes")
        del w, i, pw, pi
        checks["block_scan"] += 1
        got = agg.block_pops(c3, bids, bx, wn, **kw)
        cmp("block_pops", got, agg.block_pops_plain(*pargs, **flags), f"{what} M={m}")
        checks["block_pops"] += 1
    for variant, sel in selected.items():
        check(sel, f"block_scan extent {variant} selects rows")

    m2 = K2_SLOTS
    n_real = m2 - m2 // 40
    bids2, _ = bk.pad_bids(rng.integers(0, n_blocks, n_real), n_blocks, bucket=m2)
    qids = np.zeros(m2, np.int32)
    qids[:n_real] = rng.permutation(np.arange(n_real) % n_q)
    tb2, tq = dev(bids2, torch.int32), dev(qids, torch.int32)
    for what, names, hb, hw in variants + others:
        c3 = tuple(cols[k] for k in names)
        w, i = bk.block_scan_multi(c3, bids2, qids, qboxes, qwins, col_names=names,
                                   has_boxes=hb, has_windows=hw, extent=True)
        pw, pi = bk.block_scan_multi_plain(
            dict(zip(names, c3)), tb2, tq, dev(qboxes, torch.float32), dev(qwins, torch.int32),
            has_boxes=hb, has_windows=hw, extent=True)
        cmp("block_scan_multi", w, pw, f"{what} M={m2}")
        cmp("block_scan_multi", i, pi, f"{what} M={m2} inner")
        check(bool(w.any()), f"block_scan_multi extent {what} selects rows")
        del w, i, pw, pi
        checks["block_scan_multi"] += 1

    gb = np.array([-100, -60, 120, 70], np.float32)
    pbids, _ = bk.pad_bids(np.sort(rng.choice(n_blocks, size=m - 96, replace=False)), n_blocks,
                           pad=-1)
    tpb = dev(pbids, torch.int32)
    for what, names, hb, hw in variants + others[:1]:
        names = tuple(sorted(set(names) | set(EXT)))  # the aggregations read the extents
        c3 = tuple(cols[k] for k in names)
        kw = dict(col_names=names, has_boxes=hb, has_windows=hw, extent=True)
        flags = dict(has_boxes=hb, has_windows=hw, extent=True)
        pargs = (dict(zip(names, c3)), tpb, dev(boxes1, torch.float32), dev(wins1, torch.int32))
        for width, height in ((256, 256), (33, 17)):
            got = agg.block_density(c3, pbids, boxes1, wins1, gb, width=width, height=height, **kw)
            ref = agg.density_plain(*pargs, dev(gb, torch.float32), width=width, height=height,
                                    **flags)
            cmp("density", got, ref, f"{what} {width}x{height}")
            check(float(got.sum()) > 0, f"density extent {what} counts rows")
            checks["density"] += 1
        st = agg.block_bounds(c3, pbids, boxes1, wins1, **kw)
        sp = agg.bounds_plain(*pargs, **flags)
        n_r = m - 96
        cmp("bounds", st[:n_r], sp[:n_r], what)
        check(bool(torch.isfinite(st[:n_r, 1:5][st[:n_r, 0] > 0]).all()),
              f"bounds extent {what}: no NaN centre")
        checks["bounds"] += 1

    # timing: the XZ2 path's shape (box leg, four extent columns, the two
    # box slots of the point kernels' timing), all slots real
    names, flags = EXT, dict(has_boxes=True, has_windows=False, extent=True)
    c3 = tuple(cols[k] for k in names)
    tcols = dict(zip(names, c3))
    kw = dict(col_names=names, **flags)
    bids, _ = bk.pad_bids(np.arange(m), n_blocks)
    pargs = (tcols, dev(bids, torch.int32), dev(boxes1, torch.float32), dev(wins1, torch.int32))
    rows = m * sub * 128
    col_bytes = rows * 4 * len(names)
    wide_ops = rows * leg_ops(boxes1, wins1, True, False, planes=1)
    out = {}
    _, launch = bk.scan_launcher(tcols, bids, boxes1, wins1, **flags)
    out["block_scan"] = {
        "ms": event_ms(launch),
        "wrapper_ms": event_ms(lambda: bk.block_scan(c3, bids, boxes1, wins1, **kw)),
        "plain_ms": event_ms(lambda: bk.block_scan_plain(*pargs, **flags)),
        # per row the wide plane's legs, a shift and an OR to pack; one plane out
        **bound(col_bytes + rows // 8 + bids.nbytes, wide_ops + rows * 2),
    }
    _, p_launch = agg.pops_launcher(tcols, bids, boxes1, wins1, **flags)
    out["block_pops"] = {
        "ms": event_ms(p_launch),
        "wrapper_ms": event_ms(lambda: agg.block_pops(c3, bids, boxes1, wins1, **kw)),
        "plain_ms": event_ms(lambda: agg.block_pops_plain(*pargs, **flags)),
        **bound(col_bytes + m * 4 + bids.nbytes, wide_ops + rows * 2 + rows // 16),
    }
    # the library yardstick of K3: one bincount over the hits' pixels
    g = {k: v[pargs[1].to(torch.int64)] for k, v in tcols.items()}
    wm, _ = bk.masks_plain(g, pargs[2], pargs[3], True, False, extent=True)
    wide_hits = int(wm.sum())
    xs = (g["gxmin"][wm] + g["gxmax"][wm]) * 0.5
    ys = (g["gymin"][wm] + g["gymax"][wm]) * 0.5
    del g, wm
    x0, y0, x1, y1 = (float(v) for v in gb)
    inside = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
    xs, ys = xs[inside], ys[inside]
    px = ((xs - x0) / (x1 - x0) * 256).to(torch.int32).clamp(0, 255)
    py = ((ys - y0) / (y1 - y0) * 256).to(torch.int32).clamp(0, 255)
    flat = py.to(torch.int64) * 256 + px.to(torch.int64)
    del xs, ys, px, py, inside
    # per wide hit the centre (2 adds, 2 multiplies) and the closed
    # envelope (4 compares, 4 ANDs); per hit in it the pixel (15, as K3's
    # point leg) and one increment
    density_ops = wide_ops + wide_hits * 12 + flat.numel() * 15
    _, d_launch = agg.density_launcher(tcols, bids, boxes1, wins1, gb, width=256, height=256,
                                       **flags)
    out["density"] = {
        "ms": event_ms(d_launch),
        "wrapper_ms": event_ms(lambda: agg.block_density(
            c3, bids, boxes1, wins1, gb, width=256, height=256, **kw)),
        "plain_ms": event_ms(lambda: agg.density_plain(
            *pargs, dev(gb, torch.float32), width=256, height=256, **flags)),
        **bound(col_bytes + 256 * 256 * 4 + bids.nbytes, density_ops),
        "library_ms": event_ms(lambda: torch.bincount(flat, minlength=256 * 256)),
        "hits": int(flat.numel()),
    }
    del flat
    _, b_launch = agg.bounds_launcher(tcols, bids, boxes1, wins1, **flags)
    out["bounds"] = {
        "ms": event_ms(b_launch),
        "wrapper_ms": event_ms(lambda: agg.block_bounds(c3, bids, boxes1, wins1, **kw)),
        "plain_ms": event_ms(lambda: agg.bounds_plain(*pargs, **flags)),
        # per wide hit the centre, a count and four min/max
        **bound(col_bytes + m * 8 * 4 + bids.nbytes, wide_ops + wide_hits * 9),
    }
    m2 = K2_SLOTS
    bids2 = np.sort(rng.choice(n_blocks, size=m2, replace=False)).astype(np.int32)
    qids = rng.permutation(np.arange(m2) % n_q).astype(np.int32)
    rows2 = m2 * sub * 128
    per_query = np.array([leg_ops(qboxes[q], qwins[q], True, False, planes=1) + 2
                          for q in range(len(qboxes))])
    _, launch = bk.multi_launcher(tcols, bids2, qids, qboxes, qwins, **flags)
    pargs2 = (tcols, dev(bids2, torch.int32), dev(qids, torch.int32),
              dev(qboxes, torch.float32), dev(qwins, torch.int32))
    out["block_scan_multi"] = {
        "ms": event_ms(launch),
        "wrapper_ms": event_ms(lambda: bk.block_scan_multi(
            c3, bids2, qids, qboxes, qwins, **kw)),
        "plain_ms": event_ms(lambda: bk.block_scan_multi_plain(*pargs2, **flags)),
        **bound(rows2 * 4 * len(names) + rows2 // 8
                + bk.stage_multi_params(bids2, qids, qboxes, qwins).nbytes,
                sub * 128 * int(per_query[qids].sum())),
    }
    for name, rec in out.items():
        rec.setdefault("library_ms", None)
        rec["max_abs_err"] = err[name]
        rec["equal_to_plain"] = err[name] == 0.0
        rec["checks"] = checks[name]
        rec["shape"] = (f"M={m2 if name == 'block_scan_multi' else m} SUB={sub} "
                        f"cols={','.join(names)}"
                        + (f" Q=128 ({n_q} real)" if name == "block_scan_multi" else "")
                        + (" grid=256x256" if name == "density" else ""))
    del cols, c3, tcols, pargs, pargs2
    torch.cuda.empty_cache()
    return out


# -- phase 4: the main path --------------------------------------------------


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


def run_queries(ds, queries, type_name="gdelt"):
    lat, outs = [], []
    t_all = time.perf_counter()
    for q, *_ in queries:
        s = time.perf_counter()
        outs.append(ds.query(type_name, q))
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

    def plain(cols3, bids, boxes, wins, *, col_names, has_boxes, has_windows, extent=False,
              **_):
        dv = cols3[0].device
        return agg.block_pops_plain(
            dict(zip(col_names, cols3)), torch.from_numpy(np.asarray(bids, np.int32)).to(dv),
            torch.from_numpy(boxes).to(dv), torch.from_numpy(wins).to(dv),
            has_boxes=has_boxes, has_windows=has_windows, extent=extent,
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


# -- extent paths ----------------------------------------------------------


def footprints(n, rng, cities):
    """Building-footprint rectangles of 20-200 m clustered around the
    cities, drawn as the reference benchmark's configuration 3 draws them
    (bench.py:308-384): (x0, y0, x1, y1) f64."""
    cx, cy = cities
    which = rng.integers(0, len(cx), n)
    x0 = np.clip(cx[which] + rng.normal(0, 0.5, n), -179.9, 179.8)
    y0 = np.clip(cy[which] + rng.normal(0, 0.4, n), -89.9, 89.8)
    del which
    return x0, y0, x0 + rng.uniform(0.0002, 0.002, n), y0 + rng.uniform(0.0002, 0.002, n)


def extent_store(torch, device, type_name, spec, index, columns, n):
    """A DataStore with one extent schema on ``index`` and n features
    written; returns (store, ingest seconds)."""
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType

    sft = FeatureType.from_spec(type_name, spec)
    sft.user_data["geomesa.indices.enabled"] = index
    ds = DataStore(device=device)
    ds.create_schema(sft)
    fc = FeatureCollection.from_columns(sft, np.arange(n), columns)
    t_in = time.perf_counter()
    ds.write(type_name, fc, check_ids=False)
    torch.cuda.synchronize()
    return ds, time.perf_counter() - t_in


def rect_wkt(x0, y0, x1, y1) -> str:
    return (f"POLYGON(({x0:.4f} {y0:.4f}, {x1:.4f} {y0:.4f}, {x1:.4f} {y1:.4f}, "
            f"{x0:.4f} {y1:.4f}, {x0:.4f} {y0:.4f}))")


def parsed_box(x0, y0, x1, y1) -> tuple:
    """The box as the printed 4-decimal filter parses."""
    return tuple(float(f"{v:.4f}") for v in (x0, y0, x1, y1))


def rect_queries(seed, n, cities):
    """[(ecql, box as parsed)] for n INTERSECTS rectangle queries drawn as
    the reference benchmark's configuration 3 draws them (widths
    0.02-2 degrees near a city)."""
    cx, cy = cities
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        c = r.integers(0, len(cx))
        qw = float(r.choice([0.02, 0.05, 0.1, 0.5, 2.0]))
        qx = cx[c] + r.uniform(-1, 1)
        qy = cy[c] + r.uniform(-0.8, 0.8)
        out.append((f"INTERSECTS(geom, {rect_wkt(qx, qy, qx + qw, qy + qw)})",
                    parsed_box(qx, qy, qx + qw, qy + qw)))
    return out


def brute_rect_ids(boxes, q) -> np.ndarray:
    """Rectangles meeting the closed query box: box algebra in f64."""
    x0, y0, x1, y1 = boxes
    return np.flatnonzero((x0 <= q[2]) & (x1 >= q[0]) & (y0 <= q[3]) & (y1 >= q[1]))


def check_table_aggregations(torch, ds, type_name, index, queries) -> int:
    """IndexTable.count, density (256 x 256 over the query box) and
    bounds_stats on the extent table against the count arithmetic over
    the plain popcount and the plain density and bounds over the same
    device table and candidate blocks."""
    from geomesa_tpu_torch.scan import aggregations as agg

    table = ds.table(type_name, index)
    n = 0
    for q, box in queries:
        cfg = ds.planner.plan(type_name, q).config
        env = box[:4]
        count = table.count(cfg)
        grid = table.density(cfg, env, 256, 256)
        stats = table.bounds_stats(cfg)
        with plain_pops(torch):
            check(count == table.count(cfg), f"extent count vs plain: {q[:60]}")
        cols3, bids, n_real, boxes, wins, kw = table.agg_launch_args(cfg)
        check(kw["extent"], "extent aggregations take the extent leg")
        dv = table.device
        targs = (dict(zip(kw["col_names"], cols3)), torch.from_numpy(bids).to(dv),
                 torch.from_numpy(boxes).to(dv), torch.from_numpy(wins).to(dv))
        flags = dict(has_boxes=kw["has_boxes"], has_windows=kw["has_windows"], extent=True)
        ref = agg.density_plain(*targs, torch.tensor(env, dtype=torch.float32, device=dv),
                                width=256, height=256, **flags).cpu().numpy()
        check(np.array_equal(grid, ref) and float(grid.sum()) > 0,
              f"extent density vs plain: {q[:60]}")
        st = agg.bounds_plain(*targs, **flags).cpu().numpy()
        check(stats == agg.reduce_bounds(st, n_real) and stats[0] >= count > 0,
              f"extent bounds vs plain: {q[:60]}")
        n += 1
    return n


def xz2_path(torch, device) -> dict:
    """The reference benchmark's configuration 3 on an XZ2 table (cut from
    200M to N_XZ2 footprints): INTERSECTS rectangle queries untraced, then
    traced, query_many, the scheduler under 8 threads, the table-level
    aggregations, and ids against an f64 brute force."""
    from concurrent.futures import ThreadPoolExecutor

    from geomesa_tpu_torch import geometry as geo
    from geomesa_tpu_torch.timing import NULL_CLOCK, PhaseClock

    zero_launches()
    t_gen = time.perf_counter()
    rng = np.random.default_rng(SEED + 20)
    cities = (rng.uniform(-160, 160, 256), rng.uniform(-55, 65, 256))
    src = footprints(N_XZ2, rng, cities)
    col = geo.PackedGeometryColumn.from_boxes(*src)
    gen_s = time.perf_counter() - t_gen
    ds, ingest_s = extent_store(torch, device, "bld", "*geom:Polygon:srid=4326", "xz2",
                                {"geom": col}, N_XZ2)
    del col
    table = ds.table("bld", "xz2")
    check(table.extent and table.col_names == EXT, "the xz2 table holds the extent columns")
    warm = rect_queries(SEED + 21, N_XZ_WARMUP, cities)
    measured = rect_queries(SEED + 22, N_XZ2_MEASURED, cities)
    filters = [q for q, _ in measured]
    run_queries(ds, warm, "bld")
    lat, outs, wall = run_queries(ds, measured, "bld")
    ds.clock = clock = PhaseClock()
    _, _, traced_wall = run_queries(ds, measured, "bld")
    phases = {k: v / len(measured) * 1e3 for k, v in clock.settle().items()}
    ds.clock = NULL_CLOCK
    device_ms = sum(phases.get(k, 0.0) for k in ("h2d", "kernel", "d2h"))
    cand_blocks = []
    for q in filters:
        plan = ds.planner.plan("bld", q)
        check(plan.index == "xz2" and not plan.config.geom_precise,
              f"extent query plans to the xz2 scan: {q[:60]}")
        cand_blocks.append(len(table.candidate_blocks(table.candidate_spans_split(plan.config)[0])))

    with chunk_recorder() as members:
        t0 = time.perf_counter()
        many = ds.query_many("bld", filters)
        many_s = time.perf_counter() - t0
    sched = ds.serve()
    try:
        def client(k):
            futs = [sched.submit("bld", q) for q in filters[k * 5:(k + 1) * 5]]
            return [f.result(600) for f in futs]

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            served = [o for outs_k in ex.map(client, range(8)) for o in outs_k]
        serve_s = time.perf_counter() - t0
    finally:
        sched.close()
    t0 = time.perf_counter()
    n_agg = check_table_aggregations(torch, ds, "bld", "xz2", busiest(measured, outs, 4))
    agg_s = time.perf_counter() - t0
    counts = [ds.count("bld", q) for q in filters[:8]]
    launches, leg_launches = read_launches(), read_leg_launches()

    for k, ((q, box), out) in enumerate(zip(measured[:8], outs)):
        ids = brute_rect_ids(src, box)
        got = np.sort(np.asarray(out.ids, np.int64))
        check(np.array_equal(got, ids), f"xz2 ids vs brute force: {q[:60]}")
        check(counts[k] == len(ids), f"xz2 count vs brute force: {q[:60]}")
    check_same_ids(many, outs, "xz2 query_many vs sequential query")
    check_same_ids(served, outs, "xz2 scheduler vs sequential query")
    hits = sum(len(o) for o in outs)
    rec = {
        "phase": "extent_path_xz2", "cell": "osm-xz2-50M", "launches": launches,
        "leg_launches": leg_launches, "n_features": N_XZ2, "index": "xz2",
        "generate_s": gen_s, "ingest_s": ingest_s, "ingest_rows_per_s": N_XZ2 / ingest_s,
        "device_gb": table.nbytes_device / 1e9, "n_blocks": table.n_blocks,
        "n_queries": len(measured), "hits_total": hits,
        "candidate_blocks_mean": float(np.mean(cand_blocks)),
        "candidate_blocks_max": int(np.max(cand_blocks)),
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
        "aggregations_s": agg_s,
        "checked_vs_brute_force": 8, "checked_query_many": len(many),
        "checked_scheduler": len(served), "checked_aggregations": n_agg,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    del ds, src, outs, many, served, table
    torch.cuda.empty_cache()
    return rec


def mixed_geometries(n, rng, cities):
    """n non-rectangle features near the cities: triangles, 5-arm stars,
    LineStrings of 2-6 vertices and, every 500th, a two-part MultiPolygon;
    20-2000 m across, one in 200 up to 0.5 degrees. Returns (port
    geometries, their parts for the brute force: (rings, polygonal) per
    feature, f64 bboxes [n, 4])."""
    from geomesa_tpu_torch import geometry as geo

    cx, cy = cities
    which = rng.integers(0, len(cx), n)
    px = np.clip(cx[which] + rng.normal(0, 0.5, n), -179, 179)
    py = np.clip(cy[which] + rng.normal(0, 0.4, n), -89, 89)
    size = rng.uniform(0.0002, 0.02, n) * np.where(rng.random(n) < 0.005, 25, 1)
    geoms, parts = [], []
    for i in range(n):
        x, y, r = px[i], py[i], size[i]
        if i % 500 == 499:
            stars = [star(x, y, r, 5, rng), star(x + 3 * r, y, r, 5, rng)]
            geoms.append(geo.MultiPolygon(stars))
            parts.append(([p.shell for p in stars], True))
        elif i % 3 == 0:
            ring = np.array([[x, y], [x + r, y], [x, y + r], [x, y]])
            geoms.append(geo.Polygon(ring))
            parts.append(([ring], True))
        elif i % 3 == 1:
            geoms.append(star(x, y, r, 5, rng))
            parts.append(([geoms[-1].shell], True))
        else:
            nv = int(rng.integers(2, 7))
            line = np.stack([x + np.cumsum(rng.normal(0, r, nv)),
                             y + np.cumsum(rng.normal(0, r, nv))], axis=1)
            geoms.append(geo.LineString(line))
            parts.append(([line], False))
    bounds = np.array([g.bounds() for g in geoms], np.float64)
    return geoms, parts, bounds


def xz3_queries(seed, n, cities, during_only: bool):
    """[(ecql, kind, query ring as parsed | None, (lo_ms, hi_ms))]: per 8
    queries 4 INTERSECTS rectangles (0.02-2 degrees), 2 INTERSECTS 5-arm
    stars (0.05-0.5 degrees), a BBOX and, with ``during_only``, a DURING
    alone (6 h or 24 h; else another rectangle); each spatial one AND dtg
    DURING 6 h - 14 d, all near a city."""
    from geomesa_tpu_torch import geometry as geo

    cx, cy = cities
    r = np.random.default_rng(seed)
    wins = time_windows(r, n, T0_MS, SPAN_MS)
    out = []
    for k in range(n):
        lo, hi = wins[k]
        c = r.integers(0, len(cx))
        qx, qy = cx[c] + r.uniform(-1, 1), cy[c] + r.uniform(-0.8, 0.8)
        kind = ("rect", "rect", "rect", "rect", "star", "star", "bbox",
                "during" if during_only else "rect")[k % 8]
        if kind == "during":
            hi = lo + int(r.choice([6, 24])) * 3_600_000
        during = f"dtg DURING {np.datetime64(lo, 'ms')}Z/{np.datetime64(hi, 'ms')}Z"
        if kind == "star":
            g = geo.from_wkt(geo.to_wkt(star(qx, qy, r.uniform(0.05, 0.5), 5, r)))
            ring = g.shell
            q = f"INTERSECTS(geom, {geo.to_wkt(g)}) AND {during}"
        elif kind == "during":
            ring, q = None, during
        else:
            qw = float(r.choice([0.02, 0.05, 0.1, 0.5, 2.0]))
            b = parsed_box(qx, qy, qx + qw, qy + qw)
            ring = np.array([[b[0], b[1]], [b[2], b[1]], [b[2], b[3]], [b[0], b[3]], [b[0], b[1]]])
            spatial = (f"INTERSECTS(geom, {rect_wkt(qx, qy, qx + qw, qy + qw)})" if kind == "rect"
                       else f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})")
            q = f"{spatial} AND {during}"
        out.append((q, kind, ring, (lo, hi)))
    return out


# an independent f64 intersects for the brute force: a vertex of one
# inside the other (even-odd), or two edges that cross or touch


def _orient(ax, ay, bx, by, cx, cy):
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)


def _on_segment(ax, ay, bx, by, px, py, o):
    return ((o == 0) & (np.minimum(ax, bx) <= px) & (px <= np.maximum(ax, bx))
            & (np.minimum(ay, by) <= py) & (py <= np.maximum(ay, by)))


def segments_meet(p1, p2, q1, q2) -> np.ndarray:
    """Whether segments p1-p2 and q1-q2 share a point ([..., 2] arrays,
    broadcast)."""
    a, b, c, d = (np.asarray(v, np.float64) for v in (p1, p2, q1, q2))
    d1 = _orient(c[..., 0], c[..., 1], d[..., 0], d[..., 1], a[..., 0], a[..., 1])
    d2 = _orient(c[..., 0], c[..., 1], d[..., 0], d[..., 1], b[..., 0], b[..., 1])
    d3 = _orient(a[..., 0], a[..., 1], b[..., 0], b[..., 1], c[..., 0], c[..., 1])
    d4 = _orient(a[..., 0], a[..., 1], b[..., 0], b[..., 1], d[..., 0], d[..., 1])
    proper = (((d1 > 0) & (d2 < 0)) | ((d1 < 0) & (d2 > 0))) & \
        (((d3 > 0) & (d4 < 0)) | ((d3 < 0) & (d4 > 0)))
    return (proper
            | _on_segment(c[..., 0], c[..., 1], d[..., 0], d[..., 1], a[..., 0], a[..., 1], d1)
            | _on_segment(c[..., 0], c[..., 1], d[..., 0], d[..., 1], b[..., 0], b[..., 1], d2)
            | _on_segment(a[..., 0], a[..., 1], b[..., 0], b[..., 1], c[..., 0], c[..., 1], d3)
            | _on_segment(a[..., 0], a[..., 1], b[..., 0], b[..., 1], d[..., 0], d[..., 1], d4))


def inside_rings(px, py, rings) -> np.ndarray:
    """Even-odd: points strictly inside the region the closed rings bound."""
    inside = np.zeros(np.shape(px), bool)
    for ring in rings:
        for (x0, y0), (x1, y1) in zip(ring[:-1], ring[1:]):
            if y0 == y1:
                continue
            cross = (y0 > py) != (y1 > py)
            xc = x0 + (py - y0) * (x1 - x0) / (y1 - y0)
            inside ^= cross & (px < xc)
    return inside


def feature_meets(rings, polygonal, qring) -> bool:
    """One feature (its rings, or its line) against the query ring."""
    verts = np.concatenate(rings)
    if inside_rings(verts[:, 0], verts[:, 1], [qring]).any():
        return True
    if polygonal and inside_rings(qring[:, 0], qring[:, 1], rings).any():
        return True
    q1, q2 = qring[:-1], qring[1:]
    for line in rings:
        if segments_meet(line[:-1, None], line[1:, None], q1[None], q2[None]).any():
            return True
    return False


def rects_meet_ring(boxes, qring) -> np.ndarray:
    """Rectangles [n, 4] against a query ring, vectorized over the
    rectangles."""
    x0, y0, x1, y1 = (boxes[:, k] for k in range(4))
    corners = np.stack([np.stack([x0, y0], 1), np.stack([x1, y0], 1),
                        np.stack([x1, y1], 1), np.stack([x0, y1], 1)], axis=1)  # [n, 4, 2]
    hit = inside_rings(corners[..., 0], corners[..., 1], [qring]).any(axis=1)
    qx, qy = qring[None, :, 0], qring[None, :, 1]
    hit |= ((qx > x0[:, None]) & (qx < x1[:, None]) & (qy > y0[:, None])
            & (qy < y1[:, None])).any(axis=1)
    nxt = np.roll(corners, -1, axis=1)
    hit |= segments_meet(corners[:, :, None], nxt[:, :, None], qring[None, None, :-1],
                         qring[None, None, 1:]).any(axis=(1, 2))
    return hit


def brute_xz3_ids(src, query) -> np.ndarray:
    """f64 brute force of one XZ3 query: the window, then rectangles by box
    algebra (rectangle queries) or the general test (stars), other
    features by the general test."""
    rect_boxes, parts, other_bounds, t = src
    _, kind, qring, (lo, hi) = query
    tm = (t >= lo) & (t < hi)
    n_rect = len(rect_boxes[0])
    if qring is None:
        return np.flatnonzero(tm)
    qb = (qring[:, 0].min(), qring[:, 1].min(), qring[:, 0].max(), qring[:, 1].max())
    rect_ids = brute_rect_ids(rect_boxes, qb)
    rect_ids = rect_ids[tm[rect_ids]]
    if kind == "star":
        boxes = np.stack([b[rect_ids] for b in rect_boxes], axis=1)
        rect_ids = rect_ids[rects_meet_ring(boxes, qring)]
    ob = other_bounds
    cand = np.flatnonzero((ob[:, 0] <= qb[2]) & (ob[:, 2] >= qb[0]) & (ob[:, 1] <= qb[3])
                          & (ob[:, 3] >= qb[1]) & tm[n_rect:])
    other_ids = [n_rect + j for j in cand if feature_meets(*parts[j], qring)]
    return np.concatenate([rect_ids, np.array(other_ids, np.int64)])


def xz3_path(torch, device) -> dict:
    """An XZ3 table of N_XZ3 extent features with dates over 120 days:
    building-footprint rectangles and 1 % triangles, stars, LineStrings and
    MultiPolygons. INTERSECTS (rectangles, stars) and BBOX queries AND
    DURING, and DURING alone, untraced then traced, then query_many; ids
    against an f64 brute force."""
    from geomesa_tpu_torch import geometry as geo
    from geomesa_tpu_torch.timing import NULL_CLOCK, PhaseClock

    zero_launches()
    t_gen = time.perf_counter()
    rng = np.random.default_rng(SEED + 50)
    cities = (rng.uniform(-160, 160, 256), rng.uniform(-55, 65, 256))
    n_rect = N_XZ3 - N_XZ3_OTHER
    rects = footprints(n_rect, rng, cities)
    geoms, parts, other_bounds = mixed_geometries(N_XZ3_OTHER, rng, cities)
    t = T0_MS + rng.integers(0, SPAN_MS, N_XZ3)
    col = geo.PackedGeometryColumn.concat([geo.PackedGeometryColumn.from_boxes(*rects),
                                           geo.PackedGeometryColumn.from_geometries(geoms)])
    del geoms
    gen_s = time.perf_counter() - t_gen
    ds, ingest_s = extent_store(torch, device, "ext", "dtg:Date,*geom:Geometry:srid=4326",
                                "xz3", {"geom": col, "dtg": t}, N_XZ3)
    del col
    table = ds.table("ext", "xz3")
    check(table.extent and table.col_names == tuple(sorted(EXT + ("tbin", "toff"))),
          "the xz3 table holds the extent and time columns")
    src = (rects, parts, other_bounds, t)
    warm = xz3_queries(SEED + 51, N_XZ_WARMUP, cities, during_only=False)
    measured = xz3_queries(SEED + 52, N_XZ3_MEASURED, cities, during_only=True)
    filters = [q for q, *_ in measured]
    run_queries(ds, warm, "ext")
    lat, outs, wall = run_queries(ds, measured, "ext")
    ds.clock = clock = PhaseClock()
    _, _, traced_wall = run_queries(ds, measured, "ext")
    phases = {k: v / len(measured) * 1e3 for k, v in clock.settle().items()}
    ds.clock = NULL_CLOCK
    device_ms = sum(phases.get(k, 0.0) for k in ("h2d", "kernel", "d2h"))
    cand_blocks = []
    for q in filters:
        plan = ds.planner.plan("ext", q)
        check(plan.index == "xz3", f"extent query plans to the xz3 scan: {q[:60]}")
        cand_blocks.append(len(table.candidate_blocks(table.candidate_spans_split(plan.config)[0])))
    with chunk_recorder() as members:
        t0 = time.perf_counter()
        many = ds.query_many("ext", filters)
        many_s = time.perf_counter() - t0
    launches, leg_launches = read_launches(), read_leg_launches()

    # the checked queries: the first of each kind, then the next ones
    kinds = [m[1] for m in measured]
    checked = sorted({kinds.index(k) for k in set(kinds)} | set(range(8)))[:8]
    t0 = time.perf_counter()
    for k in checked:
        ids = np.sort(brute_xz3_ids(src, measured[k]))
        got = np.sort(np.asarray(outs[k].ids, np.int64))
        check(np.array_equal(got, ids), f"xz3 ids vs brute force ({kinds[k]}): {filters[k][:60]}")
    brute_s = time.perf_counter() - t0
    check_same_ids(many, outs, "xz3 query_many vs sequential query")
    hits = sum(len(o) for o in outs)
    rec = {
        "phase": "extent_path_xz3", "cell": "xz3-10M-mixed", "launches": launches,
        "leg_launches": leg_launches, "n_features": N_XZ3, "n_non_rectangles": N_XZ3_OTHER,
        "index": "xz3", "generate_s": gen_s, "ingest_s": ingest_s,
        "ingest_rows_per_s": N_XZ3 / ingest_s, "device_gb": table.nbytes_device / 1e9,
        "n_blocks": table.n_blocks, "n_queries": len(measured), "hits_total": hits,
        "query_kinds": {kd: kinds.count(kd) for kd in sorted(set(kinds))},
        "candidate_blocks_mean": float(np.mean(cand_blocks)),
        "candidate_blocks_max": int(np.max(cand_blocks)),
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
        "checked_vs_brute_force": len(checked),
        "checked_kinds": sorted({kinds[k] for k in checked}), "brute_force_s": brute_s,
        "checked_query_many": len(many),
    }
    del ds, src, outs, many, table
    torch.cuda.empty_cache()
    return rec


def main_path(torch, device):
    """Seven paths, each with its own launch counts (zeroed just before it
    runs, read just after): the single-query main path, the batch path
    and the polygon path on the same store, the packed-time cell, the Z2
    polygon cell, and the two extent cells (XZ2, XZ3)."""
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
    return rec, batch, poly, packed, z2, xz2_path(torch, device), xz3_path(torch, device)


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
    from geomesa_tpu_torch.kernels import KERNELS, PROBE_KERNELS, build_all

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = nvidia_smi()
    build_s = build_all((*KERNELS, *PROBE_KERNELS))  # every source at once
    emit({"phase": "device", "nvidia_smi": smi, "torch_device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda, "build_s": build_s})

    timings = kernel_phase(torch, device)
    emit({"phase": "kernels_vs_plain", **{k: v for k, v in timings.items()}})

    probes, probe_kernels = probe_phase(torch, device)
    emit(probes)

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
        "osm-xz2-50M": tuple(k.name for k in KERNELS),
        "xz3-10M-mixed": ("block_scan", "block_scan_multi"),
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
        # the extent leg: every kernel on the XZ2 cell, the scans on XZ3
        "osm-xz2-50M": {k.name: ("extent",) for k in KERNELS},
        "xz3-10M-mixed": {"block_scan": ("extent",), "block_scan_multi": ("extent",)},
    }
    for cell, kernels in expected_legs.items():
        for name, legs in kernels.items():
            counts = leg_paths[cell][name]
            for leg in legs:
                check(counts[leg] > 0, f"{name} leg {leg} launched on the {cell} path")
            check(sum(counts.values()) > 0, f"{name} legs launched on the {cell} path")

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
    kernels += probe_kernels
    emit({"kernels": kernels, "wall_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    # the run drives one card, cuda:0
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
