"""Profile configuration 4's indexed spatial join by phase, on the card.

The port of the JAX package's scripts/profile_join.py. It builds the
reference benchmark's configuration-4 store: N GDELT-shaped points
(half uniform, half around 64 centres; seed 42 + 30) on Z2 only, and
P rectangle polygons of 1-12 x 1-8 degrees (the reference's N = 20M,
P = 256). After one warm ``spatial_join_indexed(..., "contains")`` it
replays the join's loop with a clock on each phase, three times:

- ``scan_config_ms``: each polygon's BBOX through the Z2 index's
  ``scan_config`` (host z-ranges);
- ``submit_ms``: ``IndexTable.scan_submit`` of each (candidate blocks,
  the params' copy and K1's launch);
- ``pull_decode_ms``: each scan's finish (the planes' pull and decode);
- ``refine_ms``: the f64 test of the uncertain rows (strictly inside);
- ``concat_ms``: the (polygon, point) pairs put together in polygon
  order.

Then ``spatial_join_indexed`` itself twice (one ``scan_submit_many`` for
every polygon: K2). The loop's pairs must equal the join's, and both
must equal a numpy f64 brute force (strict interior) for every polygon
up to 5M points, for 16 polygons beyond; a mismatch raises. Times are
host wall clock around calls that return host arrays; off the card they
are CPU times of the plain versions, not device figures. Run on the
card:

    python -m geomesa_tpu_torch.scripts.profile_join [--rows N] [--polygons P] [--device cuda]

It prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

N_REFERENCE = 20_000_000
N_POLY_REFERENCE = 256
SEED = 42
N_SAMPLE = 16  # polygons checked by the brute force past FULL_CHECK_ROWS
FULL_CHECK_ROWS = 5_000_000
TRIALS = 3


def gdelt_points(n, rng):
    """Half uniform, half around 64 centres (the reference's draw)."""
    n_clustered = n // 2
    n_uniform = n - n_clustered
    cx = rng.uniform(-160, 160, 64)
    cy = rng.uniform(-55, 65, 64)
    which = rng.integers(0, 64, n_clustered)
    x = np.concatenate([rng.uniform(-180, 180, n_uniform),
                        np.clip(cx[which] + rng.normal(0, 3.0, n_clustered), -180, 180)])
    y = np.concatenate([rng.uniform(-90, 90, n_uniform),
                        np.clip(cy[which] + rng.normal(0, 2.0, n_clustered), -90, 90)])
    return x, y


def make_inputs(n: int, n_poly: int):
    """(x, y, (px0, py0, px1, py1)): the points and the polygons' boxes."""
    rng = np.random.default_rng(SEED + 30)
    x, y = gdelt_points(n, rng)
    px0 = rng.uniform(-170, 150, n_poly)
    py0 = rng.uniform(-80, 60, n_poly)
    pw = rng.uniform(1, 12, n_poly)
    ph = rng.uniform(1, 8, n_poly)
    return x, y, (px0, py0, px0 + pw, py0 + ph)


def brute_pairs(x, y, boxes, polys) -> tuple:
    """(left, right) of the points strictly inside each listed box."""
    li, ri = [], []
    for k in polys:
        x0, y0, x1, y1 = (b[k] for b in boxes)
        r = np.flatnonzero((x > x0) & (x < x1) & (y > y0) & (y < y1))
        li.append(np.full(len(r), k, np.int64))
        ri.append(r.astype(np.int64))
    return np.concatenate(li), np.concatenate(ri)


def phase_loop(ds, poly_fc) -> tuple:
    """One instrumented pass of the join's loop: (phase ms, left, right)."""
    from geomesa_tpu_torch.filter.predicates import BBox

    idx = next(i for i in ds.indexes("pts") if i.name == "z2")
    table = ds.table("pts", "z2")
    pts = ds.features("pts").geom_column
    lgeoms = poly_fc.geometries()
    t0 = time.perf_counter()
    t_cfg = t_submit = 0.0
    finishes = []
    for g in lgeoms:
        a = time.perf_counter()
        cfg = idx.scan_config(BBox("geom", *g.bounds()))
        b = time.perf_counter()
        t_cfg += b - a
        finishes.append(table.scan_submit(cfg) if cfg and not cfg.disjoint else None)
        t_submit += time.perf_counter() - b
    t_pull = t_refine = 0.0
    n_unc = 0
    per_left = []
    for k, fin in enumerate(finishes):
        if fin is None:
            continue
        a = time.perf_counter()
        ordinals, certain = fin()
        b = time.perf_counter()
        t_pull += b - a
        unc = np.flatnonzero(~certain)
        n_unc += len(unc)
        if len(unc):
            x0, y0, x1, y1 = lgeoms[k].bounds()
            ux, uy = pts.x[ordinals[unc]], pts.y[ordinals[unc]]
            keep = certain.copy()
            keep[unc] = (ux > x0) & (ux < x1) & (uy > y0) & (uy < y1)
            ordinals = ordinals[keep]
        per_left.append((k, np.sort(np.asarray(ordinals, np.int64))))
        t_refine += time.perf_counter() - b
    a = time.perf_counter()
    li = np.concatenate([np.full(len(o), k, np.int64) for k, o in per_left] or [np.zeros(0,
                                                                               np.int64)])
    ri = np.concatenate([o for _, o in per_left] or [np.zeros(0, np.int64)])
    t_concat = time.perf_counter() - a
    total = time.perf_counter() - t0
    ms = {"total_ms": total * 1e3, "scan_config_ms": t_cfg * 1e3, "submit_ms": t_submit * 1e3,
          "pull_decode_ms": t_pull * 1e3, "refine_ms": t_refine * 1e3,
          "concat_ms": t_concat * 1e3, "pairs": len(li), "uncertain": n_unc}
    return ms, li, ri


def run(n: int = N_REFERENCE, n_poly: int = N_POLY_REFERENCE, device="cuda") -> dict:
    """Build, warm, the three instrumented passes, the join twice and
    the checks; returns the record."""
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType
    from geomesa_tpu_torch import geometry as geo
    from geomesa_tpu_torch.datastore import resolve_device
    from geomesa_tpu_torch.sql.join import spatial_join_indexed

    device = resolve_device(device)
    cuda = device.type == "cuda"
    x, y, boxes = make_inputs(n, n_poly)
    polys = geo.PackedGeometryColumn.from_boxes(*boxes)
    psft = FeatureType.from_spec("pts", "*geom:Point:srid=4326")
    psft.user_data["geomesa.indices.enabled"] = "z2"
    gsft = FeatureType.from_spec("adm", "*geom:Polygon:srid=4326")
    poly_fc = FeatureCollection.from_columns(gsft, np.arange(n_poly), {"geom": polys})
    ds = DataStore(device=device)
    ds.create_schema(psft)
    t = time.perf_counter()
    ds.write("pts", FeatureCollection.from_columns(psft, np.arange(n), {"geom": (x, y)}),
             check_ids=False)
    if cuda:
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    spatial_join_indexed(ds, "pts", poly_fc, "contains")  # warm-up

    trials = []
    for _ in range(TRIALS):
        ms, li, ri = phase_loop(ds, poly_fc)
        trials.append(ms)
    joins_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        jl, jr = spatial_join_indexed(ds, "pts", poly_fc, "contains")
        joins_ms.append((time.perf_counter() - t0) * 1e3)
    assert np.array_equal(li, jl) and np.array_equal(ri, jr), "the phase loop's pairs != the join's"
    k = n_poly if n <= FULL_CHECK_ROWS else N_SAMPLE
    sample = np.arange(min(k, n_poly))
    bl, br = brute_pairs(x, y, boxes, sample)
    sel = np.isin(jl, sample)
    assert np.array_equal(jl[sel], bl) and np.array_equal(jr[sel], br), "join vs brute force"
    ds.close()
    return {
        "driver": "profile_join", "device": torch.cuda.get_device_name(device)
        if cuda else "cpu", "rows": n, "polygons": n_poly, "build_s": build_s,
        "trials": trials, "join_ms": joins_ms, "pairs": int(len(jl)),
        "checked_polygons": int(len(sample)),
        "reduced": ([] if n >= N_REFERENCE else [f"rows {n:,} of the reference's "
                                                 f"{N_REFERENCE:,}"])
        + ([] if n_poly >= N_POLY_REFERENCE else [f"polygons {n_poly} of the reference's "
                                                  f"{N_POLY_REFERENCE}"]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=N_REFERENCE, help="points (default 20M)")
    ap.add_argument("--polygons", type=int, default=N_POLY_REFERENCE, help="default 256")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        rec = run(args.rows, args.polygons, args.device)
    except AssertionError as e:
        print(f"profile_join: FAIL {e}", file=sys.stderr)
        return 1
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
