"""Probe the XZ2 (extent) query path end to end, on the card.

The port of the JAX package's scripts/probe_xz2_50m.py. It builds an
extent store of N footprint rectangles (``*geom:Polygon`` on XZ2 only;
the reference's 50M) clustered around 256 centres, then times 40
INTERSECTS rectangle queries across selectivities (0.02 to 2 degrees
wide) after 40 warm-up queries: the wide-only plane rule and the XZ
candidate pruning under real skew. Per query it records the query's
wall clock, the candidate spans that overlap and that are contained
(and the contained rows), the candidate blocks, the padded bucket K1
runs over, the time of the span split, and the hits; the 12 slowest are
listed, with the mean, p50 and p99 over all 40.

Every checked answer must equal a numpy f64 brute force (rectangles
meeting the closed query box): all 40 up to 5M rows, 8 of them beyond; a
mismatch raises.

This module also holds what the three XZ2 probes share
(probe_xz2_pipeline, probe_xz2_stage): :func:`footprints`, the
footprints and their centres (seed 62), :func:`mk`, the query maker,
and :func:`build_store`. Times are host wall clock around calls that
return host arrays; off the card they are CPU times of the plain
versions, not device figures. The store is built inside :func:`run`
(the reference builds it at import). Run on the card:

    python -m geomesa_tpu_torch.scripts.probe_xz2_50m [--rows N] [--device cuda]

It prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

N_REFERENCE = 50_000_000
SEED = 62
N_CENTRES = 256
N_QUERIES = 40
N_SAMPLE = 8  # answers checked by the brute force past FULL_CHECK_ROWS
FULL_CHECK_ROWS = 5_000_000
WIDTHS = (0.02, 0.05, 0.1, 0.5, 2.0)
SPEC = "*geom:Polygon:srid=4326"


def footprints(n: int):
    """((cx, cy), (x0, y0, x1, y1)): 256 centres and n rectangles of
    0.0002-0.002 degrees around them, f64, in the reference's draw
    order."""
    rng = np.random.default_rng(SEED)
    cx = rng.uniform(-160, 160, N_CENTRES)
    cy = rng.uniform(-55, 65, N_CENTRES)
    which = rng.integers(0, N_CENTRES, n)
    x0 = np.clip(cx[which] + rng.normal(0, 0.5, n), -179.9, 179.8)
    y0 = np.clip(cy[which] + rng.normal(0, 0.4, n), -89.9, 89.8)
    del which
    w = rng.uniform(0.0002, 0.002, n)
    h = rng.uniform(0.0002, 0.002, n)
    return (cx, cy), (x0, y0, x0 + w, y0 + h)


def q_of(qw, qx, qy) -> str:
    return (f"INTERSECTS(geom, POLYGON(({qx:.4f} {qy:.4f}, {qx + qw:.4f} {qy:.4f}, "
            f"{qx + qw:.4f} {qy + qw:.4f}, {qx:.4f} {qy + qw:.4f}, {qx:.4f} {qy:.4f})))")


def mk(centres, seed: int, k: int) -> list:
    """k queries [(width, ecql, box as the filter parses it)], drawn as
    the reference draws them: a centre, a width, an offset."""
    cx, cy = centres
    r = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        c = r.integers(0, N_CENTRES)
        qw = float(r.choice(WIDTHS))
        qx = cx[c] + r.uniform(-1, 1)
        qy = cy[c] + r.uniform(-0.8, 0.8)
        box = tuple(float(f"{v:.4f}") for v in (qx, qy, qx + qw, qy + qw))
        out.append((qw, q_of(qw, qx, qy), box))
    return out


def brute_ids(rects, box) -> np.ndarray:
    """Ordinals of the rectangles meeting the closed box, in f64."""
    x0, y0, x1, y1 = rects
    return np.flatnonzero((x0 <= box[2]) & (x1 >= box[0]) & (y0 <= box[3]) & (y1 >= box[1]))


def check_ids(res, rects, box, what: str) -> None:
    got = np.sort(np.asarray(res.ids, np.int64))
    want = brute_ids(rects, box)
    assert np.array_equal(got, want), (what, len(got), len(want))


def n_checked(n: int) -> int:
    """How many of the 40 answers the brute force checks at n rows."""
    return N_QUERIES if n <= FULL_CHECK_ROWS else N_SAMPLE


def build_store(n: int, device, rects=None):
    """(store, ingest seconds) of n footprints on XZ2; ``rects`` from
    :func:`footprints` when given."""
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType
    from geomesa_tpu_torch import geometry as geo

    if rects is None:
        _, rects = footprints(n)
    col = geo.PackedGeometryColumn.from_boxes(*rects)
    sft = FeatureType.from_spec("bld", SPEC)
    sft.user_data["geomesa.indices.enabled"] = "xz2"
    ds = DataStore(device=device)
    ds.create_schema(sft)
    fc = FeatureCollection.from_columns(sft, np.arange(n), {"geom": col})
    t = time.perf_counter()
    ds.write("bld", fc, check_ids=False)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return ds, time.perf_counter() - t


def run(n: int = N_REFERENCE, device="cuda") -> dict:
    """Build, warm, time the 40 queries, check; returns the record."""
    from geomesa_tpu_torch.datastore import resolve_device
    from geomesa_tpu_torch.filter import ecql
    from geomesa_tpu_torch.scan import block_kernels as bk

    device = resolve_device(device)
    centres, rects = footprints(n)
    ds, ingest_s = build_store(n, device, rects)
    table = ds.table("bld", "xz2")
    idx = ds.indexes("bld")[0]
    t = time.perf_counter()
    for _, q, _ in mk(centres, 1, N_QUERIES):
        ds.query("bld", q)
    warm_s = time.perf_counter() - t

    rows, results = [], []
    for qw, q, box in mk(centres, 2, N_QUERIES):
        cfg = idx.scan_config(ecql.parse(q))
        t0 = time.perf_counter()
        overlap, contained = table.candidate_spans_split(cfg)
        t_spans = time.perf_counter() - t0
        blocks = table.candidate_blocks(overlap)
        bids, _ = bk.pad_bids(table._full_or(blocks), table.n_blocks)
        t1 = time.perf_counter()
        res = ds.query("bld", q)
        t_q = time.perf_counter() - t1
        rows.append({"q_ms": t_q * 1e3, "qw": qw, "overlap": len(overlap),
                     "contained": len(contained),
                     "contained_rows": int(sum(z - a for a, z in contained)),
                     "blocks": len(blocks), "bucket": len(bids), "spans_ms": t_spans * 1e3,
                     "hits": len(res.ids)})
        results.append((res, box))
    k = n_checked(n)
    for i, (res, box) in enumerate(results[:k]):
        check_ids(res, rects, box, f"query {i}")
    lat = sorted(r["q_ms"] for r in rows)
    ds.close()
    cuda = device.type == "cuda"
    return {
        "driver": "probe_xz2_50m", "device": torch.cuda.get_device_name(device)
        if cuda else "cpu", "rows": n, "n_blocks": table.n_blocks, "ingest_s": ingest_s,
        "warmup_s": warm_s, "slowest": sorted(rows, key=lambda r: -r["q_ms"])[:12],
        "mean_ms": float(np.mean(lat)), "p50_ms": lat[len(lat) // 2], "p99_ms": lat[-1],
        "hits": int(sum(r["hits"] for r in rows)), "query_hits": [r["hits"] for r in rows],
        "checked_vs_brute_force": k,
        "reduced": [] if n >= N_REFERENCE else [f"rows {n:,} of the reference's "
                                                f"{N_REFERENCE:,}"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=N_REFERENCE, help="footprints (default 50M)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        rec = run(args.rows, args.device)
    except AssertionError as e:
        print(f"probe_xz2_50m: FAIL {e}", file=sys.stderr)
        return 1
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
