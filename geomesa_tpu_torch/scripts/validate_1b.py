"""The 1B-row validation of configuration 1, on the card.

The port of the JAX package's scripts/validate_1b.py. It builds the
config-1 store (GDELT-shaped points, ``dtg:Date,*geom:Point``) at N rows
on the Z3 index in the packed-time layout (``geomesa.z3.packed-time``:
12 B/row of device columns, x, y and the packed ``tw`` word) and checks
it end to end:

- the device bytes of the table, per row and in all, beside the card's
  memory (``torch.cuda.get_device_properties(0).total_memory``, where
  the reference prints the v5e's 16 GB);
- 12 BBOX + DURING queries, each count equal to a chunked numpy brute
  force in f64 (the reference's compares in f32: see :func:`f64_box`)
  and the brute force's first 50 ids among the answer;
- a 2M-row recent append through the delta tier: query 0 equal to the
  brute force over both the main rows and the appended ones; then
  ``compact``, after which query 0's count is unchanged.

A failed check is an ``AssertionError``: ``main`` exits 1 with its
reason. The brute force over the appended rows reads the appended
arrays as written (the reference reads them back through
``ds.features``, a copy of every column of the store, which at 10⁹ rows
is itself tens of GB of host memory); the comparison is the same, since
the store keeps the f32 coordinates and the ms times exactly.

Counterparts of the reference's TPU measurements: ``backend`` becomes
``device`` (the card's name); the record adds the peak host RSS
(``ru_maxrss``) and the card's peak allocated memory. Run on the card
(the reference's size is 10⁹ rows):

    python -m geomesa_tpu_torch.scripts.validate_1b [--rows N] [--device cuda]

It prints one JSON line; progress goes to stderr. ``--device cpu`` runs
the plain kernels on the CPU; without a card ``cuda`` raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from geomesa_tpu_torch.scripts.hostmem import (mem_total_bytes, peak_rss_bytes, rows_cut,
                                               rss_bytes)

N_REFERENCE = 1_000_000_000
N_APPEND = 2_000_000
DAY = 86_400_000
SEED = 7
GEN_CHUNK = 50_000_000
TRUTH_CHUNK = 100_000_000
SPEC = "dtg:Date,*geom:Point:srid=4326"


def log(msg: str) -> None:
    print(f"[1b] {msg}", file=sys.stderr, flush=True)


def gen_points(n, rng):
    """GDELT-shaped f32 points, generated chunk by chunk (no f64
    temporaries of the full N): half uniform, half around 64 centres."""
    x = np.empty(n, np.float32)
    y = np.empty(n, np.float32)
    cx = rng.uniform(-160, 160, 64)
    cy = rng.uniform(-55, 65, 64)
    for s in range(0, n, GEN_CHUNK):
        e = min(s + GEN_CHUNK, n)
        m = e - s
        half = m // 2
        x[s : s + half] = rng.uniform(-180, 180, half).astype(np.float32)
        y[s : s + half] = rng.uniform(-90, 90, half).astype(np.float32)
        which = rng.integers(0, 64, m - half)
        x[s + half : e] = np.clip(cx[which] + rng.normal(0, 3.0, m - half), -180, 180).astype(
            np.float32)
        y[s + half : e] = np.clip(cy[which] + rng.normal(0, 2.0, m - half), -90, 90).astype(
            np.float32)
        log(f"gen {e:,}/{n:,}")
    return x, y


def f64_box(q) -> tuple:
    """The query's box as numpy f64 scalars: compared with an f32 column
    they promote it, so a point is tested at its stored f32 value read
    exactly in f64, as the store's refinement tests it. (A Python float
    bound is weak under NumPy 2's promotion rules: the comparison then
    runs in f32 with the bound rounded to f32, and a point whose f32
    value is that rounded bound, just outside the f64 box, would count.
    That is the reference script's brute force; at 10^8 rows query 9 has
    such a point, y = float32(65.0537) against y1 = 65.0537.)"""
    return tuple(np.float64(v) for v in q[:4])


def truth_count_ids(x, y, t, q, sample_cap=50):
    """Chunked brute force of one query (x0, y0, x1, y1, lo, hi), in f64
    (:func:`f64_box`): its count and its first ``sample_cap`` ids (row
    ordinals)."""
    x0, y0, x1, y1 = f64_box(q)
    lo, hi = q[4], q[5]
    total = 0
    ids: list = []
    for s in range(0, len(x), TRUTH_CHUNK):
        e = min(s + TRUTH_CHUNK, len(x))
        m = ((x[s:e] >= x0) & (x[s:e] <= x1) & (y[s:e] >= y0) & (y[s:e] <= y1)
             & (t[s:e] >= lo) & (t[s:e] < hi))
        total += int(m.sum())
        if len(ids) < sample_cap:
            ids.extend((s + np.flatnonzero(m)[: sample_cap - len(ids)]).tolist())
    return total, ids


def make_queries(r, t0: int, span: int) -> list:
    """The 12 query tuples, rounded through the filter's 4-decimal
    formatting so the brute force tests the values the parser sees."""
    qs = []
    for _ in range(12):
        w = float(r.choice([1.0, 5.0, 20.0, 40.0]))
        qx = float(r.uniform(-175, 175 - w))
        qy = float(r.uniform(-85, 85 - w / 2))
        lo = int(t0 + r.integers(0, span - 7 * DAY))
        hi = lo + int(r.choice([1, 7, 21])) * DAY
        qs.append((float(f"{qx:.4f}"), float(f"{qy:.4f}"),
                   float(f"{qx + w:.4f}"), float(f"{qy + w / 2:.4f}"), lo, hi))
    return qs


def expr_of(q) -> str:
    return (f"bbox(geom, {q[0]:.4f}, {q[1]:.4f}, {q[2]:.4f}, {q[3]:.4f}) "
            f"AND dtg DURING {np.datetime64(q[4], 'ms')}Z/{np.datetime64(q[5], 'ms')}Z")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(n: int = N_REFERENCE, device="cuda") -> dict:
    """Build, query, append and compact at ``n`` rows on ``device``;
    returns the record (the reference's keys, the per-query counts, the
    host and device memory). Raises AssertionError on an inexact
    answer."""
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType
    from geomesa_tpu_torch.datastore import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        torch.zeros(1, device=device)  # the context, before the start's RSS
        torch.cuda.reset_peak_memory_stats()
    rss_start = rss_bytes()
    rng = np.random.default_rng(SEED)
    t_start = time.perf_counter()
    log(f"generating {n:,} points ...")
    x, y = gen_points(n, rng)
    t0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
    span = 120 * DAY
    t = t0 + rng.integers(0, span, n)
    gen_s = time.perf_counter() - t_start
    log(f"generated in {gen_s:.0f}s")

    sft = FeatureType.from_spec("gdelt", SPEC)
    sft.user_data["geomesa.indices.enabled"] = "z3"
    sft.user_data["geomesa.z3.packed-time"] = "true"
    ds = DataStore(device=device)
    ds.create_schema(sft)
    fc = FeatureCollection.from_columns(sft, np.arange(n), {"dtg": t, "geom": (x, y)})
    t_in = time.perf_counter()
    ds.write("gdelt", fc, check_ids=False)
    _sync(device)
    ingest_s = time.perf_counter() - t_in
    del fc
    table = ds.table("gdelt", "z3")
    tbl = getattr(table, "main", table)
    nbytes = int(tbl.nbytes_device)
    log(f"ingest {ingest_s:.0f}s ({n / ingest_s:,.0f} rows/s); device columns "
        f"{nbytes / 1e9:.2f} GB ({nbytes / n:.1f} B/row)")

    r = np.random.default_rng(SEED + 1)
    qs = make_queries(r, t0, span)
    lat, counts = [], []
    for i, q in enumerate(qs):
        s = time.perf_counter()
        out = ds.query("gdelt", expr_of(q))
        lat.append(time.perf_counter() - s)
        want_n, want_ids = truth_count_ids(x, y, t, q)
        got_ids = np.asarray(out.ids)
        assert len(out) == want_n, (expr_of(q), len(out), want_n)
        assert set(want_ids) <= set(got_ids[np.isin(got_ids, want_ids)].tolist()), expr_of(q)
        counts.append(len(out))
        log(f"query {i}: {len(out):,} hits in {lat[-1]:.2f}s — exact")

    # a recent-time append through the delta tier, then compaction
    at = t0 + span - np.abs(r.integers(0, 3 * DAY, N_APPEND))
    ax = r.uniform(-180, 180, N_APPEND).astype(np.float32)
    ay = r.uniform(-90, 90, N_APPEND).astype(np.float32)
    t_ap = time.perf_counter()
    ds.write("gdelt", FeatureCollection.from_columns(
        sft, np.arange(n, n + N_APPEND), {"dtg": at, "geom": (ax, ay)}), check_ids=False)
    _sync(device)
    append_s = time.perf_counter() - t_ap
    q = qs[0]
    n_after = len(ds.query("gdelt", expr_of(q)))
    log(f"append {N_APPEND:,} in {append_s:.1f}s; post-append query {n_after:,} hits")
    want0, _ = truth_count_ids(x, y, t, q)
    x0, y0, x1, y1 = f64_box(q)
    want_extra = int(((ax >= x0) & (ax <= x1) & (ay >= y0) & (ay <= y1)
                      & (at >= q[4]) & (at < q[5])).sum())
    assert n_after == want0 + want_extra, (n_after, want0, want_extra)
    t_c = time.perf_counter()
    ds.compact("gdelt")
    _sync(device)
    compact_s = time.perf_counter() - t_c
    n_compacted = len(ds.query("gdelt", expr_of(q)))
    assert n_compacted == n_after, (n_compacted, n_after)
    log(f"compaction {compact_s:.1f}s; post-compaction query exact")

    cuda = device.type == "cuda"
    return {
        "driver": "validate_1b",
        "n_rows": n,
        "device_bytes_per_row": round(nbytes / n, 2),
        "device_gb": round(nbytes / 1e9, 2),
        "device_memory_gb": (torch.cuda.get_device_properties(device).total_memory / 1e9
                             if cuda else None),
        "ingest_rows_per_s": round(n / ingest_s, 1),
        "queries_exact": len(counts),
        "query_p50_s": round(float(np.percentile(lat, 50)), 2),
        "append_2m_s": round(append_s, 1),
        "post_append_exact": True,
        "compact_s": round(compact_s, 1),
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        # beyond the reference's keys
        "query_counts": counts,
        "post_append_count": n_after,
        "latencies_s": lat,
        "generate_s": gen_s,
        "ingest_s": ingest_s,
        "device_bytes": nbytes,
        "peak_device_gb": torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None,
        "peak_host_rss_gb": peak_rss_bytes() / 1e9,
        "host_rss_start_gb": rss_start / 1e9,
        "host_mem_total_gb": mem_total_bytes() / 1e9,
        "wall_s": time.perf_counter() - t_start,
        "reduced": rows_cut(n, N_REFERENCE, rss_start),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=N_REFERENCE, help="N (default 1e9)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        rec = run(args.rows, args.device)
    except AssertionError as e:
        print(f"[1b] FAIL: inexact answer {e}", file=sys.stderr)
        return 1
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
