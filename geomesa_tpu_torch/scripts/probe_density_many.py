"""Probe repeated density push-downs over one Z2 point store, on the card.

The port of the JAX package's scripts/probe_density_many.py: the steady
cost of many heatmap requests on one table (the kernel warm after its
first launch, a dispatch and a pull each). It builds a store of N
uniform points (``dtg:Date,*geom:Point``, seed 3; the reference's 50M)
and renders one WMS heatmap frame of 8 x 4 world tiles, 45 degrees each
(``bbox`` filter and envelope), 256 x 256 pixels a tile:

- ``sequential_s``: 32 ``DataStore.density`` calls, one after another;
- ``many_s``: one ``DataStore.density_many`` of the 32 (K3 for each
  tile, every launch queued before the first pull).

``density_many`` warms on the first 4 tiles first, as the reference
does. Every grid of the two passes must be equal, and the frame's total
must be within 200 of N (loose f32 tile edges may count a boundary point
twice); a failed check raises. Build and pass times are host wall clock
(``time.perf_counter`` around calls that return host arrays); off the
card they are CPU times of the plain versions, not device figures. The
store is built inside :func:`run` (the reference builds it at import).
Run on the card:

    python -m geomesa_tpu_torch.scripts.probe_density_many [--rows N] [--device cuda]

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
SEED = 3
SPEC = "dtg:Date,*geom:Point:srid=4326"


def make_points(n: int):
    """(dtg ms, x, y) of the reference's store, in its draw order."""
    rng = np.random.default_rng(SEED)
    t0 = np.datetime64("2024-01-01", "ms").astype(np.int64)
    return (t0 + rng.integers(0, 10**9, n), rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))


def frame_requests() -> list:
    """[(filter, envelope)] of the 8 x 4 frame, column-major as the
    reference lists them."""
    reqs = []
    for i in range(8):
        for j in range(4):
            x0, y0 = -180 + i * 45, -90 + j * 45
            reqs.append((f"bbox(geom, {x0}, {y0}, {x0 + 45}, {y0 + 45})",
                         (x0, y0, x0 + 45, y0 + 45)))
    return reqs


def build_store(n: int, device):
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType

    t, x, y = make_points(n)
    sft = FeatureType.from_spec("d", SPEC)
    ds = DataStore(device=device)
    ds.create_schema(sft)
    ds.write("d", FeatureCollection.from_columns(sft, np.arange(n), {"dtg": t, "geom": (x, y)}),
             check_ids=False)
    return ds


def run(n: int = N_REFERENCE, device="cuda") -> dict:
    """Build, warm, time both passes, check; returns the record (with
    the grids' sums per tile)."""
    from geomesa_tpu_torch.datastore import resolve_device

    device = resolve_device(device)
    cuda = device.type == "cuda"
    t_b = time.perf_counter()
    ds = build_store(n, device)
    if cuda:
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t_b
    reqs = frame_requests()
    ds.density_many("d", reqs[:4])  # the first launches, off the clock
    t = time.perf_counter()
    seq = [ds.density("d", f, envelope=e) for f, e in reqs]
    t_seq = time.perf_counter() - t
    t = time.perf_counter()
    many = ds.density_many("d", reqs)
    t_many = time.perf_counter() - t
    grids_equal = all(np.array_equal(a, b) for a, b in zip(seq, many))
    total = sum(float(g.sum()) for g in many)
    assert grids_equal, "density_many differs from sequential density"
    assert abs(total - n) < 200, total
    ds.close()
    return {
        "driver": "probe_density_many", "device": torch.cuda.get_device_name(device)
        if cuda else "cpu", "rows": n, "tiles": len(reqs), "pixels": list(seq[0].shape),
        "build_s": build_s, "sequential_s": t_seq, "many_s": t_many,
        "speedup": t_seq / t_many, "grids_equal": grids_equal, "total": total,
        "tile_sums": [int(g.sum()) for g in many],
        "reduced": [] if n >= N_REFERENCE else [f"rows {n:,} of the reference's "
                                                f"{N_REFERENCE:,}"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=N_REFERENCE, help="points (default 50M)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        rec = run(args.rows, args.device)
    except AssertionError as e:
        print(f"probe_density_many: FAIL {e}", file=sys.stderr)
        return 1
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
