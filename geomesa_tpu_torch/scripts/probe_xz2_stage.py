"""Profile one XZ2 query's host side, stage by stage, on the card.

The port of the JAX package's scripts/probe_xz2_stage.py, on the
footprints of probe_xz2_50m (N rectangles, seed 62, 256 centres; the
reference's 50M). From the seed-2 query set it warms on the first 10
queries, then takes the widest one (the first 2-degree query) and:

- runs it once (``hits``), then once under the port's ``Explainer``
  (``total_ms`` and the rendered plan trace: range planning, candidate
  pruning, scan, decode, refinement, each span with its time);
- profiles three more runs with ``cProfile``: the 18 functions of most
  cumulative time (``profile``: calls, total and cumulative seconds,
  function) and the printed table (``profile_text``).

The query's ids must equal a numpy f64 brute force (a mismatch raises).
The stages are host time by nature (wall clock and the profiler's
clock); off the card they are CPU times of the plain versions, not
device figures. Run on the card:

    python -m geomesa_tpu_torch.scripts.probe_xz2_stage [--rows N] [--device cuda]

It prints one JSON line.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import sys
import time

import torch

from geomesa_tpu_torch.scripts.probe_xz2_50m import (N_QUERIES, N_REFERENCE, build_store,
                                                     check_ids, footprints, mk)

N_WARM = 10
N_PROFILED = 3
TOP = 18


def run(n: int = N_REFERENCE, device="cuda") -> dict:
    """The warm-up, the explained run and the profile; returns the
    record."""
    from geomesa_tpu_torch.datastore import resolve_device
    from geomesa_tpu_torch.planning.explain import Explainer

    device = resolve_device(device)
    centres, rects = footprints(n)
    ds, ingest_s = build_store(n, device, rects)
    qs = mk(centres, 2, N_QUERIES)
    for _, q, _ in qs[:N_WARM]:
        ds.query("bld", q)
    qw, q, box = max(qs, key=lambda t: t[0])
    res = ds.query("bld", q)
    check_ids(res, rects, box, "the widest query")
    e = Explainer()
    t0 = time.perf_counter()
    ds.query("bld", q, explain=e)
    total_ms = (time.perf_counter() - t0) * 1e3
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(N_PROFILED):
        ds.query("bld", q)
    pr.disable()
    text = io.StringIO()
    st = pstats.Stats(pr, stream=text)
    st.sort_stats("cumulative").print_stats(TOP)
    top = sorted(st.stats.items(), key=lambda kv: -kv[1][3])[:TOP]
    ds.close()
    cuda = device.type == "cuda"
    return {
        "driver": "probe_xz2_stage", "device": torch.cuda.get_device_name(device)
        if cuda else "cpu", "rows": n, "ingest_s": ingest_s, "query": q, "width": qw,
        "hits": len(res.ids), "checked_vs_brute_force": 1, "total_ms": total_ms,
        "explain": e.render().splitlines(),
        "profile": [{"function": f"{fn}:{line}({name})", "calls": nc, "tottime_s": tt,
                     "cumtime_s": ct} for (fn, line, name), (_, nc, tt, ct, _) in top],
        "profile_text": text.getvalue().splitlines(),
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
        print(f"probe_xz2_stage: FAIL {e}", file=sys.stderr)
        return 1
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
