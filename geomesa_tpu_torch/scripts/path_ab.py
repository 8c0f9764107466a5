"""End-to-end paths of one tree, for a parent-against-change comparison
on one card.

Run from the root of a checkout (it imports that checkout's
``chip_smoke``), with the side's name:

    python -m geomesa_tpu_torch.scripts.path_ab parent
    python -m geomesa_tpu_torch.scripts.path_ab change

A comparison runs two unpacked trees in turns in one call (parent,
change, change, parent), each from its own root, since two calls may
land on cards with other hosts. Each run builds the kernels and the
native helpers, then times three paths of ``chip_smoke.py``: the 100M-row
Z3 main store (16 warm-up queries, then the 64 measured ones three
times, the p50 of each pass), ``xz3_path`` and ``tiered_union_path``
(their own checks included), and prints one JSON line. ``change`` sets
``geomesa.obs.trace.sample`` and ``geomesa.obs.slow.ms`` to 0, as
``chip_smoke.main`` does (a tree without those knobs traces nothing);
``change-armed`` keeps their defaults (the slow-query log on). Raises
without a card.
"""

from __future__ import annotations

import json
import os
import sys


def main(mode: str) -> dict:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("path_ab needs a CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    if mode == "change":
        from geomesa_tpu_torch import conf

        conf.OBS_TRACE_SAMPLE.set(0)
        conf.OBS_SLOW_MS.set(0)
    from geomesa_tpu_torch import native
    from geomesa_tpu_torch.kernels import KERNELS, build_all

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build_all(KERNELS)
    native.library()
    out = {"mode": mode, "tree": os.getcwd()}
    ds, src, ingest = cs.build_store(torch, dev, cs.N_MAIN)
    cs.run_queries(ds, cs.query_set(cs.SEED + 1, cs.N_WARMUP))
    measured = cs.query_set(cs.SEED + 2, cs.N_MEASURED)
    p50 = []
    for _ in range(3):
        lat, _, _ = cs.run_queries(ds, measured)
        p50.append(float(np.percentile(lat, 50) * 1e3))
    out["main_p50_ms"] = p50
    out["main_ingest_s"] = ingest
    del ds, src
    torch.cuda.empty_cache()
    x3 = cs.xz3_path(torch, dev)
    out["xz3"] = {k: x3[k] for k in ("latency_p50_ms", "phase_ms_per_query", "traced_ms_per_query")}
    torch.cuda.empty_cache()
    ti = cs.tiered_union_path(torch, dev)
    out["tiered"] = {k: ti.get(k) for k in ("latency_p50_ms_main_only", "latency_p50_ms_tiered",
                                            "latency_p50_ms_compacted", "union_latency_p50_ms",
                                            "phase_ms_per_query_tiered")}
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1])), flush=True)
