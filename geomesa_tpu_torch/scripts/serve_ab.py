"""Serving throughput of one tree, for a parent-against-change comparison
on one card.

Run from the root of a checkout (it imports that checkout's
``chip_smoke``), with the side's name:

    python -m geomesa_tpu_torch.scripts.serve_ab change

or, for a tree without this file (the parent), by path from the
current repository:

    (cd checkout/parent && python ../../geomesa_tpu_torch/scripts/serve_ab.py parent)

A comparison runs two unpacked trees in turns in one call (parent,
change, change, parent), each from its own root, since two calls may
land on cards with other hosts. Each run builds the kernels and the
native helpers, writes a 10M-row GDELT-shaped Z3 store with
``EventRootCode`` (no cache), runs the 64 main queries once to warm,
then five passes of: the 64 queries sequentially, one ``query_many``
of them, and ``serve()`` under 8 client threads of 8 queries each (a
fresh scheduler a pass, closed after it); it prints one JSON line of
queries per second per pass. Tracing is disarmed as in
``chip_smoke.main``. Raises without a card.
"""

from __future__ import annotations

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

N_ROWS = 10_000_000
N_PASSES = 5
N_CLIENTS = 8


def main(side: str) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("serve_ab needs a CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from geomesa_tpu_torch import conf, native
    from geomesa_tpu_torch.kernels import KERNELS, build_all

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build_all(KERNELS)
    native.library()
    conf.OBS_TRACE_SAMPLE.set(0)
    conf.OBS_SLOW_MS.set(0)
    ds, _, ingest_s = cs.build_store(torch, dev, N_ROWS, with_root_code=True)
    measured = cs.query_set(cs.SEED + 2, cs.N_MEASURED)
    filters = [q for q, _ in measured]
    per = len(filters) // N_CLIENTS
    cs.run_queries(ds, measured)
    out = {"side": side, "tree": os.getcwd(), "smi": cs.nvidia_smi(), "ingest_s": ingest_s,
           "seq": [], "many": [], "serve": []}
    for _ in range(N_PASSES):
        _, _, wall = cs.run_queries(ds, measured)
        out["seq"].append(len(filters) / wall)
        t0 = time.perf_counter()
        ds.query_many("gdelt", filters)
        out["many"].append(len(filters) / (time.perf_counter() - t0))
        sched = ds.serve()

        def client(k):
            futs = [sched.submit("gdelt", q) for q in filters[k * per:(k + 1) * per]]
            return [f.result(600) for f in futs]

        t0 = time.perf_counter()
        with ThreadPoolExecutor(N_CLIENTS) as ex:
            served = [o for outs in ex.map(client, range(N_CLIENTS)) for o in outs]
        out["serve"].append(len(served) / (time.perf_counter() - t0))
        sched.close()
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1] if len(sys.argv) > 1 else "change")), flush=True)
