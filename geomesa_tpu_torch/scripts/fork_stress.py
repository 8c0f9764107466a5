"""The forked parse pool's failure path, many times over.

    python -m geomesa_tpu_torch.scripts.fork_stress [--iterations N]
        [--splits S] [--workers W]

Writes S seeded CSV files to a temporary directory, then runs
``ingest_files(workers=W)`` N times into a fresh CPU store with a crash
armed at ``ingest.split.read``: every load must raise ``IngestError``
for split 0 and publish nothing. Each failure drains the pool before it
raises (``ingest.splits.feed_in_split_order``), so the pool's ``with``
block never terminates a worker in the middle of writing a result, which
can hang CPython's ``Pool.terminate``. torch's intra-op threads are
started first, so the pool forks from a process with threads as it does
under the tests and on the card. A hang shows as a run that never
prints; run it under ``timeout``. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def main(argv=None) -> dict:
    import numpy as np
    import torch

    from geomesa_tpu_torch import DataStore, FeatureType, fault, ingest
    from geomesa_tpu_torch.io.converters import Converter, FieldSpec

    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=2000)
    ap.add_argument("--splits", type=int, default=16)
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)
    torch.ones(1 << 20).sum()  # the intra-op thread pool is up before any fork
    sft = FeatureType.from_spec("p", "name:String,val:Double,dtg:Date,*geom:Point:srid=4326")
    conv = Converter(sft=sft, skip_lines=1, id_field="$1", fields=[
        FieldSpec("name", "$1"), FieldSpec("val", "$2::double"),
        FieldSpec("geom", "point($3, $4)"), FieldSpec("dtg", "datetime($5)")])
    rng = np.random.default_rng(7)
    with tempfile.TemporaryDirectory(prefix="geomesa_fork_stress_") as root:
        paths = []
        for i in range(args.splits):
            p = os.path.join(root, f"f{i}.csv")
            with open(p, "w") as fh:
                fh.write("name,val,lon,lat,when\n")
                fh.writelines(f"r{i}_{j},{rng.uniform():.4f},{rng.uniform(-60, 60):.4f},"
                              f"{rng.uniform(-45, 45):.4f},2024-02-01T00:00:00Z\n"
                              for j in range(300))
            paths.append(p)
        t0 = time.perf_counter()
        for _ in range(args.iterations):
            ds = DataStore(device="cpu")
            ds.create_schema(sft)
            with fault.inject("ingest.split.read", kind="crash"):
                try:
                    ingest.ingest_files(ds, conv, paths, workers=args.workers)
                except ingest.IngestError as e:
                    if e.split_index != 0 or ds.row_count("p"):
                        raise RuntimeError("the failed load published rows") from e
                else:
                    raise RuntimeError("the armed crash did not abort the load")
    return {"iterations": args.iterations, "splits": args.splits, "workers": args.workers,
            "seconds": time.perf_counter() - t0, "host_cpus": os.cpu_count()}


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
