"""Two-process probe of the pod tier's distributed driver.

The port's counterpart of scripts/probe_multiprocess.py: two processes
join one torch.distributed world over the gloo backend, each builds a
mesh store of 4 virtual CPU shards (``make_mesh(devices=["cpu"] * 4)``)
over its own half of a seeded point set, computes a density grid through
the mesh table (K3's plain version on every shard, the shards' grids
summed), and an ``all_reduce`` over gloo sums the two grids across the
process boundary, over TCP on loopback. Each process then holds the sum
against a one-device store over both halves, word for word.

Usage: python geomesa_tpu_torch/scripts/probe_multiprocess.py          (runs the probe)
       python geomesa_tpu_torch/scripts/probe_multiprocess.py --json   (one verdict line)

``--json`` is the capability probe of pod.hostgroup: it always exits 0
and prints one JSON line ``{"supported": ..., "verdict": "supported" |
"UNSUPPORTED" | "error", "reason": ...}``. The launcher holds the
rendezvous store itself on a port the system picks (port 0), so probes
run side by side never collide, bounds both workers by one deadline and
kills any worker left when it returns.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORLD = 2
SHARDS = 4
N_ROWS = 6_000  # each process's half
WIDTH, HEIGHT = 32, 16
ENVELOPE = (-60.0, -45.0, 60.0, 45.0)
QUERY = "bbox(geom, -50, -40, 50, 40)"
DEADLINE_S = 90.0
UNSUPPORTED_RC = 3


def _rows(rank: int):
    rng = np.random.default_rng(1000 + rank)
    t0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
    return (rng.uniform(-60, 60, N_ROWS), rng.uniform(-45, 45, N_ROWS),
            t0 + rng.integers(0, 10 * 86_400_000, N_ROWS))


def _density(ranks, mesh=None):
    """The density grid of the given ranks' rows, on a CPU store (sharded
    over ``mesh`` when given)."""
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType

    sft = FeatureType.from_spec("p", "dtg:Date,*geom:Point:srid=4326")
    ds = DataStore(device="cpu", tile=4096, mesh=mesh)
    ds.create_schema(sft)
    for r in ranks:
        x, y, t = _rows(r)
        ids = np.arange(N_ROWS, dtype=np.int64) + r * N_ROWS
        ds.write("p", FeatureCollection.from_columns(sft, ids, {"dtg": t, "geom": (x, y)}))
    ds.compact("p")
    grid = ds.density("p", QUERY, envelope=ENVELOPE, width=WIDTH, height=HEIGHT)
    ds.close()
    return np.asarray(grid, np.float32)


def worker(rank: int, port: int) -> None:
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_gloo_available()):
        print("UNSUPPORTED: this torch build has no gloo backend", flush=True)
        sys.exit(UNSUPPORTED_RC)
    sys.path.insert(0, ROOT)
    from geomesa_tpu_torch.parallel import make_mesh

    store = dist.TCPStore("127.0.0.1", port, WORLD, False, timeout=timedelta(seconds=60))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=60))
    try:
        grid = torch.from_numpy(_density([rank], make_mesh(devices=["cpu"] * SHARDS)))
        dist.all_reduce(grid)  # the sum crosses the process boundary
        want = _density(range(WORLD))
        if not np.array_equal(grid.numpy(), want) or want.sum() <= 0:
            raise SystemExit(f"rank {rank}: all-reduced grid differs from the one-store grid")
        if rank == 0:
            print(f"PASS: cross-process density sum = {float(want.sum())}", flush=True)
    finally:
        dist.destroy_process_group()


def _launch_workers() -> list:
    """Start the two workers on a rendezvous store this process holds;
    return their exit codes (1 for a worker past the deadline)."""
    from datetime import timedelta

    import torch.distributed as dist

    if not (dist.is_available() and dist.is_gloo_available()):
        return [UNSUPPORTED_RC] * WORLD
    master = dist.TCPStore("127.0.0.1", 0, None, True, timeout=timedelta(seconds=60),
                           wait_for_workers=False)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(master.port)],
                         env=env)
        for r in range(WORLD)
    ]
    try:
        deadline = time.monotonic() + DEADLINE_S
        rcs = [p.wait(timeout=max(deadline - time.monotonic(), 1)) for p in procs]
    except subprocess.TimeoutExpired:
        rcs = [1] * WORLD
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        del master
    return rcs


def probe() -> dict:
    """Run the workers and distill their exit codes into the verdict
    (never raises): ``supported`` when the cross-process sum checked out,
    ``UNSUPPORTED`` when the backend has no gloo, ``error`` otherwise."""
    try:
        rcs = _launch_workers()
    except Exception as e:  # the launcher itself failed: report, never raise
        return {"supported": False, "verdict": "error",
                "reason": f"probe launcher failed: {e}", "worker_rcs": None}
    if not any(rcs):
        return {"supported": True, "verdict": "supported",
                "reason": "two-process gloo all_reduce of mesh density grids OK",
                "worker_rcs": rcs}
    if UNSUPPORTED_RC in rcs:
        return {"supported": False, "verdict": "UNSUPPORTED",
                "reason": "no gloo backend in this torch build", "worker_rcs": rcs}
    return {"supported": False, "verdict": "error",
            "reason": f"probe workers failed (rcs={rcs})", "worker_rcs": rcs}


def main() -> None:
    if sys.argv[1:2] == ["--json"]:
        import json

        print(json.dumps(probe()), flush=True)
        return
    if len(sys.argv) > 2:
        worker(int(sys.argv[1]), int(sys.argv[2]))
        return
    v = probe()
    print(f"two-process distributed probe: {v['verdict']} ({v['reason']})", flush=True)
    if not v["supported"]:
        raise SystemExit(UNSUPPORTED_RC if v["verdict"] == "UNSUPPORTED" else 1)


if __name__ == "__main__":
    main()
