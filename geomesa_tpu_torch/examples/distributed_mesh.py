"""Distributed store over a device mesh: same API, sharded execution.

The port of the reference's examples/distributed_mesh.py: the same seed,
sizes, calls and prints. torch has no virtual device count, so the mesh
is 8 virtual shards of one device (``make_mesh(devices=[device] * 8)``;
``make_mesh(8)`` takes 8 visible cards and raises with fewer). Run on the
card, or on the CPU with ``--device cpu``:

    python -m geomesa_tpu_torch.examples.distributed_mesh [--device cpu]

``main(device, record)`` returns the batch's results; a ``record`` dict
also receives the first query's ids.
"""

import numpy as np

from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType
from geomesa_tpu_torch.parallel import make_mesh


def main(device="cuda", record=None):
    mesh = make_mesh(devices=[device] * 8)
    sft = FeatureType.from_spec("pts", "dtg:Date,*geom:Point:srid=4326")
    ds = DataStore(device=device, mesh=mesh)
    ds.create_schema(sft)

    n = 100_000
    rng = np.random.default_rng(1)
    t0 = np.datetime64("2024-06-01", "ms").astype(np.int64)
    ds.write("pts", FeatureCollection.from_columns(
        sft, np.arange(n),
        {
            "dtg": t0 + rng.integers(0, 10 * 86_400_000, n),
            "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)),
        },
    ), check_ids=False)

    # every query fans out over the mesh's shards and merges on the host
    out = ds.query("pts", "bbox(geom, -30, -30, 30, 30)")
    print(f"{len(out)} hits across {mesh.size} devices")

    # pipelined batch: every shard's scans are staged before any pull
    outs = ds.query_many("pts", [
        f"bbox(geom, {x0}, -20, {x0 + 30}, 20)" for x0 in range(-90, 90, 30)
    ])
    print("batched hit counts:", [len(o) for o in outs])
    if record is not None:
        record.update(ids=np.asarray(out.ids), batch_ids=[np.asarray(o.ids) for o in outs])
    return outs


if __name__ == "__main__":
    from geomesa_tpu_torch.examples import cli_device

    main(cli_device())
