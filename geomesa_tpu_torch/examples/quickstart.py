"""Quickstart: schema -> ingest -> query -> aggregate -> export.

The port of the reference's examples/quickstart.py: the same seed, sizes,
calls and prints. Run on the card, or on the CPU with ``--device cpu``:

    python -m geomesa_tpu_torch.examples.quickstart [--device cpu]

``main(device, record)`` returns the query's hits; a ``record`` dict also
receives the values the prints summarize (hit ids, the estimate, the
density grid, the plan and the CSV header).
"""

import numpy as np

from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType


def main(device="cuda", record=None):
    sft = FeatureType.from_spec(
        "events", "name:String:index=true,dtg:Date,*geom:Point:srid=4326"
    )
    ds = DataStore(device=device)
    ds.create_schema(sft)

    n = 200_000
    rng = np.random.default_rng(0)
    t0 = np.datetime64("2024-01-01", "ms").astype(np.int64)
    ds.write("events", FeatureCollection.from_columns(
        sft, np.arange(n).astype(str),
        {
            "name": np.array([f"n{i % 100}" for i in range(n)]),
            "dtg": t0 + rng.integers(0, 30 * 86_400_000, n),
            "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)),
        },
    ))

    q = ("bbox(geom, -20, -10, 40, 35) AND "
         "dtg DURING 2024-01-03T00:00:00Z/2024-01-20T00:00:00Z")
    hits = ds.query("events", q)
    estimate = ds.estimate_count("events", q)
    print(f"{len(hits)} hits; estimate was {estimate}")

    grid = ds.density("events", q, width=128, height=128)
    print(f"density grid sums to {grid.sum():.0f}")

    plan = ds.explain("events", "bbox(geom, 0, 0, 10, 10) OR name = 'n7'")
    print(plan)

    from geomesa_tpu_torch.io import export

    csv = export(hits.take(np.arange(min(3, len(hits)))), "csv")
    print(csv.splitlines()[0])
    if record is not None:
        record.update(ids=np.asarray(hits.ids), estimate=estimate, grid=grid,
                      explain=plan, csv_header=csv.splitlines()[0])
    return hits


if __name__ == "__main__":
    from geomesa_tpu_torch.examples import cli_device

    main(cli_device())
