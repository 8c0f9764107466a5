"""Batched query/density pipelines and the transactional update surface.

The port of the reference's examples/batch_and_update.py: the same seed,
sizes, calls and prints. Run on the card, or on the CPU with ``--device
cpu``:

    python -m geomesa_tpu_torch.examples.batch_and_update [--device cpu]

- ``query_many`` / ``density_many`` stage every request's device work
  before pulling any result (one fused launch for the batch's scans).
- ``upsert`` replaces features by id; ``modify_features`` rewrites
  attribute values with index keys re-derived, so geometry/time updates
  move rows to their new index cells.

``main(device, record)`` returns the batch's results; a ``record`` dict
also receives the tile grids, the moved count and the relocated ids.
"""

import numpy as np

from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType
from geomesa_tpu_torch import geometry as geo


def main(device="cuda", record=None):
    sft = FeatureType.from_spec(
        "fleet", "callsign:String,dtg:Date,*geom:Point:srid=4326"
    )
    ds = DataStore(device=device)
    ds.create_schema(sft)

    n = 100_000
    rng = np.random.default_rng(7)
    t0 = np.datetime64("2024-06-01", "ms").astype(np.int64)
    ds.write("fleet", FeatureCollection.from_columns(
        sft, np.arange(n).astype(str),
        {
            "callsign": np.array([f"V{i % 50}" for i in range(n)], dtype=object),
            "dtg": t0 + rng.integers(0, 7 * 86_400_000, n),
            "geom": (rng.uniform(-30, 30, n), rng.uniform(-20, 20, n)),
        },
    ))

    # a batch of region queries: one pipelined pull instead of four
    boxes = [(-30, -20, 0, 0), (0, 0, 30, 20), (-30, 0, 0, 20), (0, -20, 30, 0)]
    queries = [f"bbox(geom, {a}, {b}, {c}, {d})" for a, b, c, d in boxes]
    results = ds.query_many("fleet", queries)
    print("region hit counts:", [len(r) for r in results])

    # a 2x2 heatmap frame: every tile's grid launch is staged up front
    tiles = ds.density_many(
        "fleet", [(q, box) for q, box in zip(queries, boxes)],
        width=128, height=128,
    )
    print("tile masses:", [int(t.sum()) for t in tiles])

    # vessel V7 reports a corrected position: move every fix, then verify
    # the rows are found at the new location through the index
    moved = ds.modify_features(
        "fleet", {"geom": geo.Point(150.0, 45.0)}, "callsign = 'V7'"
    )
    relocated = ds.query("fleet", "bbox(geom, 149, 44, 151, 46)")
    print(f"moved {moved} fixes; index now finds {len(relocated)} at the new spot")

    # late-arriving corrected records replace their originals by id
    fix = FeatureCollection.from_columns(
        sft, ["0", "1"],
        {
            "callsign": np.array(["V0", "V0"], dtype=object),
            "dtg": np.array([t0, t0]),
            "geom": (np.array([10.0, 10.1]), np.array([5.0, 5.1])),
        },
    )
    ds.upsert("fleet", fix)
    assert ds.count("fleet") == n  # replaced, not appended
    if record is not None:
        record.update(ids=[np.asarray(r.ids) for r in results], tiles=tiles, moved=moved,
                      relocated=np.asarray(relocated.ids), count=ds.count("fleet"))
    return results


if __name__ == "__main__":
    from geomesa_tpu_torch.examples import cli_device

    main(cli_device())
