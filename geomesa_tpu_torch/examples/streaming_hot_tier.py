"""Streaming hot tier + hot/cold lambda store (Kafka/Lambda analogue).

The port of the reference's examples/streaming_hot_tier.py: the same
seed, sizes, calls and prints. The cold store's tables live on
``device``. Run on the card, or on the CPU with ``--device cpu``:

    python -m geomesa_tpu_torch.examples.streaming_hot_tier [--device cpu]

``main(device, record)`` returns the lambda store's query after the
persist; a ``record`` dict also receives the live ids, the listener's
events, the flushed count and the merged ids.
"""

import numpy as np

from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType
from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.streaming import LambdaStore, StreamingFeatureCache


def main(device="cuda", record=None):
    sft = FeatureType.from_spec("ships", "mmsi:String,*geom:Point:srid=4326")

    # live keyed state: latest message per id wins, spatial queries served
    # from a bucket grid index
    cache = StreamingFeatureCache(sft)
    events = []
    cache.listeners.append(lambda ev, fid, row: events.append((ev, fid)))
    cache.upsert(
        [{"mmsi": "a", "geom": geo.Point(1.0, 1.0)},
         {"mmsi": "b", "geom": geo.Point(50.0, 10.0)}],
        ids=["a", "b"],
    )
    cache.upsert([{"mmsi": "a", "geom": geo.Point(2.0, 1.5)}], ids=["a"])
    live = cache.query("bbox(geom, 0, 0, 10, 10)")
    print(f"live hits: {len(live)}; events: {events}")

    # hot/cold: recent rows in the cache, history in the columnar store
    cold = DataStore(device=device)
    cold.create_schema(sft)
    store = LambdaStore(cold, "ships")
    rng = np.random.default_rng(2)
    n = 50_000
    store.write(FeatureCollection.from_columns(
        sft, np.arange(n),
        {
            "mmsi": np.array([f"m{i % 500}" for i in range(n)]),
            "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)),
        },
    ).to_rows())
    store.persist_hot()  # full persist: hot -> cold
    out = store.query("bbox(geom, -10, -10, 10, 10)")
    print(f"lambda-store hits: {len(out)}")

    # sustained ingest: micro-batch flush() publishes NEW ids O(batch);
    # updates hold in the exact hot overlay until the incremental fold.
    # With serve() attached, the cold half of every query admits through
    # the scheduler while ingest runs.
    store.serve()
    store.write(
        [{"mmsi": "m7", "geom": geo.Point(3.0, 3.0)},   # update of id "7"
         {"mmsi": "new", "geom": geo.Point(4.0, 4.0)}],  # arrival
        ids=["7", "live1"],
    )
    flushed = store.flush()      # publishes the arrival; update stays hot
    merged = store.query("bbox(geom, 0, 0, 10, 10)")
    print(f"micro-batch flushed {flushed}; merged hits: {len(merged)}")
    store.persist_hot()          # the fold drains the overlay
    store.close()
    if record is not None:
        record.update(live_ids=list(live.ids), events=list(events), ids=np.asarray(out.ids),
                      flushed=flushed, merged_ids=np.asarray(merged.ids))
    return out


if __name__ == "__main__":
    from geomesa_tpu_torch.examples import cli_device

    main(cli_device())
