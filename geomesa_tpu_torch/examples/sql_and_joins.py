"""SQL front-end, indexed spatial join, polygon queries and CRS: the
analytics surface in one script.

The port of the reference's examples/sql_and_joins.py: the same seed,
sizes, calls and prints. Run on the card, or on the CPU with ``--device
cpu``:

    python -m geomesa_tpu_torch.examples.sql_and_joins [--device cpu]

``main(device, record)`` returns the SQL rows; a ``record`` dict also
receives the join pairs and the reprojected query's ids and x column.
"""

import numpy as np


def main(device="cuda", record=None):
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType
    from geomesa_tpu_torch import geometry as geo
    from geomesa_tpu_torch.planning.hints import QueryHints
    from geomesa_tpu_torch.sql import spatial_join_indexed, sql_query

    rng = np.random.default_rng(7)
    n = 200_000
    sft = FeatureType.from_spec(
        "ships", "name:String:index=true,*geom:Point:srid=4326"
    )
    sft.user_data["geomesa.indices.enabled"] = "z2"
    ds = DataStore(device=device)
    ds.create_schema(sft)
    ds.write("ships", FeatureCollection.from_columns(
        sft, np.arange(n),
        {"name": np.array([f"v{i % 500:03d}" for i in range(n)]),
         "geom": (rng.uniform(-90, 90, n), rng.uniform(-45, 45, n))},
    ), check_ids=False)

    # 1. SQL with ST_ predicate push-down: the polygon INTERSECTS rides
    #    the z2 index and the scan kernel's point-in-polygon leg
    rows = sql_query(ds, (
        "SELECT name, st_x(geom) AS lon, st_y(geom) AS lat FROM ships "
        "WHERE st_intersects(geom, st_geomfromwkt("
        "'POLYGON((-20 -15, 25 -20, 30 12, 0 18, -25 8, -20 -15))')) "
        "ORDER BY lon LIMIT 25"
    ))
    print(f"SQL polygon query: {len(rows)} rows, cols {list(rows.columns)}")

    # 2. indexed spatial join: admin cells x the ship store, every left
    #    geometry's scan fused into one launch
    cx = rng.uniform(-80, 70, 32)
    cy = rng.uniform(-40, 30, 32)
    cells = geo.PackedGeometryColumn.from_boxes(cx, cy, cx + 8, cy + 6)
    adm = FeatureCollection.from_columns(
        FeatureType.from_spec("adm", "*geom:Polygon:srid=4326"),
        np.arange(32), {"geom": cells},
    )
    li, ri = spatial_join_indexed(ds, "ships", adm, "contains")
    per_cell = np.bincount(li, minlength=32)
    print(f"join: {len(li)} pairs; busiest cell holds {per_cell.max()} ships")

    # 3. reproject results to web mercator for a mapping client
    merc = ds.query(
        "ships", "bbox(geom, -10, -10, 10, 10)",
        hints=QueryHints(reproject="EPSG:3857"),
    )
    print(f"mercator rows: {len(merc)}, "
          f"x range ±{float(np.abs(merc.geom_column.x).max()):.0f} m")
    if record is not None:
        record.update(pairs=(np.asarray(li), np.asarray(ri)), merc_ids=np.asarray(merc.ids),
                      merc_x=np.asarray(merc.geom_column.x))
    return rows


if __name__ == "__main__":
    from geomesa_tpu_torch.examples import cli_device

    main(cli_device())
