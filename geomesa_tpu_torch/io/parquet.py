"""Parquet feature IO — the geomesa-fs storage-format analogue.

Reference: ParquetFileSystemStorage (geomesa-fs/
geomesa-fs-storage/geomesa-fs-storage-parquet/src/main/scala/org/
locationtech/geomesa/fs/storage/parquet/ParquetFileSystemStorage.scala,
SimpleFeatureParquetSchema.scala) — the reference's CPU baseline stores
features as Parquet files with an SFT-derived schema. Here the columnar
FeatureCollection maps straight onto Arrow arrays (io/arrow) and writes
through pyarrow.parquet; the SFT spec rides in the file metadata so a
read can reconstruct the schema without a catalog.

Predicate push-down (the reference's FilterConverter tier) comes from
pyarrow's own row-group filtering: ``read_parquet(..., bbox=...)`` turns
a bbox into column statistics filters on the point coordinate columns.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.sft import FeatureType

_SFT_KEY = b"geomesa.sft.spec"
_NAME_KEY = b"geomesa.sft.name"


def write_parquet(
    fc: FeatureCollection, path, compression: str = "zstd", row_group_rows: int = 1 << 20
) -> None:
    """Write a collection to one Parquet file. Point geometries become
    plain ``<geom>_x`` / ``<geom>_y`` double columns (so Parquet
    column statistics support bbox push-down); extent geometries a WKB
    binary column."""
    import pyarrow.parquet as pq

    from geomesa_tpu_torch.io.arrow import flat_point_table

    table = flat_point_table(fc, dictionary=True)
    meta = dict(table.schema.metadata or {})
    meta[_SFT_KEY] = fc.sft.to_spec().encode()
    meta[_NAME_KEY] = fc.sft.name.encode()
    table = table.replace_schema_metadata(meta)
    pq.write_table(
        table, path, compression=compression, row_group_size=row_group_rows
    )


def read_parquet(
    path,
    sft: "FeatureType | None" = None,
    bbox: "tuple[float, float, float, float] | None" = None,
) -> FeatureCollection:
    """Read a Parquet file written by :func:`write_parquet` back into a
    FeatureCollection. ``bbox`` pushes a coordinate-range filter into the
    Parquet reader (row-group statistics pruning + row filtering) for
    point schemas — the FilterConverter push-down analogue."""
    import pyarrow.parquet as pq

    schema = pq.read_schema(path)  # footer only; the data reads once below
    meta = schema.metadata or {}
    if sft is None:
        spec = meta.get(_SFT_KEY)
        if spec is None:
            raise ValueError(
                "file has no geomesa.sft.spec metadata; pass sft explicitly"
            )
        sft = FeatureType.from_spec(
            meta.get(_NAME_KEY, b"features").decode(), spec.decode()
        )
    geom = sft.geom_field
    filters = None
    if bbox is not None:
        if f"{geom}_x" not in schema.names:
            raise ValueError("bbox push-down requires a point schema")
        x0, y0, x1, y1 = bbox
        filters = [
            (f"{geom}_x", ">=", x0), (f"{geom}_x", "<=", x1),
            (f"{geom}_y", ">=", y0), (f"{geom}_y", "<=", y1),
        ]
    table = pq.read_table(path, filters=filters)

    from geomesa_tpu_torch.io.arrow import table_to_collection

    return table_to_collection(table, sft)
