"""ORC feature IO — the geomesa-fs ORC storage-format analogue.

Reference: OrcFileSystemStorage (geomesa-fs/
geomesa-fs-storage/geomesa-fs-storage-orc/src/main/scala/org/
locationtech/geomesa/fs/storage/orc/OrcFileSystemStorage.scala,
OrcSearchArguments.scala). Same column layout as io/parquet (points as
flat ``<geom>_x``/``<geom>_y`` doubles, extents as WKB binary), written
through pyarrow.orc.

pyarrow's ORC writer cannot store user metadata in the file footer, so —
exactly like the reference FSDS keeps schema/partition state in separate
metadata files (fs/storage/common/metadata/FileBasedMetadata.scala) — the
SFT spec rides in a ``<path>.sft.json`` sidecar, and :class:`OrcStorage`
keeps a directory-level ``_metadata.json`` with per-file bboxes for
file-granularity bbox push-down (the OrcSearchArguments analogue:
pyarrow exposes no stripe-statistics filter, so pruning happens at the
file level and the residual bbox filters vectorized after read).
"""

from __future__ import annotations

import json
import os

import numpy as np

from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.sft import FeatureType


def _sidecar(path) -> str:
    return f"{path}.sft.json"


def write_orc(fc: FeatureCollection, path, compression: str = "zstd") -> None:
    """Write a collection to one ORC file plus a ``.sft.json`` schema
    sidecar."""
    import pyarrow.orc as orc

    from geomesa_tpu_torch.io.arrow import flat_point_table

    # ORC's own dictionary encoding handles strings; arrow dictionary
    # columns would round-trip as plain strings anyway
    orc.write_table(
        flat_point_table(fc, dictionary=False), path,
        compression=compression.upper(),
    )
    if isinstance(path, (str, os.PathLike)):  # file-likes get no sidecar
        with open(_sidecar(path), "w") as f:
            json.dump({"name": fc.sft.name, "spec": fc.sft.to_spec()}, f)


def read_orc(
    path,
    sft: "FeatureType | None" = None,
    bbox: "tuple[float, float, float, float] | None" = None,
) -> FeatureCollection:
    """Read an ORC file written by :func:`write_orc`. ``bbox`` applies a
    vectorized coordinate filter after the read: exact containment for
    point schemas, bbox-intersects on per-geometry bounds for extent
    schemas (the reader-side loose filter; exact predicates belong to the
    query path). File-level pruning lives in :class:`OrcStorage`, where
    per-file extents are known."""
    import pyarrow.orc as orc

    if sft is None:
        side = _sidecar(path)
        if not os.path.exists(side):
            raise ValueError(f"no sidecar {side}; pass sft explicitly")
        with open(side) as f:
            meta = json.load(f)
        sft = FeatureType.from_spec(meta["name"], meta["spec"])
    table = orc.ORCFile(path).read()
    from geomesa_tpu_torch.io.arrow import table_to_collection

    fc = table_to_collection(table, sft)
    if bbox is not None:
        geom = sft.geom_field
        x0, y0, x1, y1 = bbox
        if f"{geom}_x" in table.column_names:
            x = np.asarray(table[f"{geom}_x"], dtype=np.float64)
            y = np.asarray(table[f"{geom}_y"], dtype=np.float64)
            fc = fc.mask((x >= x0) & (x <= x1) & (y >= y0) & (y <= y1))
        elif geom is not None:
            b = fc.geom_column.bboxes.astype(np.float64)
            fc = fc.mask(
                (b[:, 0] <= x1) & (b[:, 2] >= x0)
                & (b[:, 1] <= y1) & (b[:, 3] >= y0)
            )
        else:
            raise ValueError("bbox filtering requires a geometry schema")
    return fc


class OrcStorage:
    """Directory of ORC chunk files with per-file bbox metadata: the
    OrcFileSystemStorage partition analogue. ``write`` appends a chunk
    file and records its extent; ``query(bbox)`` reads only files whose
    recorded extent intersects (file-granularity push-down), then applies
    the residual vectorized filter."""

    _META = "_metadata.json"

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._meta_path = os.path.join(root, self._META)
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.meta = json.load(f)
        else:
            self.meta = {"sft": None, "files": []}

    def _save_meta(self) -> None:
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.meta, f)
        os.replace(tmp, self._meta_path)

    def write(self, fc: FeatureCollection, compression: str = "zstd") -> str:
        if self.meta["sft"] is None:
            self.meta["sft"] = {"name": fc.sft.name, "spec": fc.sft.to_spec()}
        elif self.meta["sft"]["spec"] != fc.sft.to_spec():
            raise ValueError("schema mismatch with existing storage")
        name = f"chunk-{len(self.meta['files']):06d}.orc"
        path = os.path.join(self.root, name)
        write_orc(fc, path, compression=compression)
        from geomesa_tpu_torch.filter.predicates import PointColumn

        col = fc.geom_column
        if len(fc) == 0 or col is None:
            # inverted infinite extent: prunes against EVERY query box
            bbox = [float("inf"), float("inf"), float("-inf"), float("-inf")]
        elif isinstance(col, PointColumn):
            bbox = [
                float(np.min(col.x)), float(np.min(col.y)),
                float(np.max(col.x)), float(np.max(col.y)),
            ]
        else:  # union of true per-geometry bounds, not representative points
            b = col.bboxes.astype(np.float64)
            bbox = [
                float(b[:, 0].min()), float(b[:, 1].min()),
                float(b[:, 2].max()), float(b[:, 3].max()),
            ]
        self.meta["files"].append({"name": name, "rows": len(fc), "bbox": bbox})
        self._save_meta()
        return path

    @property
    def sft(self) -> FeatureType:
        m = self.meta["sft"]
        if m is None:
            raise ValueError("empty storage")
        return FeatureType.from_spec(m["name"], m["spec"])

    def files(self, bbox=None) -> list[str]:
        """Chunk files, pruned to those whose extent intersects bbox."""
        out = []
        for f in self.meta["files"]:
            if bbox is not None:
                fx0, fy0, fx1, fy1 = f["bbox"]
                x0, y0, x1, y1 = bbox
                if fx1 < x0 or fx0 > x1 or fy1 < y0 or fy0 > y1:
                    continue
            out.append(os.path.join(self.root, f["name"]))
        return out

    def query(self, bbox=None) -> FeatureCollection:
        sft = self.sft
        parts = [read_orc(p, sft=sft, bbox=bbox) for p in self.files(bbox)]
        parts = [p for p in parts if len(p)]
        if not parts:
            return FeatureCollection.from_rows(sft, [])
        if len(parts) == 1:
            return parts[0]
        return FeatureCollection.concat(parts)
