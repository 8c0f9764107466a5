"""Probe the XZ2 write path stage by stage, then sequential against
batched queries, on the card.

The port of the JAX package's scripts/probe_xz2_pipeline.py, on the
footprints of probe_xz2_50m (N rectangles, seed 62, 256 centres; the
reference's 50M). The write of the extent store is split into:

- ``geometry_s``: ``PackedGeometryColumn.from_boxes`` (the geometry
  build);
- ``keys_s``: the XZ2 index's ``write_keys`` (the write-key encode);
- ``sort_s``: the stable (bin, z) sort (``native.sort_bins_z``);
- ``upload_s``: ``IndexTable._stream_cols``: the sorted columns laid out
  in the scan layout and copied to the card;
- ``other_s``: the rest of ``DataStore.write`` (ids, statistics, the
  table's host keys), its wall less the three above.

Then, after the 40 warm-up queries of seed 1, the 40 queries of seed 2
run one by one through ``DataStore.query`` and together through one
``DataStore.query_many`` (K2 over the fused batch): both walls, the
features a second and the speedup. Each query's ids must be the same
set both ways, and equal to a numpy f64 brute force (all up to 5M
rows, 8 beyond); a mismatch raises. Times are host wall clock (the
write ends in a ``torch.cuda.synchronize``); off the card they are CPU
times of the plain versions, not device figures. Run on the card:

    python -m geomesa_tpu_torch.scripts.probe_xz2_pipeline [--rows N] [--device cuda]

It prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

from geomesa_tpu_torch.scripts.probe_xz2_50m import (N_QUERIES, N_REFERENCE, SPEC, check_ids,
                                                     footprints, mk, n_checked)


@contextmanager
def stage_clock(ds, type_name: str):
    """Seconds of the write's stages while the block runs: each index's
    ``write_keys``, the native (bin, z) sort and the tables' column
    streaming, each patched for the block and restored after."""
    from geomesa_tpu_torch import native
    from geomesa_tpu_torch.storage.table import IndexTable

    spent = {"keys_s": 0.0, "sort_s": 0.0, "upload_s": 0.0}

    def timed(real, key):
        def call(*a, **k):
            s = time.perf_counter()
            try:
                return real(*a, **k)
            finally:
                spent[key] += time.perf_counter() - s
        return call

    idxs = ds.indexes(type_name)
    for idx in idxs:
        idx.write_keys = timed(idx.write_keys, "keys_s")
    real_sort, real_stream = native.sort_bins_z, IndexTable._stream_cols
    native.sort_bins_z = timed(real_sort, "sort_s")
    IndexTable._stream_cols = timed(real_stream, "upload_s")
    try:
        yield spent
    finally:
        native.sort_bins_z = real_sort
        IndexTable._stream_cols = real_stream
        for idx in idxs:
            del idx.write_keys


def run(n: int = N_REFERENCE, device="cuda") -> dict:
    """The staged write, the warm-up, both query passes and the checks;
    returns the record."""
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType
    from geomesa_tpu_torch import geometry as geo
    from geomesa_tpu_torch.datastore import resolve_device

    device = resolve_device(device)
    cuda = device.type == "cuda"
    centres, rects = footprints(n)
    t = time.perf_counter()
    col = geo.PackedGeometryColumn.from_boxes(*rects)
    geometry_s = time.perf_counter() - t
    sft = FeatureType.from_spec("bld", SPEC)
    sft.user_data["geomesa.indices.enabled"] = "xz2"
    ds = DataStore(device=device)
    ds.create_schema(sft)
    fc = FeatureCollection.from_columns(sft, np.arange(n), {"geom": col})
    with stage_clock(ds, "bld") as stages:
        t = time.perf_counter()
        ds.write("bld", fc, check_ids=False)
        if cuda:
            torch.cuda.synchronize()
        write_s = time.perf_counter() - t
    del fc, col

    for _, q, _ in mk(centres, 1, N_QUERIES):
        ds.query("bld", q)
    qs = mk(centres, 2, N_QUERIES)
    t = time.perf_counter()
    seq = [ds.query("bld", q) for _, q, _ in qs]
    t_seq = time.perf_counter() - t
    t = time.perf_counter()
    pipe = ds.query_many("bld", [q for _, q, _ in qs])
    t_pipe = time.perf_counter() - t
    hits = sum(len(r.ids) for r in seq)
    same = ([sorted(np.asarray(r.ids).tolist()) for r in seq]
            == [sorted(np.asarray(r.ids).tolist()) for r in pipe])
    assert same, "query_many differs from sequential query"
    k = n_checked(n)
    for i, (res, (_, _, box)) in enumerate(zip(seq[:k], qs)):
        check_ids(res, rects, box, f"query {i}")
    ds.close()
    return {
        "driver": "probe_xz2_pipeline", "device": torch.cuda.get_device_name(device)
        if cuda else "cpu", "rows": n, "geometry_s": geometry_s, "write_s": write_s,
        **stages, "other_s": write_s - sum(stages.values()),
        "sequential_s": t_seq, "many_s": t_pipe, "hits": hits,
        "sequential_features_per_s": hits / t_seq, "many_features_per_s": hits / t_pipe,
        "speedup": t_seq / t_pipe, "same_ids": same, "query_hits": [len(r.ids) for r in seq],
        "checked_vs_brute_force": k,
        "reduced": [] if n >= N_REFERENCE else [f"rows {n:,} of the reference's "
                                                f"{N_REFERENCE:,}"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=N_REFERENCE, help="footprints (default 50M)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        rec = run(args.rows, args.device)
    except AssertionError as e:
        print(f"probe_xz2_pipeline: FAIL {e}", file=sys.stderr)
        return 1
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
