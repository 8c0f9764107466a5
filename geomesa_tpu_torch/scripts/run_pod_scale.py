"""The pod scale driver, on the card: provenance-stamped scale rows.

The port of the JAX package's scripts/run_pod_scale.py. Every row it
prints carries a provenance stamp taken when it runs (driver, argv, UTC
time, platform, device count and name, git revision), and one code path
runs at every scale:

1. **host-local ingest**: rows generate in chunks, each from its own
   seed (so the brute force can regenerate any chunk without holding the
   data), and feed one pipelined ``BulkLoader`` into the pod store, whose
   table deals each build host-major;
2. **config-1 queries**: the 12-probe BBOX + DURING ladder, each count
   equal to a chunked brute force over the regenerated columns;
3. **the fused leg**: a 10-member ``query_many`` batch of the same
   variant, which must take the fused dispatch at the shard seam
   (``DistributedIndexTable._fused_raw_finishes``, counted by a spy),
   every member exact;
4. **streamed compaction**: a delta write, then ``compact`` under a
   bounded ``geomesa.tpu.compact.span.rows`` so ``_stream_cols`` runs
   many spans per column, peak RSS sampled (``hostmem.RssSampler``) and
   reported over the column set (``hostmem.column_set_bytes``, the
   reference's sum; on the card the tables' columns are device memory,
   so the host's transient over it reads low).

``--ci`` runs the same path at 2M rows and turns the report into
assertions (exactness, the fused dispatch taken, at least 10 spans a
column, a transient under 2x the column set); a violation exits 1.

On a card, ``--driver sim`` (the default) backs the ``--hosts`` hosts
with a virtual mesh of max(8, hosts) entries of the one card
(``make_host_group(..., devices=["cuda:0"] * 8)``), where the reference
forks as many virtual CPU devices; ``distributed`` and ``auto`` resolve as
``pod.hostgroup.make_host_group`` resolves them (``distributed`` over
the visible cards). The provenance stamp names ``cuda`` or ``cpu`` where
the reference names ``jax.default_backend()``.

Output: one JSON line, the row, on stdout; progress on stderr. ``--out
PATH`` appends the row to PATH in the reference's ``{"rows": [...]}``
format. There is no default file: the driver never writes the JAX
package's ``SCALE_1B.json`` and refuses an ``--out`` that names it. Run
on the card (the reference's size is 10⁹ rows):

    python -m geomesa_tpu_torch.scripts.run_pod_scale --ci
    python -m geomesa_tpu_torch.scripts.run_pod_scale --rows 1000000000 --hosts 4

``--device cpu`` runs the plain kernels on a virtual mesh of CPU
entries; without a card ``cuda`` raises.
"""

from __future__ import annotations

import argparse
import datetime
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from geomesa_tpu_torch.scripts import hostmem

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REFERENCE_OUT = "SCALE_1B.json"  # the JAX package's file: never written here
N_REFERENCE = 1_000_000_000
N_CI = 2_000_000
DAY = 86_400_000
T0 = 1_704_067_200_000
SEED = 20_001
SPEC = "dtg:Date,*geom:Point:srid=4326"
DELTA_CHUNK_SEED = 10_000_019  # the delta's reserved chunk index
VIRTUAL_DEVICES = 8  # the reference's virtual CPU devices for the sim driver


def _parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ci", action="store_true", help="scaled-down assertion mode")
    ap.add_argument("--rows", type=int, default=None,
                    help="total rows (default: 2M with --ci, 1e9 without)")
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--devices-per-host", type=int, default=0,
                    help="0 = even split of the devices")
    ap.add_argument("--driver", default="sim", choices=("sim", "distributed", "auto"))
    ap.add_argument("--chunk", type=int, default=500_000, help="generation/brute-force chunk rows")
    ap.add_argument("--span-rows", type=int, default=4_194_304,
                    help="geomesa.tpu.compact.span.rows of the streamed compaction "
                         "(--ci forces 65536)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="append the row to this JSON file (default: print only)")
    return ap.parse_args(argv)


def provenance(argv, device, n_devices: int) -> dict:
    """The row's stamp, taken now."""
    try:
        rev = subprocess.run(["git", "-C", ROOT, "rev-parse", "HEAD"], capture_output=True,
                             text=True, timeout=10).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        rev = None
    cuda = device.type == "cuda"
    return {
        "driver": "geomesa_tpu_torch/scripts/run_pod_scale.py",
        "argv": list(argv),
        "time_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="seconds"),
        "platform": device.type,
        "devices": torch.cuda.device_count() if cuda else 1,
        "mesh_devices": n_devices,
        "device_name": torch.cuda.get_device_name(device) if cuda else "cpu",
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "git_rev": rev,
    }


def _chunk_cols(ci: int, k: int):
    """Chunk ci's columns, regenerable apart from every other chunk: the
    ingest and the brute force call this with the same arguments and get
    the same rows."""
    rng = np.random.default_rng(SEED + 7 * ci)
    return (rng.uniform(-60, 60, k), rng.uniform(-45, 45, k), T0 + rng.integers(0, 20 * DAY, k))


def _probes():
    """12 probes, 14 x 10 and 4 x 3 degrees in turn, rounded to the
    filter's 4 decimals; every one timed (config 1 is BBOX + DURING)."""
    rng = np.random.default_rng(SEED + 3)
    out = []
    for i in range(12):
        x0 = round(float(rng.uniform(-55, 40)), 4)
        y0 = round(float(rng.uniform(-40, 30)), 4)
        w, h = (4.0, 3.0) if i % 2 else (14.0, 10.0)
        out.append((x0, y0, round(x0 + w, 4), round(y0 + h, 4), True))
    return out


def _filter(box, timed: bool) -> str:
    f = f"bbox(geom, {box[0]:.4f}, {box[1]:.4f}, {box[2]:.4f}, {box[3]:.4f})"
    if timed:
        f += " AND dtg DURING 2024-01-04T00:00:00Z/2024-01-13T00:00:00Z"
    return f


def _window():
    """The DURING window in ms: inclusive lo, exclusive hi."""
    lo = int(np.datetime64("2024-01-04T00:00:00", "ms").astype(np.int64))
    hi = int(np.datetime64("2024-01-13T00:00:00", "ms").astype(np.int64))
    return lo, hi


def _brute_counts(n: int, chunk: int, boxes) -> list:
    """Chunked brute force of every probe in one pass over the
    regenerated columns, O(chunk) memory at any n."""
    lo, hi = _window()
    counts = [0] * len(boxes)
    for ci, s in enumerate(range(0, n, chunk)):
        x, y, t = _chunk_cols(ci, min(chunk, n - s))
        for j, (x0, y0, x1, y1, timed) in enumerate(boxes):
            m = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
            if timed:
                m &= (t >= lo) & (t < hi)
            counts[j] += int(m.sum())
    return counts


def _group(args, device):
    from geomesa_tpu_torch.pod import make_host_group
    from geomesa_tpu_torch.pod.hostgroup import world_size

    if args.driver == "distributed" or (args.driver == "auto" and world_size() > 1):
        devices = None  # the visible cards
    else:
        devices = [device] * max(VIRTUAL_DEVICES, args.hosts)
    return make_host_group(hosts=args.hosts, devices_per_host=args.devices_per_host or None,
                           driver=args.driver, devices=devices)


def run(args, argv) -> dict:
    """The four phases; returns the row (the reference's keys; with
    ``--ci``, ``ci_failures`` lists every violated assertion)."""
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType, conf
    from geomesa_tpu_torch.datastore import resolve_device
    from geomesa_tpu_torch.ingest.pipeline import BulkLoader
    from geomesa_tpu_torch.parallel.dtable import DistributedIndexTable

    device = resolve_device(args.device)
    n = args.rows or (N_CI if args.ci else N_REFERENCE)
    span_rows = 65_536 if args.ci else args.span_rows
    if device.type == "cuda":
        torch.zeros(1, device=device)  # the context, before the baseline RSS
    gc.collect()
    hostmem.malloc_trim()
    rss_baseline = hostmem.rss_bytes()
    group = _group(args, device)
    stamp = provenance(argv, device, len(group.devices))
    stamp["reduced"] = []
    if device.type == "cuda" and group.driver == "sim":
        stamp["reduced"].append(
            f"{stamp['mesh_devices']} virtual devices of one card for the reference's "
            "virtual CPU devices")
    print(f"[pod-scale] provenance: {json.dumps(stamp)}", file=sys.stderr)
    sft = FeatureType.from_spec("sc", SPEC)
    sft.user_data["geomesa.indices.enabled"] = "z3"
    ds = DataStore(device=device, mesh=group)
    ds.create_schema(sft)

    # 1. pipelined ingest, chunked generation
    loader = BulkLoader(ds, "sc")
    t_ingest0 = time.perf_counter()
    for ci, s0 in enumerate(range(0, n, args.chunk)):
        k = min(args.chunk, n - s0)
        x, y, t = _chunk_cols(ci, k)
        loader.put(FeatureCollection.from_columns(
            sft, np.arange(s0, s0 + k).astype(str), {"dtg": t, "geom": (x, y)}))
    loader.close()
    if device.type == "cuda":
        torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t_ingest0
    assert ds.count("sc") == n
    print(f"[pod-scale] ingest {n:,} rows in {ingest_s:.1f}s ({n / ingest_s:,.0f} rows/s)",
          file=sys.stderr)

    # 2. config-1 queries, exact against the chunked brute force
    boxes = _probes()
    truth = _brute_counts(n, args.chunk, boxes)
    latencies, got = [], []
    for box in boxes:
        t0 = time.perf_counter()
        got.append(int(ds.count("sc", _filter(box, box[4]))))
        latencies.append(round(time.perf_counter() - t0, 4))
    queries_exact = got == truth
    print(f"[pod-scale] queries exact={queries_exact} "
          f"p50={sorted(latencies)[len(latencies) // 2]:.3f}s "
          f"(hits {min(truth):,}..{max(truth):,})", file=sys.stderr)

    # 3. the fused leg: more than 8 members of one variant, counted at
    # the shard seam
    fused_calls = [0]
    orig = DistributedIndexTable._fused_raw_finishes

    def spy(self, *a, **kw):
        fused_calls[0] += 1
        return orig(self, *a, **kw)

    DistributedIndexTable._fused_raw_finishes = spy
    try:
        batch = [_filter(b, True) for b in boxes[:10]]
        outs = ds.query_many("sc", batch)
    finally:
        DistributedIndexTable._fused_raw_finishes = orig
    fused_exact = [len(o) for o in outs] == truth[:10]
    print(f"[pod-scale] fused join: {len(batch)} members, {fused_calls[0]} shard legs, "
          f"exact={fused_exact}", file=sys.stderr)

    # 4. streamed compaction under a bounded span: the pipelined load
    # built the base table, so a delta write forces the full merge
    lo, hi = _window()
    n_delta = max(args.chunk // 5, min(n // 50, 2_000_000))
    dx, dy, dt = _chunk_cols(DELTA_CHUNK_SEED, n_delta)
    ds.write("sc", FeatureCollection.from_columns(
        sft, np.char.add("d", np.arange(n_delta).astype(str)), {"dtg": dt, "geom": (dx, dy)}),
        check_ids=False)
    b0 = boxes[0]
    delta0 = int(((dx >= b0[0]) & (dx <= b0[2]) & (dy >= b0[1]) & (dy <= b0[3])
                  & (dt >= lo) & (dt < hi)).sum())
    del dx, dy, dt
    conf.COMPACT_SPAN_ROWS.set(span_rows)
    try:
        gc.collect()
        hostmem.malloc_trim()
        column_set = hostmem.column_set_bytes(ds, "sc")
        rss_pre = hostmem.rss_bytes()
        t0 = time.perf_counter()
        with hostmem.RssSampler() as rss:
            ds.compact("sc")
            if device.type == "cuda":
                torch.cuda.synchronize()
        compact_s = time.perf_counter() - t0
    finally:
        conf.COMPACT_SPAN_ROWS.clear()
    transient_over_cs = (rss.peak - rss_pre) / max(column_set, 1)
    table = next(t for (tn, _), t in ds._tables.items() if tn == "sc")
    spans_per_column = -(-table.n // max(table.block, span_rows))
    post = int(ds.count("sc", _filter(b0, b0[4])))
    compact_exact = post == truth[0] + delta0
    print(f"[pod-scale] streamed compaction of {n_delta:,}-row delta in {compact_s:.1f}s, "
          f"{spans_per_column} spans/column, transient {transient_over_cs:.2f}x column set, "
          f"exact={compact_exact}", file=sys.stderr)
    stamp["reduced"] = hostmem.rows_cut(n, N_REFERENCE, rss_baseline) + stamp["reduced"]
    stamp["peak_host_rss_bytes"] = hostmem.peak_rss_bytes()
    stamp["host_mem_total_bytes"] = hostmem.mem_total_bytes()
    stamp["peak_device_bytes"] = (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None)
    ds.close()

    row = {
        "scenario": "pod_scale_ci" if args.ci else "pod_scale",
        "n_rows": n,
        "hosts": group.hosts,
        "devices_per_host": group.devices_per_host,
        "pod_driver": group.driver,
        "ingest": {"measured_s": round(ingest_s, 1), "rows_per_s": int(n / ingest_s)},
        "queries": {
            "n": len(boxes), "exact": bool(queries_exact), "latencies_s": latencies,
            "p50_s": sorted(latencies)[len(latencies) // 2],
        },
        "fused_join": {"members": len(batch), "shard_legs": fused_calls[0],
                       "exact": bool(fused_exact)},
        "compaction": {
            "streamed": True,
            "span_rows": span_rows,
            "delta_rows": int(n_delta),
            "spans_per_column": int(spans_per_column),
            "compact_s": round(compact_s, 1),
            "column_set_bytes": int(column_set),
            "rss_baseline_bytes": int(rss_baseline),
            "rss_pre_compact_bytes": int(rss_pre),
            "rss_peak_bytes": int(rss.peak),
            "transient_over_column_set": round(transient_over_cs, 3),
            "exact": bool(compact_exact),
        },
        "provenance": stamp,
    }
    if args.ci:
        failures = []
        if not queries_exact:
            failures.append(f"query counts {got} != truth {truth}")
        if not fused_exact:
            failures.append("fused join member counts diverge from truth")
        if fused_calls[0] < 1:
            failures.append("batch never took the fused dispatch")
        if not compact_exact:
            failures.append("post-compaction probe diverges")
        if spans_per_column < 10:
            failures.append(f"only {spans_per_column} spans/column — the bounded path did "
                            "not really run")
        if transient_over_cs >= 2.0:
            failures.append(f"compaction transient {transient_over_cs:.2f}x column set "
                            "(bound 2.0)")
        row["ci_failures"] = failures
        for f in failures:
            print(f"[pod-scale] CI FAIL: {f}", file=sys.stderr)
    return row


def write_row(out_path: str, row: dict) -> None:
    """Append the row to ``out_path``'s ``{"rows": [...]}`` (a single
    legacy object there becomes rows[0]). Refuses the JAX package's
    SCALE_1B.json at the repo's root."""
    if os.path.realpath(out_path) == os.path.realpath(os.path.join(ROOT, REFERENCE_OUT)):
        raise ValueError(f"{REFERENCE_OUT} at the repo's root belongs to the JAX package")
    rows = []
    if os.path.exists(out_path):
        with open(out_path) as fh:
            old = json.load(fh)
        rows = old["rows"] if isinstance(old, dict) and "rows" in old else [old]
    rows.append(row)
    with open(out_path, "w") as fh:
        json.dump({"rows": rows}, fh, indent=1)
    print(f"[pod-scale] wrote {out_path} ({len(rows)} rows)", file=sys.stderr)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parse_args(argv)
    row = run(args, argv)
    if args.out:
        write_row(args.out, row)
    print(json.dumps(row), flush=True)
    if args.ci:
        return 1 if row["ci_failures"] else 0
    # without --ci the row reports; an inexact answer still fails the run
    exact = (row["queries"]["exact"] and row["fused_join"]["exact"]
             and row["compaction"]["exact"] and row["fused_join"]["shard_legs"] > 0)
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
