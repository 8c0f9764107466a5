"""Command-line interface: catalog management, ingest, export, explain,
stats, ops, tuning and the data plane.

The port's copy of geomesa_tpu/cli.py (reference geomesa-tools'
command tree, Runner.scala:30-70). The catalog (``-c``) is a persistence
directory (geomesa_tpu_torch.storage.persist): commands load the store on
``--device`` (``cuda`` by default, as every entry point of the port; a
machine without a card raises unless ``--device cpu`` is given), run, and
save back when they mutate.

    python -m geomesa_tpu_torch.cli create-schema -c /data/cat -f gdelt \
        -s "dtg:Date,*geom:Point:srid=4326"
    python -m geomesa_tpu_torch.cli ingest -c /data/cat -f gdelt --infer data.csv
    python -m geomesa_tpu_torch.cli export -c /data/cat -f gdelt \
        -q "bbox(geom,-10,-10,10,10)" --format geojson
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from geomesa_tpu_torch.storage import persist


def _load(args):
    return persist.load(args.catalog, device=args.device)


def cmd_version(args) -> int:
    from geomesa_tpu_torch import __version__

    print(f"geomesa_tpu_torch {__version__}")
    return 0


def cmd_env(args) -> int:
    import torch

    from geomesa_tpu_torch import conf
    from geomesa_tpu_torch.datastore import resolve_device

    print(f"device: {resolve_device(args.device)}")
    print(f"torch: {torch.__version__} (cuda build {torch.version.cuda})")
    print(conf.describe())
    return 0


def cmd_create_schema(args) -> int:
    import os

    from geomesa_tpu_torch.datastore import DataStore

    if os.path.exists(f"{args.catalog}/metadata.json"):
        ds = _load(args)
    else:
        ds = DataStore(device=args.device)
    ds.create_schema(args.feature_name, args.spec)
    persist.save(ds, args.catalog)
    print(f"created schema '{args.feature_name}'")
    return 0


def cmd_get_type_names(args) -> int:
    for n in _load(args).type_names():
        print(n)
    return 0


def cmd_describe_schema(args) -> int:
    sft = _load(args).get_schema(args.feature_name)
    for a in sft.attributes:
        flags = []
        if a.name == sft.geom_field:
            flags.append("default geometry")
        if a.indexed:
            flags.append("indexed")
        extra = f" ({', '.join(flags)})" if flags else ""
        print(f"{a.name}: {a.type}{extra}")
    return 0


def cmd_delete_schema(args) -> int:
    ds = _load(args)
    ds.delete_schema(args.feature_name)
    persist.save(ds, args.catalog)
    print(f"deleted schema '{args.feature_name}'")
    return 0


def _converter_from_file(sft, path: str):
    from geomesa_tpu_torch.io.converters import Converter, FieldSpec

    with open(path) as fh:
        conf = json.load(fh)
    return Converter(
        sft=sft,
        fields=[FieldSpec(f["name"], f["transform"]) for f in conf["fields"]],
        id_field=conf.get("id-field"),
        fmt=conf.get("format", "delimited"),
        delimiter=conf.get("delimiter", ","),
        skip_lines=int(conf.get("skip-lines", 0)),
    )


def cmd_ingest(args) -> int:
    import os

    from geomesa_tpu_torch.datastore import DataStore
    from geomesa_tpu_torch.io.converters import infer_schema

    if os.path.exists(f"{args.catalog}/metadata.json"):
        ds = _load(args)
    else:
        ds = DataStore(device=args.device)

    if getattr(args, "file_format", None):
        return _ingest_direct(ds, args)

    if not args.infer and args.workers and args.workers > 1:
        # distributed-ingest mode: process-pool converters feeding the
        # staged pipeline (docs/ingest.md); --no-pipeline falls back to
        # the sequential-commit loader (per-split incremental visibility)
        if getattr(args, "no_pipeline", False):
            from geomesa_tpu_torch.io.ingest import ingest_files
        else:
            from geomesa_tpu_torch.ingest import ingest_files

        sft = ds.get_schema(args.feature_name)
        conv = _converter_from_file(sft, args.converter)
        res = ingest_files(ds, conv, args.files, workers=args.workers)
        if res.errors:
            by = getattr(res, "error_reasons", None) or {}
            detail = (
                " (" + ", ".join(f"{r}: {n}" for r, n in sorted(by.items())) + ")"
                if by else ""
            )
            print(f"{res.errors} records dropped{detail}", file=sys.stderr)
        persist.save(ds, args.catalog)
        print(
            f"ingested {res.written} features into '{args.feature_name}' "
            f"({res.splits} splits, {args.workers} workers)"
        )
        if res.stage_seconds:
            # per-stage wall attribution: where the ingest time lives
            print(
                "stages: " + "  ".join(
                    f"{k}={v:.2f}s" for k, v in res.stage_seconds.items() if v
                ),
                file=sys.stderr,
            )
        return 0

    conv0 = None
    if not args.infer:
        conv0 = _converter_from_file(
            ds.get_schema(args.feature_name), args.converter
        )
    total = 0
    for path in args.files:
        # binary formats (avro) must not be utf-8 decoded
        mode = "rb" if conv0 is not None and conv0.fmt == "avro" else "r"
        with open(path, mode) as fh:
            data = fh.read()
        if args.infer:
            import csv as _csv
            import io as _io

            rows = [r for r in _csv.reader(_io.StringIO(data)) if r]
            header = rows[0] if args.header else None
            body = rows[1:] if args.header else rows
            sft, conv = infer_schema(args.feature_name, body, header=header)
            # a later file must infer the same shape as the stored
            # schema — silently concatenating mismatched columns (Int
            # vs Double, different geometry pair) corrupts the store
            _ensure_schema(ds, args.feature_name, sft, path)
            if args.header:
                conv.skip_lines = 1
        else:
            conv = conv0
        fc = conv.convert(data)
        if conv._id_expr is None:
            # default running-index ids restart per file; offset by the
            # store's current size so repeat ingests stay unique
            base = len(ds.features(args.feature_name))
            fc = type(fc)(
                fc.sft,
                np.array([str(base + i) for i in range(len(fc))]),
                fc.columns,
            )
        n = ds.write(args.feature_name, fc)  # duplicate-id check stays on
        total += n
        if conv.errors:
            print(f"{path}: {conv.errors} records failed to parse", file=sys.stderr)
    persist.save(ds, args.catalog)
    print(f"ingested {total} features into '{args.feature_name}'")
    return 0


def _ensure_schema(ds, feature_name: str, sft, source: str):
    """Create the schema on first contact, or verify the incoming spec
    matches the stored one; returns the store's canonical FeatureType.
    Shared by the infer and --file-format ingest paths."""
    from geomesa_tpu_torch.sft import FeatureType

    if feature_name not in ds.type_names():
        if sft.name != feature_name:
            sft = FeatureType.from_spec(feature_name, sft.to_spec())
        ds.create_schema(sft)
        return sft
    stored = ds.get_schema(feature_name)
    if sft.to_spec() != stored.to_spec():
        raise SystemExit(
            f"{source!r} schema does not match the existing "
            f"{feature_name!r} schema:\n"
            f"  incoming: {sft.to_spec()}\n"
            f"  stored:   {stored.to_spec()}"
        )
    return stored


def _ingest_direct(ds, args) -> int:
    """Self-describing file ingest: schema comes from the file itself
    (reference geomesa-convert-parquet / geomesa-convert-shp). When the
    catalog holds the schema — including one created by an earlier file
    THIS run — it is offered to the readers so externally-written files
    (no geomesa metadata/sidecar) still load and later files coerce to
    the stored shape."""

    def read(path):
        known = (
            ds.get_schema(args.feature_name)
            if args.feature_name in ds.type_names()
            else None
        )
        if args.file_format in ("parquet", "orc", "arrow"):
            if args.file_format == "parquet":
                from geomesa_tpu_torch.io.parquet import read_parquet as reader
            elif args.file_format == "orc":
                from geomesa_tpu_torch.io.orc import read_orc as reader
            else:
                from geomesa_tpu_torch.io.arrow import read_arrow as reader
            try:
                # prefer the file's own schema so mismatches are caught
                return reader(path)
            except ValueError:
                if known is None:
                    raise
                return reader(path, sft=known)
        if args.file_format == "geojson":
            from geomesa_tpu_torch.io.geojson import read_geojson

            # live store size per FILE: the schema may have been created
            # by an earlier file this run, and synthesized ids must keep
            # rebasing as each file lands (cf. the shp path below)
            base = (
                len(ds.features(args.feature_name))
                if args.feature_name in ds.type_names()
                else 0
            )
            return read_geojson(
                path, type_name=args.feature_name, sft=known, id_offset=base
            )
        from geomesa_tpu_torch.io.shapefile import read_shapefile

        shp = path if path.lower().endswith(".shp") else f"{path}.shp"
        return read_shapefile(shp, type_name=args.feature_name)

    total = 0
    for path in args.files:
        try:
            fc = read(path)
        except ValueError as e:
            print(f"cannot read {path!r}: {e}", file=sys.stderr)
            return 1
        sft = _ensure_schema(ds, args.feature_name, fc.sft, path)
        if args.file_format == "shp":
            # shapefiles carry no feature ids: the reader synthesizes
            # running indices, which collide across files / repeat
            # ingests — rebase on the store size like the CSV path
            base = len(ds.features(args.feature_name))
            ids = np.array([str(base + i) for i in range(len(fc))])
        else:
            ids = fc.ids
        total += ds.write(args.feature_name, type(fc)(sft, ids, fc.columns))
    persist.save(ds, args.catalog)
    print(f"ingested {total} features into '{args.feature_name}'")
    return 0


def cmd_convert(args) -> int:
    """Run a converter over files and render the features WITHOUT a store
    (reference geomesa-tools ConvertCommand): convert -s <spec>
    --converter conf.json --format geojson files..."""
    from geomesa_tpu_torch.features import FeatureCollection
    from geomesa_tpu_torch.io.exporters import export
    from geomesa_tpu_torch.sft import FeatureType

    sft = FeatureType.from_spec("converted", args.spec)
    conv = _converter_from_file(sft, args.converter)
    parts = []
    errors = 0
    base = 0
    for path in args.files:
        mode = "rb" if conv.fmt == "avro" else "r"
        with open(path, mode) as fh:
            part = conv.convert(fh.read())
        if conv._id_expr is None and len(part):
            # default running-index ids restart per file (cf. cmd_ingest)
            part = type(part)(
                part.sft,
                np.array([str(base + i) for i in range(len(part))]),
                part.columns,
            )
        base += len(part)
        parts.append(part)
        errors += conv.errors
    if errors:
        print(f"{errors} records failed to parse", file=sys.stderr)
    parts = [p for p in parts if len(p)]
    if not parts:
        print("no features converted", file=sys.stderr)
        return 1
    fc = parts[0] if len(parts) == 1 else FeatureCollection.concat(parts)
    payload = export(fc, args.format)
    if args.output:
        mode = "wb" if isinstance(payload, bytes) else "w"
        with open(args.output, mode) as fh:
            fh.write(payload)
        print(f"converted {len(fc)} features to {args.output}", file=sys.stderr)
    else:
        sys.stdout.write(payload if isinstance(payload, str) else payload.hex())
    return 0


def _write_payload(payload, output, n_rows: int, verb: str) -> None:
    """Shared exporter tail: file (binary-aware) or stdout (hex for
    binary formats)."""
    if output:
        mode = "wb" if isinstance(payload, bytes) else "w"
        with open(output, mode) as fh:
            fh.write(payload)
        print(f"{verb} {n_rows} features to {output}")
    else:
        sys.stdout.write(payload if isinstance(payload, str) else payload.hex())


def cmd_sql(args) -> int:
    """Run one SELECT (sql.query front-end: ST_ predicates push down
    into the planner; reference Spark SQL relation tier)."""
    from geomesa_tpu_torch.io.exporters import export
    from geomesa_tpu_torch.sql import sql_query

    ds = _load(args)
    out = sql_query(ds, args.query)
    _write_payload(export(out, args.format), args.output, len(out), "wrote")
    return 0


def cmd_export(args) -> int:
    from geomesa_tpu_torch.io.exporters import export

    ds = _load(args)
    hints = None
    if getattr(args, "reproject", None):
        from geomesa_tpu_torch.planning.hints import QueryHints

        hints = QueryHints(reproject=args.reproject)
    out = ds.query(
        args.feature_name, args.cql or "INCLUDE", limit=args.max_features,
        hints=hints,
    )
    if args.format.lower() in ("shp", "shapefile"):
        # multi-file sink: -o names the .shp (or the base path)
        if not args.output:
            print("shapefile export requires -o/--output", file=sys.stderr)
            return 1
        from geomesa_tpu_torch.io.shapefile import write_shapefile

        base = args.output
        if base.lower().endswith(".shp"):
            base = base[:-4]
        try:
            write_shapefile(out, base)
        except ValueError as e:  # empty result / mixed geometry families
            print(f"shapefile export failed: {e}", file=sys.stderr)
            return 1
        print(f"exported {len(out)} features to {base}.shp/.shx/.dbf")
        return 0
    _write_payload(export(out, args.format), args.output, len(out), "exported")
    return 0


def cmd_explain(args) -> int:
    print(_load(args).explain(args.feature_name, args.cql))
    return 0


def cmd_stats(args) -> int:
    from geomesa_tpu_torch.stats import stat_spec

    ds = _load(args)
    results = ds.stats_query(args.feature_name, args.spec, args.cql or "INCLUDE")
    print(json.dumps(stat_spec.to_json(results), default=str))
    return 0


def cmd_count(args) -> int:
    print(_load(args).count(args.feature_name, args.cql or "INCLUDE"))
    return 0


def cmd_stats_analyze(args) -> int:
    """Recompute statistics from the stored data (reference geomesa-tools
    stats-analyze). In a long-lived store, per-batch histograms rebin on
    merge as bounds widen; a full re-sketch rebuilds them at the final
    bounds. (A freshly loaded store already has exact stats — load
    re-ingests through the write path.)"""
    ds = _load(args)
    stats = ds.analyze_stats(args.feature_name)
    n = stats.total_count() if stats is not None else 0
    print(f"re-analyzed {args.feature_name}: {n} features sketched")
    persist.save(ds, args.catalog)
    return 0


def cmd_ops(args) -> int:
    """One-shot ops report (reference `stats-analyze`-style maintenance
    command; docs/observability.md "The ops plane"): health verdict +
    machine-readable reasons, the SLO report, top-N slow queries and
    per-index estimate accuracy — human text, or `--json` for scripts.
    Runs over the loaded catalog; a live serving process exposes the
    same payloads over HTTP via `DataStore.serve_ops()`."""
    from geomesa_tpu_torch.obs.ops import ops_report

    ds = _load(args)
    report = ops_report(ds, slow_n=args.slow)
    if args.json:
        print(json.dumps(report, default=str))
        return 0
    health = report["health"]
    print(f"status: {health['status']}")
    if health["reasons"]:
        for r in health["reasons"]:
            print(f"  [{r['severity']}] {r['reason']}: {r['detail']}")
    else:
        print("  no reasons — all checks clean")
    slo = health["slo"]
    print(f"slo ({slo['window_s']:g}s window): {slo['status']}")
    for row in slo["objectives"]:
        mark = "ok " if row["ok"] else "BREACH"
        print(
            f"  {mark} {row['objective']}: p{int(row['quantile'] * 100)} "
            f"{row['value_ms']}ms / {row['threshold_ms']}ms "
            f"(n={row['count']}, burn {row['burn_rate']})"
        )
    est = health.get("estimates") or {"indexes": []}
    print("estimate accuracy (error factor, 1.0 = perfect):")
    if not est["indexes"]:
        print("  no estimate-vs-actual samples recorded")
    for row in est["indexes"]:
        print(
            f"  {row['type']}/{row['index']}: n={row['count']} "
            f"p50 {row['p50_error']}x p90 {row['p90_error']}x "
            f"worst {row['worst_error']}x"
        )
    print(f"slow queries (top {args.slow}):")
    if not report["slow_queries"]:
        print("  none captured")
    for e in report["slow_queries"]:
        fp = e["fingerprint"]
        print(
            f"  {e['wall_ms']}ms {fp.get('type')}/{fp.get('strategy')} "
            f"{fp.get('filter', '')[:60]} (trace {e['trace_id']})"
        )
    return 0


def cmd_tune(args) -> int:
    """One-shot self-tuning report (docs/tuning.md): every controller's
    current value/bounds/objective reading, the plan-feedback factor
    table, the burn gate state and the recorded adaptation decisions —
    human text, or `--json` for scripts. Attaches a manager over the
    loaded catalog (rehydrating persisted state when a state file
    exists) without arming it; a live serving process exposes the same
    payload at `GET /debug/tuning`."""
    import os as _os

    ds = _load(args)
    state = args.state
    if state is None:
        default_state = _os.path.join(args.catalog, "_tuning.json")
        if _os.path.exists(default_state):
            state = default_state
    if ds.tuning is None:
        ds.attach_tuning(state_path=state)
    report = ds.tuning_report()
    if args.json:
        print(json.dumps(report, default=str))
        return 0
    print(f"tuning: {'armed' if report['enabled'] else 'disarmed'}")
    print("controllers:")
    for row in report["controllers"]:
        reading = row["reading"]
        print(
            f"  {row['name']}: {row['knob']} = {row['value']} "
            f"in [{row['lo']:g}, {row['hi']:g}] "
            f"({row['policy']} on {row['objective']}, "
            f"reading {'-' if reading is None else f'{reading:.6g}'})"
        )
    factors = report["plan_factors"]
    print("plan factors (estimate-accuracy reweighting, 1.0 = neutral):")
    if not factors:
        print("  none engaged")
    for key, fac in factors.items():
        print(f"  {key}: x{fac}")
    burn = report.get("burn")
    if burn:
        state_s = "ENGAGED" if burn["engaged"] else "clear"
        print(
            f"burn gate: {state_s} ({burn['objective']} burn "
            f"{burn['burn']}x / threshold {burn['threshold']}x)"
        )
    print(f"decisions (last {len(report['decisions'])}):")
    if not report["decisions"]:
        print("  none recorded")
    for d in report["decisions"]:
        what = d.get("knob") or d.get("key") or d["controller"]
        print(f"  {d['controller']} {what}: {d['from']} -> {d['to']}")
        print(f"    {d['reason']}")
    return 0


def cmd_serve(args, hold: bool = True):
    """Serve a catalog over HTTP (docs/serving.md "The data plane"):
    `/query/<type>`, `/ingest/<type>` and `/tenants` plus the ops
    surfaces (`/health`, `/metrics`, ...) on ONE port, multi-tenant
    admission through the store's scheduler. `--replica-of <wal-dir>`
    mounts the catalog as a read replica instead, tailing that leader
    WAL directory on disk every `--tail-interval` seconds (writes then
    answer 403 carrying `--leader-url`). `hold=False` (tests, embedding)
    returns the started server instead of blocking."""
    import time as _time

    if args.replica_of:
        from geomesa_tpu_torch.streaming.replica import ReplicaStore

        class _NoTransport:
            """Disk-tail topology: no live shipper to receive from."""

            def send(self, msg) -> None:
                pass

            def recv(self, timeout: float = 0.0):
                return None

            def close(self) -> None:
                pass

        store = ReplicaStore(
            args.catalog,
            args.replica_wal or f"{args.catalog}/_replica_wal",
            _NoTransport(), type_name=args.feature_name, device=args.device,
        )
        store.tail_disk(args.replica_of)
        srv = store.serve(
            port=args.port, host=args.host, leader_url=args.leader_url
        )
    else:
        store = _load(args)
        srv = store.serve(port=args.port, host=args.host)
    print(f"serving {args.catalog} at {srv.url}")
    if not hold:
        return srv
    try:
        while True:
            _time.sleep(max(args.tail_interval, 0.05))
            if args.replica_of:
                store.tail_disk(args.replica_of)
    except KeyboardInterrupt:
        pass
    finally:
        store.close()
    return 0


def cmd_playback(args) -> int:
    """Replay a store's features in time order into a streaming cache at a
    rate multiplier (reference geomesa-tools `playback` command, which
    replays dtg-ordered features to simulate a live stream). ``--rate 0``
    replays as fast as possible; each batch prints one summary line."""
    import time as _time

    from geomesa_tpu_torch.streaming import StreamingFeatureCache

    ds = _load(args)
    sft = ds.get_schema(args.feature_name)
    if sft.dtg_field is None:
        print("playback requires a schema with a date attribute", file=sys.stderr)
        return 1
    fc = ds.query(args.feature_name, args.cql or "INCLUDE")
    if len(fc) == 0:
        print("nothing to play back")
        return 0
    order = np.argsort(np.asarray(fc.columns[sft.dtg_field]), kind="stable")
    fc = fc.take(order)
    t = np.asarray(fc.columns[sft.dtg_field], dtype=np.int64)
    cache = StreamingFeatureCache(sft)
    batch = max(1, args.batch_size)
    played = 0
    t_wall = _time.perf_counter()
    for s in range(0, len(fc), batch):
        part = fc.take(np.arange(s, min(s + batch, len(fc))))
        if args.rate > 0 and s > 0:
            # sleep for the data time since the PREVIOUS batch's start so
            # the gaps telescope to the full data span at 1/rate speed
            gap_s = (int(t[s]) - int(t[s - batch])) / 1000.0 / args.rate
            _time.sleep(min(max(gap_s, 0.0), 5.0))
        cache.upsert(part.to_rows())
        played += len(part)
        print(f"played {played}/{len(fc)} (cache size {len(cache)})")
    print(f"playback done in {_time.perf_counter() - t_wall:.1f}s")
    return 0


def cmd_tile(args) -> int:
    """Render one slippy-map tile from a loaded catalog to a file
    (docs/tiles.md) — the offline twin of the serving tier's
    `GET /tiles/<type>/<kind>/{z}/{x}/{y}`: same pyramid, same
    deterministic PNG bytes. `--fresh` uses the from-scratch oracle
    instead of the precomposed path (a bit-identity spot check)."""
    from geomesa_tpu_torch.tiles import KINDS, TilePyramid, render

    ds = _load(args)
    if args.kind not in KINDS:
        print(f"unknown kind {args.kind!r}; one of {KINDS}", file=sys.stderr)
        return 1
    pyramid = TilePyramid(ds)
    try:
        fetch = pyramid.fresh if args.fresh else pyramid.fetch
        g = fetch(args.feature_name, args.z, args.x, args.y)
    except KeyError:
        print(f"unknown type {args.feature_name!r}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    out = args.output or f"{args.feature_name}_{args.z}_{args.x}_{args.y}.png"
    with open(out, "wb") as f:
        f.write(render(args.kind, g.grid))
    print(
        f"wrote {out}: tile {args.z}/{args.x}/{args.y} "
        f"({args.kind}, {int(g.count)} features, generation tick {g.tick})"
    )
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="geomesa-tpu-torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    def add(name, fn, *, catalog=True, feature=False):
        sp = sub.add_parser(name)
        sp.set_defaults(fn=fn)
        if catalog:
            sp.add_argument("-c", "--catalog", required=True, help="store directory")
        if feature:
            sp.add_argument("-f", "--feature-name", required=True)
        sp.add_argument(
            "--device", default="cuda",
            help="torch device the store loads onto (default cuda; "
            "cpu takes each kernel's plain version)",
        )
        return sp

    add("version", cmd_version, catalog=False)
    add("env", cmd_env, catalog=False)

    sp = add("create-schema", cmd_create_schema, feature=True)
    sp.add_argument("-s", "--spec", required=True)

    add("get-type-names", cmd_get_type_names)
    add("describe-schema", cmd_describe_schema, feature=True)
    add("delete-schema", cmd_delete_schema, feature=True)

    sp = add("ingest", cmd_ingest, feature=True)
    how = sp.add_mutually_exclusive_group(required=True)
    how.add_argument("--converter", help="converter config (json)")
    how.add_argument("--infer", action="store_true", help="infer schema from csv")
    how.add_argument(
        "--file-format", choices=("parquet", "orc", "shp", "geojson", "arrow"),
        help="ingest self-describing files directly (schema from the file; "
        "reference geomesa-convert-parquet / -shp / -json)",
    )
    sp.add_argument("--header", action="store_true", help="first row is a header")
    sp.add_argument(
        "--workers", type=int, default=0,
        help="parallel converter processes (0 = in-process; reference "
        "distributed MapReduce ingest)",
    )
    sp.add_argument(
        "--no-pipeline", action="store_true",
        help="with --workers > 1: use the sequential-commit loader "
        "(per-split incremental visibility) instead of the staged "
        "bulk-load pipeline (docs/ingest.md)",
    )
    sp.add_argument("files", nargs="+")

    sp = add("convert", cmd_convert, catalog=False)
    sp.add_argument("-s", "--spec", required=True, help="SFT spec string")
    sp.add_argument("--converter", required=True, help="converter config (json)")
    sp.add_argument("--format", default="csv", help="output format")
    sp.add_argument("-o", "--output")
    sp.add_argument("files", nargs="+")

    sp = add("export", cmd_export, feature=True)
    sp.add_argument("-q", "--cql")
    sp.add_argument("--format", default="csv")
    sp.add_argument("-o", "--output")
    sp.add_argument("-m", "--max-features", type=int)
    sp.add_argument(
        "--reproject", help="output CRS (e.g. EPSG:3857); store is EPSG:4326"
    )

    sp = add("explain", cmd_explain, feature=True)
    sp.add_argument("-q", "--cql", required=True)

    sp = add("sql", cmd_sql)
    sp.add_argument("query", help="SELECT ... FROM <type> [WHERE st_...]")
    sp.add_argument("--format", default="csv")
    sp.add_argument("-o", "--output")

    sp = add("stats", cmd_stats, feature=True)
    sp.add_argument("--spec", default="Count()")
    sp.add_argument("-q", "--cql")

    sp = add("count", cmd_count, feature=True)
    sp.add_argument("-q", "--cql")

    add("stats-analyze", cmd_stats_analyze, feature=True)

    sp = add("ops", cmd_ops)
    sp.add_argument("--json", action="store_true", help="machine-readable output")
    sp.add_argument(
        "--slow", type=int, default=10,
        help="slow-query captures to include (default 10)",
    )

    sp = add("tune", cmd_tune)
    sp.add_argument("--json", action="store_true", help="machine-readable output")
    sp.add_argument(
        "--state", default=None, metavar="PATH",
        help="tuning state file to report from (default "
        "<catalog>/_tuning.json when present)",
    )

    sp = add("serve", cmd_serve)
    sp.add_argument("-f", "--feature-name", help="replica type name")
    sp.add_argument("--port", type=int, default=8080)
    sp.add_argument("--host", default=None, help="bind address (knob default)")
    sp.add_argument(
        "--replica-of", default=None, metavar="WAL_DIR",
        help="serve as a read replica tailing this leader WAL directory",
    )
    sp.add_argument(
        "--replica-wal", default=None,
        help="replica-local WAL copy dir (default <catalog>/_replica_wal)",
    )
    sp.add_argument(
        "--leader-url", default=None,
        help="advertised on 403 replica writes (X-Geomesa-Leader)",
    )
    sp.add_argument(
        "--tail-interval", type=float, default=1.0,
        help="seconds between replica disk-tail passes",
    )

    sp = add("playback", cmd_playback, feature=True)
    sp.add_argument("-q", "--cql")
    sp.add_argument(
        "--rate", type=float, default=0.0,
        help="data-time speedup factor (0 = as fast as possible)",
    )
    sp.add_argument("--batch-size", type=int, default=1000)

    sp = add("tile", cmd_tile, feature=True)
    sp.add_argument("z", type=int, help="zoom (0..geomesa.tiles.leaf.zoom)")
    sp.add_argument("x", type=int)
    sp.add_argument("y", type=int)
    sp.add_argument(
        "--kind", default="density", help="density | count | heat"
    )
    sp.add_argument("-o", "--output", help="PNG path (default <t>_z_x_y.png)")
    sp.add_argument(
        "--fresh", action="store_true",
        help="from-scratch oracle instead of the precomposed pyramid",
    )

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
