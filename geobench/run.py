"""Run one cell of the benchmark once.

    python3 geobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(also ``python3 -m geobench ...``), from the root of a checkout that holds
``BENCHMARK.json``, this folder and ``geomesa_tpu_torch``. The cell names a
configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); a per-layer metric is read by
``metrics/<name>.py``. A run:

1. set-up (``setup_s``, from the process's start): the configuration's
   rows from the seed, bulk-loaded into a ``DataStore`` on the card; each
   client's warm-up requests (a stream of their own) through the cell's
   path, which also builds the kernels in a fresh checkout;
2. the window: the traffic's closed-loop clients for ``--seconds``; with
   ``--trace 1`` the store's phase clock, the launch recorder and the
   profiler are armed over it;
3. the store's peak device memory is read and the store freed; then every
   answer (``check``) is held against the plain reference on the card;
4. the last line of standard output is the result; the numbers compared
   and their limits are also the last lines of standard error.

It exits non-zero, with no result, where there is no CUDA card or fewer
than the cell asks for, and where the process holds jax, jaxlib, flax or
the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from geobench import check, clients, gen  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "geomesa_tpu")
# fixed cache directories inside the checkout (gitignored)
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton"}


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(config: str, traffic: str, root: str = ROOT) -> dict:
    """A configuration and a traffic mix, found by name."""
    bench = os.path.join(root, "geobench")
    return {"config": load_json(os.path.join(bench, "configs", f"{config}.json")),
            "traffic": load_json(os.path.join(bench, "traffic", f"{traffic}.json"))}


def load_cell(workload: str, root: str = ROOT) -> dict:
    """The cell's manifest entry with its configuration, traffic mix and
    the metrics it reports, each found by name."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the manifest has {sorted(cells)}")
    cell = cells[workload]

    def reported(m):
        return "workloads" not in m or workload in m["workloads"]

    return {
        "cell": cell,
        **load_spec(cell["config"], cell["traffic"], root),
        "end_to_end": [m for m in manifest["end_to_end"] if reported(m)],
        "per_layer": [m for m in manifest["per_layer"] if reported(m)],
    }


def metric_reader(name: str, root: str = ROOT):
    path = os.path.join(root, "geobench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"geobench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def leaked_modules() -> list:
    """Forbidden top-level module names this process holds, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def build_store(cfg: dict, cols: dict, device):
    """A DataStore with the configuration's schema, bulk-loaded from the
    seeded columns through the program's BulkLoader."""
    import numpy as np

    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType
    from geomesa_tpu_torch.ingest import BulkLoader, PipelineConfig
    from geomesa_tpu_torch.metrics import MetricsRegistry

    sft = FeatureType.from_spec(cfg["type_name"], cfg["spec"])
    sft.user_data["geomesa.indices.enabled"] = cfg["index"]
    ds = DataStore(device=device, metrics=MetricsRegistry())
    ds.create_schema(sft)
    ing = cfg["ingest"]
    loader = BulkLoader(ds, cfg["type_name"], check_ids=False,
                        config=PipelineConfig(workers=int(ing["workers"])))
    step = int(ing["chunk_rows"])
    for s in range(0, cols["n"], step):
        e = min(cols["n"], s + step)
        c = {name: v[s:e] for name, v in cols["attrs"].items()}
        c[cfg["geom"]] = (cols["x"][s:e], cols["y"][s:e])
        if cfg.get("dtg"):
            c[cfg["dtg"]] = cols["t"][s:e]
        loader.put(FeatureCollection.from_columns(sft, np.arange(s, e), c))
    written = loader.close().written
    if written != cols["n"]:
        raise RuntimeError(f"the bulk load wrote {written} of {cols['n']} rows")
    return ds


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_process: float | None = None) -> dict:
    """One run of a cell; returns the result's fields and ``judged``."""
    import torch

    from geobench import devtrace, recorders

    t_process = time.perf_counter() if t_process is None else t_process
    cfg, traffic = spec["config"], spec["traffic"]
    cuda = torch.device(device).type == "cuda"
    marks = {"start": time.perf_counter() - t_process}
    cols = gen.make_columns(cfg, seed)
    marks["made"] = time.perf_counter() - t_process
    ds = build_store(cfg, cols, device)
    marks["loaded"] = time.perf_counter() - t_process
    n_clients = int(traffic["clients"])
    warm = [gen.stream(traffic, cfg, seed, c, cols["centres"], warmup=True)
            for c in range(n_clients)]
    keep = clients.sampler(traffic, seed)
    clients.run(ds, cfg, traffic, warm, keep, n=int(traffic["warmup_requests"]))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_process
    marks["warm"] = setup_s

    streams = [gen.stream(traffic, cfg, seed, c, cols["centres"]) for c in range(n_clients)]
    ctx: dict = {}
    prof = launches_cm = None
    if trace:
        ds.clock = recorders.shared_phase_clock()
        serving0 = recorders.serving_marks(ds.metrics)
        launches_cm = recorders.launch_recorder()
        ctx["launches"] = launches_cm.__enter__()
        prof = devtrace.start()
    t_start = time.perf_counter()
    stop = t_start + seconds
    try:
        records = clients.run(ds, cfg, traffic, streams, keep, stop=stop)
        if cuda:
            torch.cuda.synchronize()
    finally:
        t_end = time.perf_counter()
        if prof is not None:
            prof.stop()
        if launches_cm is not None:
            launches_cm.__exit__(None, None, None)
    if trace:
        ctx["phase_s"] = ds.clock.settle()
        ctx["serving"] = recorders.serving_delta(serving0, recorders.serving_marks(ds.metrics))
        reduced = devtrace.reduce(prof)
        reduced["window_s"] = t_end - t_start
        ctx["trace"] = reduced
        del prof
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ds.close()
    del ds
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    done = [r for r in records if r.error is None and r.t1 <= stop]
    ctx["latencies_s"] = [r.t1 - r.t0 for r in records if r.error is None]
    ctx["n_queries"] = len(records)
    ctx["window_s"] = seconds
    t_ref = time.perf_counter()
    rows = check.rows_of(cols, device)
    judged = check.judge([(r.req, r.answer, r.error, r.features) for r in records],
                         rows, cols, cfg)
    del rows
    marks["window_end"] = t_end - t_process
    marks["answer_rows"] = sum(r.answer[0] for r in records if r.answer is not None)
    marks["reference_s"] = time.perf_counter() - t_ref
    per_s = [0] * max(1, int(seconds + 0.999))
    for r in done:
        per_s[min(len(per_s) - 1, int(r.t1 - t_start))] += 1
    e2e = {"setup_s": setup_s, "query_rate": len(done) / seconds}
    return {
        "ctx": ctx, "judged": judged, "end_to_end": e2e, "peak": peak,
        "attempted": len(records),
        "failed": sum(r.error is not None for r in records),
        "marks": marks, "per_s": per_s,
    }


def result_line(spec: dict, out: dict, trace: bool, device_info: dict) -> dict:
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            v = metric_reader(m["name"])(out["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
    line = {
        "correct": check.verdict(out["judged"]),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": device_info,
    }
    if trace:
        t = out["ctx"]["trace"]
        line["device"] = {**device_info, "busy_s": t["busy_s"], "window_s": t["window_s"]}
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["checks"] = out["judged"]["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    for var, sub in CACHE_ENV.items():
        os.environ[var] = os.path.join(ROOT, ".cache", "geobench", sub)

    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"geobench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    leaked = leaked_modules()
    if leaked:
        print(f"geobench: the process holds {leaked} after the window", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                   "memory_peak_bytes": int(out["peak"])}
    line = result_line(spec, out, bool(args.trace), device_info)
    sys.stdout.flush()
    print("geobench: seconds from the start: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["marks"].items()), file=sys.stderr)
    print(f"geobench: answers per second of the window: {out['per_s']}", file=sys.stderr)
    print(f"geobench: {out['judged']['compared']} answers compared", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
