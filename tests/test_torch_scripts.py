"""The measurement drivers of geomesa_tpu_torch/scripts/ against the
reference's scripts/, on the CPU.

- ``validate_1b``: the reference runs as a subprocess
  (``JAX_PLATFORMS=cpu GEOMESA_1B_N=200000``); its JSON line and the
  per-query counts it logs to stderr equal the port's ``run(200_000,
  device="cpu")``: the 12 counts, the post-append count,
  ``queries_exact`` and ``device_bytes_per_row``.
- ``run_pod_scale``: the reference runs as a subprocess with ``--ci
  --rows 100000 --chunk 3000000`` on 8 virtual CPU devices, the port's
  ``main`` with the same arguments on ``["cpu"] * 8``. The chunk is
  raised from its 500,000 so the reference's own ``--ci`` span check (at
  least 10 spans a column) holds at 100,000 rows: the delta becomes
  600,000 rows, the compacted table 700,000, 11 spans of 65,536. Both
  exit 0 and take the fused dispatch; the fused leg's and the
  compaction's exactness and layout are equal; the rows' keys are equal
  outside the provenance stamp; the per-probe counts are equal because
  both rows are exact against one truth (the two drivers' probes,
  chunks and brute force are held equal). A wrong truth (a monkeypatched
  ``_brute_counts``) makes the port exit 1, and a run without ``--out``
  leaves the repo's SCALE_1B.json byte for byte as it was.
- The XZ2 probes, ``probe_density_many`` and ``profile_join``: each
  driver's generator equals the reference's draw; the same arrays go
  through the JAX package's ``DataStore`` (and ``spatial_join_indexed``)
  at 50,000 rows (8 polygons for the join): ids in order, counts,
  density grids and join pairs equal the port's.
- ``probe_link``, ``probe_floor`` and ``probe_async_pull``: each
  record has its keys and the scan counts equal numpy's.
- One ``gpu``-marked test per driver runs it on the card at a small
  size; they skip here. This file imports jax only inside the CPU
  tests, so the card's pytest (``--noconftest``, no jax) collects it.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from geomesa_tpu_torch.scripts import (probe_async_pull, probe_density_many, probe_floor,
                                       probe_link, probe_xz2_50m, probe_xz2_pipeline,
                                       probe_xz2_stage, profile_join, run_pod_scale,
                                       validate_1b)

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
N_1B = 200_000
N_SMALL = 50_000
N_POLY = 8
POD_ARGS = ["--ci", "--rows", "100000", "--chunk", "3000000"]
REF_TIMEOUT_S = 300


def _ref_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **extra)
    return env


def _load_reference(name):
    """The reference's scripts/<name>.py, loaded by path (only modules
    that do no work at import)."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_native():
    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_native import ensure_jax_native

    ensure_jax_native()


# -- validate_1b ---------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_1b():
    out = subprocess.run([sys.executable, "scripts/validate_1b.py"], cwd=ROOT,
                         env=_ref_env(GEOMESA_1B_N=str(N_1B)), capture_output=True, text=True,
                         timeout=REF_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    counts = [int(c.replace(",", "")) for c in
              re.findall(r"query \d+: ([\d,]+) hits", out.stderr)]
    post = int(re.search(r"post-append query ([\d,]+) hits", out.stderr).group(1)
               .replace(",", ""))
    return rec, counts, post


@pytest.fixture(scope="module")
def port_1b():
    return validate_1b.run(N_1B, device="cpu")


def test_validate_1b_counts_equal_the_reference(ref_1b, port_1b):
    rec, counts, post = ref_1b
    assert len(counts) == 12 and sum(counts) > 0
    assert port_1b["query_counts"] == counts
    assert port_1b["post_append_count"] == post
    assert port_1b["queries_exact"] == rec["queries_exact"] == 12
    assert port_1b["post_append_exact"] is rec["post_append_exact"] is True


def test_validate_1b_layout_equals_the_reference(ref_1b, port_1b):
    rec = ref_1b[0]
    assert port_1b["device_bytes_per_row"] == rec["device_bytes_per_row"]
    assert port_1b["device_gb"] == rec["device_gb"]
    assert port_1b["n_rows"] == rec["n_rows"] == N_1B


def test_validate_1b_record_has_the_reference_keys(ref_1b, port_1b):
    # the TPU's figures give way to the card's: hbm_budget_gb (the v5e's
    # 16 GB) to device_memory_gb, backend to device
    mapped = {"hbm_budget_gb": "device_memory_gb", "backend": "device"}
    assert {mapped.get(k, k) for k in ref_1b[0]} <= set(port_1b)
    assert port_1b["device"] == "cpu" and port_1b["device_memory_gb"] is None
    assert port_1b["reduced"] and port_1b["peak_host_rss_gb"] > 0


def test_validate_1b_truth_tests_points_in_f64_as_both_stores_do(jax_native):
    # the point validate_1b found at 10^8 rows on the card: query 9's
    # y1 = 65.0537 and a point at float32(65.0537), 3.3e-6 past it in f64
    from geomesa_tpu.datastore import DataStore as JDataStore
    from geomesa_tpu.features import FeatureCollection as JFC
    from geomesa_tpu.sft import FeatureType as JFT

    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType

    q = (47.8865, 45.0537, 87.8865, 65.0537, 1704573281842, 1705178081842)
    x = np.array([60.401093, 60.0, 60.0], np.float32)
    y = np.array([65.0537, 50.0, 65.0536], np.float32)
    t = np.full(3, 1705018494680, np.int64)
    assert int((y <= q[3]).sum()) == 3  # an f32 comparison (the reference's) counts it
    assert validate_1b.truth_count_ids(x, y, t, q) == (2, [1, 2])
    got = []
    for ds, fc, ft in ((DataStore(device="cpu"), FeatureCollection, FeatureType),
                       (JDataStore(), JFC, JFT)):
        sft = ft.from_spec("gdelt", validate_1b.SPEC)
        sft.user_data["geomesa.indices.enabled"] = "z3"
        sft.user_data["geomesa.z3.packed-time"] = "true"
        ds.create_schema(sft)
        ds.write("gdelt", fc.from_columns(sft, np.arange(3), {"dtg": t, "geom": (x, y)}),
                 check_ids=False)
        got.append(sorted(np.asarray(ds.query("gdelt", validate_1b.expr_of(q)).ids).tolist()))
    assert got == [[1, 2], [1, 2]]


def test_validate_1b_main_fails_on_an_inexact_answer(monkeypatch, capsys):
    monkeypatch.setattr(validate_1b, "truth_count_ids", lambda x, y, t, q, sample_cap=50: (-1, []))
    assert validate_1b.main(["--rows", "20000", "--device", "cpu"]) == 1
    assert "inexact" in capsys.readouterr().err


# -- run_pod_scale -------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_pod(tmp_path_factory):
    out_path = tmp_path_factory.mktemp("ref_pod") / "scale.json"
    out = subprocess.run(
        [sys.executable, "scripts/run_pod_scale.py", *POD_ARGS, "--out", str(out_path)],
        cwd=ROOT, env=_ref_env(XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        capture_output=True, text=True, timeout=REF_TIMEOUT_S)
    return out.returncode, json.loads(out_path.read_text())["rows"][-1], out.stderr


@pytest.fixture(scope="module")
def port_pod(tmp_path_factory):
    out_path = tmp_path_factory.mktemp("port_pod") / "scale.json"
    rc = run_pod_scale.main([*POD_ARGS, "--device", "cpu", "--out", str(out_path)])
    return rc, json.loads(out_path.read_text())["rows"][-1]


def _keys(obj, skip=("provenance",)) -> set:
    """Every key path of a nested dict, outside ``skip``."""
    out = set()
    for k, v in obj.items():
        if k in skip:
            out.add(k)
            continue
        out.add(k)
        if isinstance(v, dict):
            out |= {f"{k}.{s}" for s in _keys(v, skip)}
    return out


def test_pod_scale_both_exit_zero_and_take_the_fused_dispatch(ref_pod, port_pod):
    assert ref_pod[0] == 0, ref_pod[2][-3000:]
    assert port_pod[0] == 0
    for row in (ref_pod[1], port_pod[1]):
        assert row["fused_join"]["shard_legs"] >= 1
        assert row["ci_failures"] == []


def test_pod_scale_exactness_equals_the_reference(ref_pod, port_pod):
    ref, port = ref_pod[1], port_pod[1]
    for section in ("queries", "fused_join", "compaction"):
        assert port[section]["exact"] is ref[section]["exact"] is True
    assert port["queries"]["n"] == ref["queries"]["n"] == 12
    assert port["fused_join"]["members"] == ref["fused_join"]["members"] == 10
    for key in ("streamed", "span_rows", "delta_rows", "spans_per_column"):
        assert port["compaction"][key] == ref["compaction"][key], key
    for key in ("scenario", "n_rows", "hosts", "devices_per_host", "pod_driver"):
        assert port[key] == ref[key], key


def test_pod_scale_rows_have_the_same_keys(ref_pod, port_pod):
    assert _keys(port_pod[1]) == _keys(ref_pod[1])
    stamp = port_pod[1]["provenance"]
    assert stamp["platform"] == "cpu" and stamp["mesh_devices"] == 8
    assert stamp["driver"] == "geomesa_tpu_torch/scripts/run_pod_scale.py"


def test_pod_scale_counts_rest_on_the_reference_truth():
    ref = _load_reference("run_pod_scale")
    assert run_pod_scale._probes() == ref._probes()
    for ci, k in ((0, 1000), (3, 777), (run_pod_scale.DELTA_CHUNK_SEED, 500)):
        for a, b in zip(run_pod_scale._chunk_cols(ci, k), ref._chunk_cols(ci, k)):
            assert np.array_equal(a, b)
    boxes = run_pod_scale._probes()
    assert run_pod_scale._brute_counts(100_000, 30_000, boxes) == \
        ref._brute_counts(100_000, 30_000, boxes)
    assert [run_pod_scale._filter(b, True) for b in boxes] == [ref._filter(b, True) for b in boxes]


def test_pod_scale_exits_one_on_a_wrong_count_and_leaves_scale_1b(monkeypatch, capsys):
    scale = os.path.join(ROOT, "SCALE_1B.json")
    before = open(scale, "rb").read()
    real = run_pod_scale._brute_counts
    monkeypatch.setattr(run_pod_scale, "_brute_counts",
                        lambda n, chunk, boxes: [c + 1 for c in real(n, chunk, boxes)])
    assert run_pod_scale.main([*POD_ARGS, "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "CI FAIL: query counts" in err
    assert open(scale, "rb").read() == before


def test_pod_scale_refuses_the_reference_scale_file(tmp_path):
    with pytest.raises(ValueError, match="SCALE_1B.json"):
        run_pod_scale.write_row(os.path.join(ROOT, "SCALE_1B.json"), {"n_rows": 1})
    out = tmp_path / "rows.json"
    run_pod_scale.write_row(str(out), {"n_rows": 1})
    run_pod_scale.write_row(str(out), {"n_rows": 2})
    assert json.loads(out.read_text()) == {"rows": [{"n_rows": 1}, {"n_rows": 2}]}


# -- the XZ2 probes ------------------------------------------------------------


def _reference_footprints(n):
    """The reference XZ2 probes' module-level draw, verbatim."""
    rng = np.random.default_rng(62)
    cx = rng.uniform(-160, 160, 256); cy = rng.uniform(-55, 65, 256)  # noqa: E702
    which = rng.integers(0, 256, n)
    x0 = np.clip(cx[which] + rng.normal(0, 0.5, n), -179.9, 179.8)
    y0 = np.clip(cy[which] + rng.normal(0, 0.4, n), -89.9, 89.8)
    w = rng.uniform(0.0002, 0.002, n); h = rng.uniform(0.0002, 0.002, n)  # noqa: E702
    return cx, cy, (x0, y0, x0 + w, y0 + h)


def _reference_mk(cx, cy, seed, k):
    r = np.random.default_rng(seed); out = []  # noqa: E702
    for _ in range(k):
        c = r.integers(0, 256); qw = float(r.choice([0.02, 0.05, 0.1, 0.5, 2.0]))  # noqa: E702
        qx = cx[c]+r.uniform(-1, 1); qy = cy[c]+r.uniform(-0.8, 0.8)  # noqa: E702
        out.append((qw, f"INTERSECTS(geom, POLYGON(({qx:.4f} {qy:.4f}, {qx+qw:.4f} {qy:.4f}, "
                        f"{qx+qw:.4f} {qy+qw:.4f}, {qx:.4f} {qy+qw:.4f}, {qx:.4f} {qy:.4f})))"))
    return out


def test_xz2_generator_and_queries_equal_the_reference():
    (cx, cy), rects = probe_xz2_50m.footprints(N_SMALL)
    rcx, rcy, rrects = _reference_footprints(N_SMALL)
    assert np.array_equal(cx, rcx) and np.array_equal(cy, rcy)
    for a, b in zip(rects, rrects):
        assert np.array_equal(a, b)
    for seed in (1, 2):
        got = [(qw, q) for qw, q, _ in probe_xz2_50m.mk((cx, cy), seed, 40)]
        assert got == _reference_mk(cx, cy, seed, 40)


@pytest.fixture(scope="module")
def xz2_stores(jax_native):
    from geomesa_tpu import geometry as jgeo
    from geomesa_tpu.datastore import DataStore as JDataStore
    from geomesa_tpu.features import FeatureCollection as JFC
    from geomesa_tpu.sft import FeatureType as JFT

    centres, rects = probe_xz2_50m.footprints(N_SMALL)
    ds, _ = probe_xz2_50m.build_store(N_SMALL, torch.device("cpu"), rects)
    sft = JFT.from_spec("bld", probe_xz2_50m.SPEC)
    sft.user_data["geomesa.indices.enabled"] = "xz2"
    jds = JDataStore()
    jds.create_schema(sft)
    jds.write("bld", JFC.from_columns(sft, np.arange(N_SMALL),
                                      {"geom": jgeo.PackedGeometryColumn.from_boxes(*rects)}),
              check_ids=False)
    yield centres, rects, ds, jds
    ds.close()


def test_xz2_query_ids_equal_the_jax_store_in_order(xz2_stores):
    centres, rects, ds, jds = xz2_stores
    qs = probe_xz2_50m.mk(centres, 2, 40)
    hits = 0
    for _, q, box in qs:
        got = np.asarray(ds.query("bld", q).ids, np.int64)
        want = np.asarray(jds.query("bld", q).ids, np.int64)
        assert np.array_equal(got, want), q
        assert np.array_equal(np.sort(got), probe_xz2_50m.brute_ids(rects, box))
        hits += len(got)
    assert hits > 0


def test_xz2_query_many_ids_equal_the_jax_store(xz2_stores):
    centres, _, ds, jds = xz2_stores
    qs = [q for _, q, _ in probe_xz2_50m.mk(centres, 2, 40)]
    got = ds.query_many("bld", qs)
    want = jds.query_many("bld", qs)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a.ids, np.int64), np.asarray(b.ids, np.int64))


def test_probe_xz2_50m_run_equals_the_jax_store(xz2_stores):
    centres, _, _, jds = xz2_stores
    rec = probe_xz2_50m.run(N_SMALL, "cpu")
    want = [len(jds.query("bld", q)) for _, q, _ in probe_xz2_50m.mk(centres, 2, 40)]
    assert rec["query_hits"] == want and rec["hits"] == sum(want)
    assert rec["checked_vs_brute_force"] == 40 and len(rec["slowest"]) == 12
    assert rec["reduced"] and rec["device"] == "cpu"


def test_probe_xz2_pipeline_run_equals_the_jax_store(xz2_stores):
    centres, _, _, jds = xz2_stores
    rec = probe_xz2_pipeline.run(N_SMALL, "cpu")
    want = [len(r) for r in jds.query_many("bld", [q for _, q, _ in
                                                   probe_xz2_50m.mk(centres, 2, 40)])]
    assert rec["query_hits"] == want and rec["same_ids"]
    for key in ("geometry_s", "keys_s", "sort_s", "upload_s", "other_s", "write_s"):
        assert rec[key] >= 0, key
    assert rec["keys_s"] > 0 and rec["sort_s"] > 0 and rec["upload_s"] > 0


def test_probe_xz2_stage_run_equals_the_jax_store(xz2_stores):
    centres, _, _, jds = xz2_stores
    rec = probe_xz2_stage.run(N_SMALL, "cpu")
    qs = _reference_mk(*centres, 2, 40)
    qw, q = max(qs, key=lambda t: t[0])
    assert rec["query"] == q and rec["width"] == qw == 2.0
    assert rec["hits"] == len(jds.query("bld", q)) > 0
    assert rec["explain"] and len(rec["profile"]) == probe_xz2_stage.TOP


# -- probe_density_many --------------------------------------------------------


def test_density_points_equal_the_reference_draw():
    n = 1000
    rng = np.random.default_rng(3)
    t0 = np.datetime64("2024-01-01", "ms").astype(np.int64)
    want = (t0 + rng.integers(0, 10**9, n), rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))
    for a, b in zip(probe_density_many.make_points(n), want):
        assert np.array_equal(a, b)


def test_density_many_grids_equal_the_jax_store(jax_native):
    from geomesa_tpu.datastore import DataStore as JDataStore
    from geomesa_tpu.features import FeatureCollection as JFC
    from geomesa_tpu.sft import FeatureType as JFT

    t, x, y = probe_density_many.make_points(N_SMALL)
    sft = JFT.from_spec("d", probe_density_many.SPEC)
    jds = JDataStore()
    jds.create_schema(sft)
    jds.write("d", JFC.from_columns(sft, np.arange(N_SMALL), {"dtg": t, "geom": (x, y)}),
              check_ids=False)
    reqs = probe_density_many.frame_requests()
    ds = probe_density_many.build_store(N_SMALL, torch.device("cpu"))
    got = ds.density_many("d", reqs)
    want = jds.density_many("d", reqs)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    ds.close()
    rec = probe_density_many.run(N_SMALL, "cpu")
    assert rec["tile_sums"] == [int(np.asarray(g).sum()) for g in want]
    assert rec["grids_equal"] and rec["tiles"] == 32 and abs(rec["total"] - N_SMALL) < 200


# -- profile_join --------------------------------------------------------------


def test_join_points_equal_the_reference_draw():
    ref = _load_reference("profile_join")
    for a, b in zip(profile_join.gdelt_points(5000, np.random.default_rng(72)),
                    ref.gdelt_points(5000, np.random.default_rng(72))):
        assert np.array_equal(a, b)


def test_join_pairs_equal_the_jax_join(jax_native):
    from geomesa_tpu import geometry as jgeo
    from geomesa_tpu.datastore import DataStore as JDataStore
    from geomesa_tpu.features import FeatureCollection as JFC
    from geomesa_tpu.sft import FeatureType as JFT
    from geomesa_tpu.sql.join import spatial_join_indexed as jjoin

    x, y, boxes = profile_join.make_inputs(N_SMALL, N_POLY)
    psft = JFT.from_spec("pts", "*geom:Point:srid=4326")
    psft.user_data["geomesa.indices.enabled"] = "z2"
    gsft = JFT.from_spec("adm", "*geom:Polygon:srid=4326")
    polys = JFC.from_columns(gsft, np.arange(N_POLY),
                             {"geom": jgeo.PackedGeometryColumn.from_boxes(*boxes)})
    jds = JDataStore()
    jds.create_schema(psft)
    jds.write("pts", JFC.from_columns(psft, np.arange(N_SMALL), {"geom": (x, y)}),
              check_ids=False)
    jl, jr = jjoin(jds, "pts", polys, "contains")
    bl, br = profile_join.brute_pairs(x, y, boxes, np.arange(N_POLY))
    assert np.array_equal(jl, bl) and np.array_equal(jr, br) and len(jl) > 0
    rec = profile_join.run(N_SMALL, N_POLY, "cpu")
    assert rec["pairs"] == len(jl) and rec["checked_polygons"] == N_POLY
    for trial in rec["trials"]:
        assert trial["pairs"] == len(jl)
        for key in ("scan_config_ms", "submit_ms", "pull_decode_ms", "refine_ms", "concat_ms"):
            assert trial[key] >= 0, key


# -- the link probes -----------------------------------------------------------


def test_probe_link_counts_equal_numpy():
    n = 8 * probe_link.TILE * 4
    rec = probe_link.run(n, "cpu")
    host, _ = probe_link.make_table(n, "cpu")
    mask = probe_link.numpy_mask(host, probe_link.BOXES, probe_link.WINDOWS)
    assert rec["count_scan"]["count"] == int(mask.sum()) > 0
    rows = (np.arange(n // probe_link.TILE // 8)[:, None] * 8 * probe_link.TILE
            + np.arange(probe_link.TILE)).ravel()
    assert rec["gather_scan"]["count"] == int(mask[rows].sum())
    for key in ("rtt_ms", "d2h", "h2d", "table_gb", "count_scan", "scan_compact", "end_to_end",
                "gather_scan", "route", "reduced"):
        assert key in rec, key
    assert [d["bytes"] for d in rec["d2h"]] == list(probe_link.D2H_BYTES)
    assert [d["bytes"] for d in rec["h2d"]] == list(probe_link.H2D_BYTES)
    assert rec["rtt_ms"] is None  # no device time off the card


def test_probe_link_compaction_equals_numpy():
    n = 8 * probe_link.TILE * 2
    host, cols = probe_link.make_table(n, "cpu")
    boxes = torch.from_numpy(probe_link.BOXES)
    windows = torch.from_numpy(probe_link.WINDOWS)
    hits = np.flatnonzero(probe_link.numpy_mask(host, probe_link.BOXES, probe_link.WINDOWS))
    c, idx = probe_link.scan_compact(cols, boxes, windows, cap=8)
    assert int(c) == len(hits) > 8
    assert np.array_equal(idx.numpy(), hits[:8])
    c, idx = probe_link.scan_compact(cols, boxes, windows, cap=len(hits) + 5)
    assert np.array_equal(idx.numpy(), np.concatenate([hits, np.full(5, -1)]))


def test_probe_floor_record_has_its_keys():
    rec = probe_floor.run("cpu")
    assert [p["floats"] for p in rec["pull"]] == list(probe_floor.SIZES)
    for key in ("asarray", "async_copy", "pinned_out", "overlap", "dispatch_only", "reduced"):
        assert key in rec, key
    assert rec["overlap"]["queries"] == 2 and rec["overlap"]["ms"] is None


def test_probe_async_pull_record_has_its_keys():
    rec = probe_async_pull.run("cpu")
    assert rec["launches"] == 40
    assert {"sync_ms", "dispatch_all_ms", "async_ms", "reduced"} <= set(rec)


@pytest.mark.parametrize("name", ["validate_1b", "run_pod_scale", "probe_link", "probe_floor",
                                  "probe_async_pull", "probe_density_many", "probe_xz2_50m",
                                  "probe_xz2_pipeline", "probe_xz2_stage", "profile_join"])
def test_each_driver_defaults_to_cuda_and_raises_without_it(name, monkeypatch):
    mod = importlib.import_module(f"geomesa_tpu_torch.scripts.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--ci"] if name == "run_pod_scale" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _launched(fn):
    from geomesa_tpu_torch.kernels import KERNELS

    for k in KERNELS:
        k.reset_counts()
    rec = fn()
    return rec, {k.name: k.launches for k in KERNELS}


@pytest.mark.gpu
def test_gpu_validate_1b(cuda):
    rec, launched = _launched(lambda: validate_1b.run(1_000_000, cuda))
    assert rec["queries_exact"] == 12 and rec["post_append_exact"]
    assert rec["device_memory_gb"] > 0 and launched["block_scan"] > 0


@pytest.mark.gpu
def test_gpu_run_pod_scale(cuda):
    argv = ["--ci", "--rows", "300000", "--chunk", "3000000"]
    rec, launched = _launched(lambda: run_pod_scale.run(run_pod_scale._parse_args(argv), argv))
    assert rec["ci_failures"] == [] and rec["provenance"]["platform"] == "cuda"
    assert launched["block_scan"] > 0 and launched["block_scan_multi"] > 0


@pytest.mark.gpu
def test_gpu_probe_link(cuda):
    rec = probe_link.run(1 << 20, cuda)
    assert rec["count_scan"]["count"] > 0 and rec["rtt_ms"] > 0


@pytest.mark.gpu
def test_gpu_probe_floor(cuda):
    rec = probe_floor.run(cuda)
    assert rec["overlap"]["ms"] > 0 and all(p["ms"] > 0 for p in rec["pull"])


@pytest.mark.gpu
def test_gpu_probe_async_pull(cuda):
    rec = probe_async_pull.run(cuda)
    assert rec["sync_ms"] > 0 and rec["async_ms"] > 0


@pytest.mark.gpu
def test_gpu_probe_density_many(cuda):
    rec, launched = _launched(lambda: probe_density_many.run(200_000, cuda))
    assert rec["grids_equal"] and launched["density"] > 0


@pytest.mark.gpu
def test_gpu_probe_xz2_50m(cuda):
    rec, launched = _launched(lambda: probe_xz2_50m.run(200_000, cuda))
    assert rec["checked_vs_brute_force"] == 40 and launched["block_scan"] > 0


@pytest.mark.gpu
def test_gpu_probe_xz2_pipeline(cuda):
    rec, launched = _launched(lambda: probe_xz2_pipeline.run(200_000, cuda))
    assert rec["same_ids"] and launched["block_scan_multi"] > 0


@pytest.mark.gpu
def test_gpu_probe_xz2_stage(cuda):
    rec = probe_xz2_stage.run(200_000, cuda)
    assert rec["hits"] > 0 and rec["checked_vs_brute_force"] == 1


@pytest.mark.gpu
def test_gpu_profile_join(cuda):
    rec, launched = _launched(lambda: profile_join.run(200_000, 16, cuda))
    assert rec["pairs"] > 0 and launched["block_scan"] > 0 and launched["block_scan_multi"] > 0
