"""The port's pipelined bulk loader and file ingest (ingest.pipeline,
ingest.splits, io.ingest) against the JAX package's, on the CPU.

Both packages load the same seeded chunks, sequentially (``write`` and
``compact``) and through ``BulkLoader`` at 1, 2 and 4 workers, on a point
schema with ``z3,z2`` and on an XZ2 polygon schema. Each load must equal
its own package's sequential store and the other package's: the sorted
keys, the permutation, the block layout, the device columns, the
features in order, the stats JSON, and query ids in order (also under a
limit), counts, density grids and bounds. The presorted permutation
reaches ``create_table(sorted_state=)``, the few-bins fallback and an
append to a non-empty store drop it, and the tables stay equal. Each of
the six ``ingest.*`` fault points aborts with the store untouched in both
packages (the parse in-process, as the reference's fault tests run it).
``ingest_files`` over seeded CSV splits with bad rows gives equal
``split_errors`` and ``error_reasons`` at 1 and 2 workers (2: a forked
pool, each call bounded by a timeout), and a failed split raises
``IngestError`` with its index and traceback.
Tolerance: exact. Mirrors tests/test_ingest_pipeline.py,
tests/test_ingest_parallel.py and the ingest cases of
tests/test_crash_recovery.py.
"""

import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu import fault as jfault
from geomesa_tpu import ingest as jingest
from geomesa_tpu.io import converters as jconv
from geomesa_tpu.io import ingest as jio_ingest
from geomesa_tpu.metrics import MetricsRegistry as JMetrics
from geomesa_tpu.storage import adapter as jadapter
from geomesa_tpu.storage import persist as jpersist
from geomesa_tpu_torch import fault as tfault
from geomesa_tpu_torch import ingest as tingest
from geomesa_tpu_torch.io import converters as tconv
from geomesa_tpu_torch.io import ingest as tio_ingest
from geomesa_tpu_torch.metrics import MetricsRegistry as TMetrics
from geomesa_tpu_torch.storage import adapter as tadapter
from geomesa_tpu_torch.storage import persist as tpersist
from test_torch_native import ensure_jax_native

torch.set_num_threads(1)

T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000
TILE = 4096
POINT_SPEC = "name:String,val:Double,dtg:Date,*geom:Point:srid=4326"
XZ2_SPEC = "name:String,val:Double,*geom:Polygon:srid=4326"

JAX = SimpleNamespace(
    name="jax", pkg=geomesa_tpu, fault=jfault, ingest=jingest, conv=jconv,
    io_ingest=jio_ingest, adapter=jadapter, persist=jpersist, Metrics=JMetrics, kw={},
)
PORT = SimpleNamespace(
    name="port", pkg=geomesa_tpu_torch, fault=tfault, ingest=tingest, conv=tconv,
    io_ingest=tio_ingest, adapter=tadapter, persist=tpersist, Metrics=TMetrics,
    kw={"device": "cpu"},
)
BOTH = (JAX, PORT)

QUERIES = (
    "bbox(geom, -10, -10, 10, 10)",
    "bbox(geom, -30, -20, 40, 30) AND name = 'n3'",
    "name = 'n3'",
    "INCLUDE",
)
DATED = ("bbox(geom, -30, -20, 40, 30) AND dtg DURING "
         "2024-01-03T00:00:00Z/2024-01-20T00:00:00Z",)


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    ensure_jax_native()


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.setenv("GEOMESA_TPU_IO_BACKOFF_S", "0.0001")
    yield
    jfault.injector().reset()
    tfault.injector().reset()


# ------------------------------------------------------------------ inputs


def _sft(P, kind):
    sft = P.pkg.FeatureType.from_spec("p", POINT_SPEC if kind == "z3" else XZ2_SPEC)
    if kind == "z3":
        sft.user_data["geomesa.indices.enabled"] = "z3,z2"
    return sft


def _columns(P, kind, n, seed, day_lo=0, day_hi=40):
    rng = np.random.default_rng(seed)
    cols = {"name": np.array([f"n{i % 7}" for i in range(n)]), "val": rng.uniform(0, 1, n)}
    x, y = rng.uniform(-60, 60, n), rng.uniform(-45, 45, n)
    if kind == "z3":
        cols["dtg"] = T0 + rng.integers(day_lo * DAY, day_hi * DAY, n)
        cols["geom"] = (x, y)
    else:
        w, h = rng.uniform(0.01, 3.0, n), rng.uniform(0.01, 3.0, n)
        cols["geom"] = [P.pkg.geometry.box(a, b, a + c, b + d) for a, b, c, d in zip(x, y, w, h)]
    return cols


def _chunks(P, kind, sizes, seed=0, prefix="f", **kw):
    """One FeatureCollection per size (0 is an empty chunk), ids unique
    over the chunks and in chunk order."""
    sft, out, base = _sft(P, kind), [], 0
    for j, n in enumerate(sizes):
        ids = [f"{prefix}{base + i}" for i in range(n)]
        out.append(P.pkg.FeatureCollection.from_columns(sft, ids, _columns(P, kind, n, seed + j, **kw)))
        base += n
    return out


def _store(P, kind, **kw):
    ds = P.pkg.DataStore(tile=TILE, **P.kw, **kw)
    ds.create_schema(_sft(P, kind))
    return ds


def _seq(P, kind, chunks):
    ds = _store(P, kind)
    for fc in chunks:
        if len(fc):
            ds.write("p", fc)
    ds.compact("p")
    return ds


def _pipe(P, kind, chunks, workers, **cfg):
    ds = _store(P, kind)
    loader = P.ingest.BulkLoader(ds, "p", config=P.ingest.PipelineConfig(workers=workers, **cfg))
    for fc in chunks:
        loader.put(fc)
    res = loader.close()
    assert res.written == sum(len(c) for c in chunks)
    return ds


# ------------------------------------------------------------- fingerprint


def _col_state(col) -> list:
    if hasattr(col, "bboxes"):
        return [col.coords, col.ring_offsets, col.part_ring_offsets,
                col.geom_part_offsets, col.types, col.bboxes]
    if hasattr(col, "x"):
        return [col.x, col.y]
    return [np.asarray(col)]


def _tables(ds) -> dict:
    """Every index table's sorted keys, permutation, block layout and
    device columns (bench.py's ``_table_fingerprint`` reads the same)."""
    out = {}
    for (t, name), tab in sorted(ds._tables.items()):
        main = getattr(tab, "main", tab)
        out[f"{name}.layout"] = np.array([main.n, main.block, main.n_blocks])
        for k in ("perm", "bins", "zs"):
            out[f"{name}.{k}"] = np.asarray(getattr(main, k)).astype(np.int64)
        for k in main.col_names:
            out[f"{name}.cols3.{k}"] = np.asarray(main.cols3[k])
    stats = ds.stats_for("p")
    out["stats"] = json.dumps(stats.to_json(), default=str, sort_keys=True) if stats else None
    return out


def _answers(ds, kind) -> dict:
    fc = ds.features("p")
    out = {"ids": np.asarray(fc.ids).astype(str)}
    for name, col in fc.columns.items():
        for i, a in enumerate(_col_state(col)):
            out[f"col.{name}.{i}"] = np.asarray(a)
    env = (-60.0, -45.0, 60.0, 45.0)
    for i, q in enumerate(QUERIES + (DATED if kind == "z3" else ())):
        out[f"q{i}"] = np.asarray(ds.query("p", q).ids).astype(str)
        out[f"q{i}.limit"] = np.asarray(ds.query("p", q, limit=25).ids).astype(str)
        out[f"q{i}.count"] = ds.count("p", q)
        out[f"q{i}.density"] = np.asarray(ds.density("p", q, envelope=env, width=32, height=16))
        out[f"q{i}.bounds"] = ds.bounds("p", q)
    return out


def _assert_equal(a: dict, b: dict, what: str):
    assert sorted(a) == sorted(b), what
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype.kind == b[k].dtype.kind, (what, k)
            assert np.array_equal(a[k], b[k]), (what, k)
        else:
            assert a[k] == b[k], (what, k)


def _tie_free(state: dict) -> dict:
    """What does not depend on the order of rows with equal keys: XZ2
    keys tie, and a sequential load's compactions put appended rows
    ahead of old ones with an equal key, where the bulk load's one
    stable sort keeps chunk order (the JAX package's two paths differ
    the same way). The permutation, the columns in sorted order and
    ``limit`` answers go; query ids are compared as sorted lists."""
    out = {}
    for k, v in state.items():
        if k.endswith((".perm", ".limit")) or ".cols3." in k:
            continue
        out[k] = np.sort(v) if k.startswith("q") and isinstance(v, np.ndarray) and v.ndim == 1 else v
    return out


# ------------------------------------------------------------------ loads

# chunks below one block, chunks straddling several weekly bins, empty
# chunks (tests/test_ingest_pipeline.py's adversarial boundaries)
SIZES = [100, 0, 3000, 1, 0, 777, 2048, 5000, 17]


@pytest.mark.parametrize("kind", ["z3", "xz2"])
@pytest.mark.parametrize("workers", [1, 2, 4])
def test_bulk_loader_equals_sequential_and_the_jax_package(kind, workers):
    states = {}
    for P in BOTH:
        chunks = _chunks(P, kind, SIZES, seed=11)
        seq = _seq(P, kind, chunks)
        pipe = _pipe(P, kind, chunks, workers, chunk_rows=512, queue_depth=2)
        states[P.name] = _tables(pipe), _answers(pipe, kind)
        same = (lambda s: s) if kind == "z3" else _tie_free
        _assert_equal(same(_tables(seq)), same(states[P.name][0]), f"{P.name} tables, seq vs pipe")
        _assert_equal(same(_answers(seq, kind)), same(states[P.name][1]), f"{P.name} answers, seq vs pipe")
    _assert_equal(states["jax"][0], states["port"][0], "tables, jax vs port")
    _assert_equal(states["jax"][1], states["port"][1], "answers, jax vs port")


def _spy_sorted_state(P, monkeypatch) -> list:
    """Record each InProcessAdapter.create_table's sorted_state length."""
    seen = []
    orig = P.adapter.InProcessAdapter.create_table

    def spy(self, keyspace, keys, old=None, main_rows=0, sorted_state=None):
        seen.append((keyspace.name, None if sorted_state is None else len(sorted_state)))
        return orig(self, keyspace, keys, old=old, main_rows=main_rows, sorted_state=sorted_state)

    monkeypatch.setattr(P.adapter.InProcessAdapter, "create_table", spy)
    return seen


@pytest.mark.parametrize("case", ["merged", "few_bins", "forced_merge", "append"])
def test_presorted_perm_reaches_create_table_and_tables_stay_equal(case, monkeypatch):
    """``merged``: a load over many z3 bins hands z3 its merged perm and
    z2 (one bin) none; ``few_bins``: every row in one z3 bin, so neither
    index gets one (the whole-table sort runs); ``forced_merge``:
    ``merge_min_bins=1`` merges z2 as well; ``append``: a load into a
    non-empty store drops the perm and compacts as a write would."""
    seen_by, states = {}, {}
    for P in BOTH:
        kw = {"day_lo": 2, "day_hi": 3} if case == "few_bins" else {}
        chunks = _chunks(P, "z3", [900, 1100, 250, 800], seed=5, **kw)
        cfg = {"merge_min_bins": 1} if case == "forced_merge" else {}
        if case == "append":
            first = _chunks(P, "z3", [1500], seed=21, prefix="a")[0]
            seq = _store(P, "z3")
            for fc in [first] + chunks:
                seq.write("p", fc)
            seq.compact("p")
            pipe = _store(P, "z3")
            pipe.write("p", first)
        else:
            seq = _seq(P, "z3", chunks)
            pipe = _store(P, "z3")
        seen = _spy_sorted_state(P, monkeypatch)
        loader = P.ingest.BulkLoader(
            pipe, "p", config=P.ingest.PipelineConfig(workers=2, chunk_rows=300, **cfg),
        )
        for fc in chunks:
            loader.put(fc)
        loader.close()
        pipe.compact("p")
        seen_by[P.name] = sorted(seen)
        states[P.name] = _tables(pipe)
        _assert_equal(_tables(seq), states[P.name], f"{P.name}, seq vs pipe")
    n = 900 + 1100 + 250 + 800
    expect = {
        "merged": [("z2", None), ("z3", n)],
        "few_bins": [("z2", None), ("z3", None)],
        "forced_merge": [("z2", n), ("z3", n)],
        "append": [("z2", None), ("z3", None)],
    }[case]
    assert seen_by["jax"] == seen_by["port"] == expect
    _assert_equal(states["jax"], states["port"], "jax vs port")


def test_host_adapter_takes_the_sorted_state():
    """HostAdapter builds from the merged perm and answers as the
    sequential HostAdapter store does, in both packages."""
    out = {}
    for P in BOTH:
        chunks = _chunks(P, "z3", [1200, 700, 900], seed=3)
        answers = []
        for body in ("seq", "pipe"):
            ds = P.pkg.DataStore(adapter=P.adapter.HostAdapter(tile=TILE), **P.kw)
            ds.create_schema(_sft(P, "z3"))
            if body == "seq":
                for fc in chunks:
                    ds.write("p", fc)
                ds.compact("p")
            else:
                loader = P.ingest.BulkLoader(ds, "p", config=P.ingest.PipelineConfig(workers=2))
                for fc in chunks:
                    loader.put(fc)
                loader.close()
            answers.append({
                **{f"{n}.perm": np.asarray(ds._tables[("p", n)]._sk.perm).astype(np.int64)
                   for n in ("z3", "z2")},
                **{q: np.asarray(ds.query("p", q).ids).astype(str) for q in QUERIES + DATED},
            })
        _assert_equal(answers[0], answers[1], f"{P.name} host seq vs pipe")
        out[P.name] = answers[1]
    _assert_equal(out["jax"], out["port"], "jax vs port")


# ---------------------------------------------------------------- loader


def test_backpressure_metrics_and_stage_seconds():
    snaps = {}
    for P in BOTH:
        reg = P.Metrics()
        ds = _store(P, "z3", metrics=reg)
        loader = P.ingest.BulkLoader(ds, "p", config=P.ingest.PipelineConfig(workers=1, queue_depth=1))
        for fc in _chunks(P, "z3", [2000] * 6, seed=1):
            loader.put(fc)
        res = loader.close()
        snap = reg.snapshot()
        assert res.written == 12000 == ds.count("p")
        assert snap["counters"].get("geomesa.ingest.queue_full", 0) >= 1
        assert snap["gauges"]["geomesa.ingest.chunk_bytes_peak"] > 0
        assert set(res.stage_seconds) == {"parse", "keys", "sort", "commit", "finalize"}
        assert res.stage_seconds["keys"] > 0
        snaps[P.name] = (
            {k: v for k, v in snap["counters"].items()
             if k.startswith("geomesa.ingest.") and k != "geomesa.ingest.queue_full"},
            sorted(k for k in snap["timers"] if k.startswith("geomesa.ingest.")),
            {k: snap["timers"][k]["count"] for k in snap["timers"] if k.startswith("geomesa.ingest.")},
        )
    assert snaps["jax"] == snaps["port"]


@pytest.mark.parametrize("case", ["duplicate_ids", "put_after_close", "empty_close", "producers"])
def test_loader_edges_agree(case):
    out = {}
    for P in BOTH:
        ds = _store(P, "z3")
        sft = ds.get_schema("p")
        fc = lambda ids, seed: P.pkg.FeatureCollection.from_columns(  # noqa: E731
            sft, ids, _columns(P, "z3", len(ids), seed))
        loader = P.ingest.BulkLoader(ds, "p", config=P.ingest.PipelineConfig(workers=2))
        if case == "duplicate_ids":
            loader.put(fc([f"a{i}" for i in range(50)], 1))
            loader.put(fc([f"a{i}" for i in range(30)], 2))
            with pytest.raises(ValueError, match="duplicate feature ids"):
                loader.close()
            _assert_untouched(ds)
            out[P.name] = None
        elif case == "put_after_close":
            loader.close()
            with pytest.raises(RuntimeError, match="closed"):
                loader.put(fc(["q0"], 0))
            out[P.name] = None
        elif case == "empty_close":
            res = loader.close()
            out[P.name] = (res.written, ds.count("p"))
        else:
            # two producers put at once: ordinal ranges never overlap
            def producer(tag):
                for j in range(6):
                    loader.put(fc([f"{tag}{j}_{i}" for i in range(300)], j + (tag == "b") * 100))

            threads = [threading.Thread(target=producer, args=(t,)) for t in ("a", "b")]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            res = loader.close()
            ids = np.asarray(ds.query("p", "INCLUDE").ids).astype(str)
            assert res.written == 3600 == ds.count("p") == len(set(ids))
            out[P.name] = sorted(ids.tolist())
    assert out["jax"] == out["port"]


# ------------------------------------------------------------------ faults


def _assert_untouched(ds):
    assert ds.count("p") == 0
    assert ds._chunks["p"] == []
    assert ("p", "z3") not in ds._tables
    assert ds.stats_for("p") is None


def _bounded(fn, *args, timeout=180, **kw):
    """``fn(*args, **kw)`` on a thread of its own: its result, or what it
    raised. A call still running after ``timeout`` seconds fails the test
    rather than holding the whole run (a process pool forked from a test
    process that runs other threads can hang)."""
    box = {}

    def run():
        try:
            box["value"] = fn(*args, **kw)
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            box["error"] = e

    t = threading.Thread(target=run, name="bounded-ingest", daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        pytest.fail(f"{fn.__module__}.{fn.__qualname__} still running after {timeout} s")
    if "error" in box:
        raise box["error"]
    return box["value"]


def _write_csv(path, n, seed, bad=(), header=True, prefix=None):
    """``n`` seeded rows; the row numbers in ``bad`` get a value that
    does not parse."""
    rng = np.random.default_rng(seed)
    prefix = f"r{seed}_" if prefix is None else prefix
    lines = ["name,val,lon,lat,when\n"] if header else []
    for i in range(n):
        val = "NOT_A_NUMBER" if i in bad else f"{rng.uniform():.4f}"
        lines.append(
            f"{prefix}{i},{val},{rng.uniform(-60, 60):.4f},{rng.uniform(-45, 45):.4f},"
            f"2024-02-0{1 + i % 9}T00:00:00Z\n"
        )
    path.write_text("".join(lines))
    return str(path)


def _converter(P, id_field="$1", **kw):
    sft = P.pkg.FeatureType.from_spec("p", POINT_SPEC)
    return P.conv.Converter(
        sft=sft, fmt="delimited", skip_lines=1, id_field=id_field,
        fields=[
            P.conv.FieldSpec("name", "$1"),
            P.conv.FieldSpec("val", "$2::double"),
            P.conv.FieldSpec("geom", "point($3, $4)"),
            P.conv.FieldSpec("dtg", "datetime($5)"),
        ],
        **kw,
    )


@pytest.mark.parametrize("point", [
    "ingest.split.read", "ingest.parse", "ingest.keys", "ingest.sort",
    "ingest.commit", "ingest.finalize",
])
def test_each_fault_point_aborts_with_the_store_untouched(point, tmp_path):
    """A crash at the point aborts the load before the publish: nothing
    of it is visible, and the same load then succeeds. The split points
    fire in the guarded parse (in-process here, as the reference's own
    fault tests run it: a crash is returned as a value and re-raised as
    ``IngestError``), the others in the loader's stages."""
    out = {}
    for P in BOTH:
        d = tmp_path / P.name
        d.mkdir()
        paths = [_write_csv(d / f"f{i}.csv", 300, i) for i in range(3)]
        ds = _store(P, "z3")
        # the reference's BulkLoader.put can meet the pool its failing
        # stage shut down and raise the pool's error (fault C9); only the
        # JAX side may raise it, and only with the pool's exact message
        tolerated = (RuntimeError,) if P is JAX else ()
        with P.fault.inject(point, kind="crash"):
            with pytest.raises(
                (P.fault.InjectedCrash, P.ingest.IngestError) + tolerated
            ) as ei:
                P.ingest.ingest_files(ds, _converter(P), paths, workers=1)
        raced = _is_reference_pool_race(ei.value)
        assert not raced or P is JAX
        if type(ei.value) is RuntimeError:
            assert raced, ei.value
        _assert_untouched(ds)
        res = P.ingest.ingest_files(ds, _converter(P), paths, workers=1)
        out[P.name] = (
            "reference pool race" if raced else type(ei.value).__name__,
            getattr(ei.value, "split_index", None),
            res.written, np.asarray(ds.features("p").ids).astype(str).tolist(),
        )
    if out["jax"][0] == "reference pool race":
        assert out["port"][0] in ("InjectedCrash", "IngestError")
        assert out["jax"][1:] == out["port"][1:]
    else:
        assert out["jax"] == out["port"]
    assert out["port"][2] == 900


REFERENCE_POOL_RACE = "cannot schedule new futures after shutdown"


def _is_reference_pool_race(e):
    """The error the reference's ``BulkLoader.put`` raises when a stage
    fails between its last check and its submit (fault C9)."""
    return type(e) is RuntimeError and str(e) == REFERENCE_POOL_RACE


def _fail_after_the_last_check(loader, crash):
    """Force fault C9's interleaving: the second ``_raise_if_failed`` of
    the next ``put`` (the one just before the chunk is appended) passes,
    then a stage fails the pipeline and its pool is shut down before the
    chunk is submitted."""
    check, calls = loader._raise_if_failed, []

    def check_then_fail():
        check()
        calls.append(1)
        if len(calls) == 2:
            loader._fail(crash)

    loader._raise_if_failed = check_then_fail


def test_put_raises_the_first_error_when_a_stage_fails_before_its_submit():
    """A stage that fails between ``put``'s last check and its submit:
    the port raises the pipeline's first error, frees the new chunk's
    admission slot and event, leaves the store untouched, and the same
    load then succeeds. The reference raises the shut pool's
    ``RuntimeError`` instead (a deliberate difference)."""
    out = {}
    for P in BOTH:
        ds = _store(P, "z3")
        chunks = _chunks(P, "z3", [700, 500, 600], seed=11)
        loader = P.ingest.BulkLoader(ds, "p", config=P.ingest.PipelineConfig(workers=1))
        loader.put(chunks[0])
        crash = P.fault.InjectedCrash("ingest.keys")
        _fail_after_the_last_check(loader, crash)
        with pytest.raises(BaseException) as ei:
            loader.put(chunks[1])
        if P is JAX:
            assert _is_reference_pool_race(ei.value), repr(ei.value)
        else:
            assert ei.value is crash
            last = loader._chunks[-1]
            assert last.event.is_set() and not last.slot_held
            with pytest.raises(P.fault.InjectedCrash):
                loader.put(chunks[2])
        with pytest.raises(P.fault.InjectedCrash) as closed:
            loader.close()
        assert closed.value is crash
        _assert_untouched(ds)
        loader = P.ingest.BulkLoader(ds, "p", config=P.ingest.PipelineConfig(workers=1))
        for fc in chunks:
            loader.put(fc)
        res = loader.close()
        out[P.name] = (res.written, ds.count("p"),
                       np.asarray(ds.features("p").ids).astype(str).tolist())
    assert out["jax"] == out["port"]
    assert out["port"][:2] == (1800, 1800)


def test_a_sort_submit_after_the_pool_is_shut_keeps_the_first_error():
    """The other submit, ``_encode`` -> ``_sort_index``: a stage that
    fails and shuts the pool just before a chunk's sort tasks are
    submitted. The encode catches the pool's error, and ``close`` raises
    the pipeline's first error in both packages."""
    out = {}
    for P in BOTH:
        ds = _store(P, "z3")
        chunks = _chunks(P, "z3", [700, 500], seed=12)
        loader = P.ingest.BulkLoader(ds, "p", config=P.ingest.PipelineConfig(workers=1))
        crash = P.fault.InjectedCrash("ingest.sort")
        note = loader._note_chunk_bytes

        def note_then_fail(nbytes, note=note, loader=loader, crash=crash):
            note(nbytes)
            loader._fail(crash)

        loader._note_chunk_bytes = note_then_fail
        with pytest.raises(BaseException) as ei:
            for fc in chunks:
                loader.put(fc)
            loader.close()
        assert ei.value is crash or (P is JAX and _is_reference_pool_race(ei.value)), repr(ei.value)
        if ei.value is not crash:
            # the reference's put met the dead pool first (fault C9)
            with pytest.raises(P.fault.InjectedCrash):
                loader.close()
        assert _is_reference_pool_race(loader._chunks[0].error)
        _assert_untouched(ds)
        out[P.name] = type(loader._error).__name__
    assert out["jax"] == out["port"] == "InjectedCrash"


def test_stage_io_error_then_retry_and_transient_split_read(tmp_path):
    """An io_error in the sort stage aborts; a single io_error at the
    split read is retried and the load completes."""
    out = {}
    for P in BOTH:
        d = tmp_path / P.name
        d.mkdir()
        paths = [_write_csv(d / f"f{i}.csv", 200, i) for i in range(2)]
        ds = _store(P, "z3")
        with P.fault.inject("ingest.split.read", kind="io_error", times=1):
            res = P.ingest.ingest_files(ds, _converter(P), paths, workers=1)
        assert res.written == 400 == ds.count("p")
        ds = _store(P, "z3")
        chunks = _chunks(P, "z3", [800, 600, 900], seed=4)
        loader = P.ingest.BulkLoader(ds, "p", config=P.ingest.PipelineConfig(workers=2))
        with P.fault.inject("ingest.sort", kind="io_error"):
            with pytest.raises((P.fault.InjectedIOError, RuntimeError)):
                for fc in chunks:
                    loader.put(fc)
                loader.close()
        _assert_untouched(ds)
        loader = P.ingest.BulkLoader(ds, "p", config=P.ingest.PipelineConfig(workers=2))
        for fc in chunks:
            loader.put(fc)
        out[P.name] = [loader.close().written, ds.count("p")]
    assert out["jax"] == out["port"] == [2300, 2300]


def test_ingest_error_carries_split_index_and_traceback(tmp_path):
    out = {}
    for P in BOTH:
        d = tmp_path / P.name
        d.mkdir()
        ok = _write_csv(d / "ok.csv", 50, 1)
        bad = _write_csv(d / "bad.csv", 3, 2, bad={0})
        # the pipelined path publishes nothing; the sequential one has
        # committed the splits before the failed one
        seen = []
        for ingest_files in (P.ingest.ingest_files, P.io_ingest.ingest_files):
            ds = _store(P, "z3")
            with pytest.raises(P.ingest.IngestError) as ei:
                ingest_files(ds, _converter(P, drop_errors=False), [ok, bad], workers=1)
            assert "Traceback" in ei.value.worker_traceback
            assert "ValueError" in str(ei.value)
            seen.append((ei.value.split_index, ds.count("p")))
        out[P.name] = seen
    assert out["jax"] == out["port"] == [(1, 0), (1, 50)]


def test_forked_failure_drains_the_pool_before_raising(tmp_path):
    """The port's file ingests raise a failed split's ``IngestError`` only
    after every result of the forked pool is in (``feed_in_split_order``):
    the pool's ``with`` block then terminates idle workers, never one in
    the middle of writing a result (which can hang CPython's
    ``Pool.terminate``). The error and the store are those of stopping at
    the failure: the pipelined path publishes nothing, the sequential
    one keeps the splits before it."""
    import multiprocessing as mp

    from geomesa_tpu_torch.ingest.splits import ConverterConfig, Split, feed_in_split_order

    ok = _write_csv(tmp_path / "ok.csv", 50, 1)
    bad = _write_csv(tmp_path / "bad.csv", 3, 2, bad={0})
    more = [_write_csv(tmp_path / f"m{i}.csv", 40, 10 + i) for i in range(4)]
    seen = []
    for ingest_files in (tingest.ingest_files, tio_ingest.ingest_files):
        ds = _store(PORT, "z3")
        with pytest.raises(tingest.IngestError) as ei:
            _bounded(ingest_files, ds, _converter(PORT, drop_errors=False), [ok, bad] + more,
                     workers=2)
        assert "Traceback" in ei.value.worker_traceback
        seen.append((ei.value.split_index, ds.count("p")))
    assert seen == [(1, 0), (1, 50)]

    class Counted:
        """A pool whose imap counts the results it hands out."""

        def __init__(self, pool):
            self.pool, self.n = pool, 0

        def imap(self, fn, tasks):
            for res in self.pool.imap(fn, tasks):
                self.n += 1
                yield res

    cfg = ConverterConfig.of(_converter(PORT))
    paths = [bad] + more
    tasks = [(cfg, Split(p, 0, len(open(p, "rb").read()), True), i) for i, p in enumerate(paths)]
    consumed = []

    def consume(res):
        consumed.append(res[0])
        raise ValueError("stop at the first split")

    with mp.get_context("fork").Pool(2) as pool:
        counted = Counted(pool)
        with pytest.raises(ValueError, match="first split"):
            _bounded(feed_in_split_order, counted, tasks, consume)
    assert consumed == [0] and counted.n == len(tasks)


# ------------------------------------------------------------- file ingest


def _bad_rows_files(d, n_files=4, n=400):
    paths = []
    for i in range(n_files):
        rng = np.random.default_rng(100 + i)
        bad = set(rng.choice(n, size=i * 3, replace=False).tolist())
        paths.append(_write_csv(d / f"f{i}.csv", n, i, bad=bad))
    # rows outside the curve domain: the z-bounds validator rejects them
    with open(paths[-1], "a") as fh:
        fh.write("oob1,0.5,200.0,10.0,2024-02-01T00:00:00Z\n")
        fh.write("oob2,0.5,10.0,-95.0,2024-02-01T00:00:00Z\n")
    return paths


@pytest.mark.parametrize("ingest", ["pipelined", "sequential"])
@pytest.mark.parametrize("workers", [1, 2])
def test_ingest_files_split_errors_and_reasons_equal(ingest, workers, tmp_path):
    out = {}
    for P in BOTH:
        d = tmp_path / P.name
        d.mkdir()
        paths = _bad_rows_files(d)
        conv = _converter(P, validators="index")
        ds = _store(P, "z3")
        if ingest == "pipelined":
            res = _bounded(P.ingest.ingest_files, ds, conv, paths, workers=workers,
                           split_bytes=8 << 10)
        else:
            P.io_ingest.SPLIT_BYTES, old = 8 << 10, P.io_ingest.SPLIT_BYTES
            try:
                res = _bounded(P.io_ingest.ingest_files, ds, conv, paths, workers=workers)
            finally:
                P.io_ingest.SPLIT_BYTES = old
        assert res.errors == sum(res.error_reasons.values()) == sum(res.split_errors)
        out[P.name] = (
            res.written, res.errors, res.splits, res.split_errors, res.error_reasons,
            np.asarray(ds.features("p").ids).astype(str).tolist(),
            np.asarray(ds.query("p", QUERIES[0]).ids).astype(str).tolist(),
        )
    assert out["jax"] == out["port"]
    assert out["port"][1] == 0 + 3 + 6 + 9 + 2
    assert out["port"][2] > 4  # the files split at line boundaries


def test_running_index_ids_rebase_per_split(tmp_path):
    """Converters without an id expression number rows per split; both
    ingest paths rebase them onto the store's count, so repeated ingests and
    many splits never collide."""
    out = {}
    for P in BOTH:
        d = tmp_path / P.name
        d.mkdir()
        p = _write_csv(d / "noid.csv", 2000, 3)
        ds = _store(P, "z3")
        r1 = _bounded(P.ingest.ingest_files, ds, _converter(P, id_field=None), [p], workers=2,
                      split_bytes=16 << 10)
        r2 = P.io_ingest.ingest_files(ds, _converter(P, id_field=None), [p], workers=1)
        out[P.name] = (r1.written, r1.splits, r2.written, ds.count("p"),
                       np.asarray(ds.features("p").ids).astype(str).tolist())
    assert out["jax"] == out["port"]
    assert out["port"][3] == 4000


def test_plan_splits_tile_the_file_at_line_boundaries(tmp_path):
    p = _write_csv(tmp_path / "big.csv", 5000, 1)
    js = jingest.plan_splits([p], "delimited", split_bytes=64 << 10)
    ts = tingest.plan_splits([p], "delimited", split_bytes=64 << 10)
    assert [(s.path, s.start, s.end, s.skip_header) for s in js] == [
        (s.path, s.start, s.end, s.skip_header) for s in ts]
    assert len(ts) > 3 and ts[0].skip_header and not ts[1].skip_header
    with open(p, "rb") as fh:
        for s in ts[1:]:
            fh.seek(s.start - 1)
            assert fh.read(1) == b"\n"
    doc = tmp_path / "doc.json"
    doc.write_text("[]" * 100000)
    assert len(tingest.plan_splits([str(doc)], "json", split_bytes=1024)) == 1


# ----------------------------------------------------------------- persist


def test_persist_load_goes_through_the_bulk_loader(tmp_path, monkeypatch):
    """``persist.load`` publishes through one ``BulkLoader`` put, and the
    loaded tables equal the JAX package's load of the same directory."""
    out = {}
    for P in BOTH:
        ds = _seq(P, "z3", _chunks(P, "z3", [1200, 900], seed=31))
        root = str(tmp_path / P.name)
        P.persist.save(ds, root)
        puts = []
        orig = P.ingest.BulkLoader.put
        monkeypatch.setattr(P.ingest.BulkLoader, "put", lambda self, fc: puts.append(len(fc)) or orig(self, fc))
        back = P.persist.load(root, tile=TILE, **P.kw)
        assert puts == [2100]
        # the load orders rows by partition: the saved store's keys and
        # answers come back, in another row order
        _assert_equal(_tie_free(_tables(ds)), _tie_free(_tables(back)), f"{P.name} saved vs loaded")
        answers = [
            {k: v for k, v in _tie_free(_answers(d, "z3")).items() if k.startswith("q")}
            for d in (ds, back)
        ]
        _assert_equal(*answers, f"{P.name} saved vs loaded")
        out[P.name] = {**_tables(back), **_answers(back, "z3")}
    _assert_equal(out["jax"], out["port"], "jax vs port")
