"""The port's fault injection (geomesa_tpu_torch.fault) against the JAX
package's, on the CPU.

Both packages' injectors take the same environment entries, fire the
same kinds at the same hits, damage the same bytes, and retry on the
same schedule (the jitter drawn through the ``rng`` seam, no sleeping);
``atomic_write`` leaves the old file or the new one at each of its two
points. The fold's two points, ``stream.fold.slice`` and
``stream.fold.publish``, fire where the JAX package's do, and a crash at
either leaves both stores with the same rows: the slices published
before it, nothing of the one in flight. Tolerance: exact.
"""

import os

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu import fault as jfault
from geomesa_tpu.metrics import MetricsRegistry as JMetrics
from geomesa_tpu_torch import fault as tfault
from geomesa_tpu_torch.metrics import MetricsRegistry as TMetrics

torch.set_num_threads(1)

BOTH = ((jfault, {}), (tfault, {"device": "cpu"}))
PKGS = ((geomesa_tpu, {}), (geomesa_tpu_torch, {"device": "cpu"}))


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    jfault.injector().reset()
    tfault.injector().reset()


def _spec_tuple(s):
    return (s.point, s.kind, s.after, s.times, s.delay_s)


ENV_CASES = [
    "persist.partition.write:io_error:0:1",
    "persist.*:latency::-1:0.05",
    "persist.gc:crash,load.partition.read:io_error:2:3",
    "stream.fold.*:bit_flip:1",
    " , persist.manifest.rename:partial_write:0:-1 ,",
]


@pytest.mark.parametrize("raw", ENV_CASES)
def test_env_entries_parse_alike(raw):
    got = [_spec_tuple(s) for s in tfault.FaultInjector().load_env({"GEOMESA_TPU_FAULTS": raw})]
    want = [_spec_tuple(s) for s in jfault.FaultInjector().load_env({"GEOMESA_TPU_FAULTS": raw})]
    assert got == want and got


@pytest.mark.parametrize("raw", ["justapoint", "p:unknown_kind", "p:crash:x", "p:latency:0:1:slow"])
def test_bad_env_entries_raise_strict_and_skip_lenient(raw):
    for f, _ in BOTH:
        with pytest.raises(ValueError):
            f.FaultInjector().load_env({"GEOMESA_TPU_FAULTS": raw})
        assert f.FaultInjector().load_env({"GEOMESA_TPU_FAULTS": raw}, strict=False) == []


def test_unknown_kind_refused():
    for f, _ in BOTH:
        with pytest.raises(ValueError, match="unknown fault kind"):
            f.FaultSpec(point="p", kind="segfault")


def _fire_log(f, after, times):
    out = []
    with f.inject("demo.*", kind="io_error", after=after, times=times) as spec:
        for i in range(8):
            try:
                f.fault_point("demo.x" if i % 2 else "demo.y")
            except f.InjectedIOError:
                out.append(i)
            f.fault_point("other.point")  # never matches
    return out, spec.hits, spec.fired


@pytest.mark.parametrize("after,times", [(0, 1), (2, 3), (1, None), (0, 0)])
def test_specs_fire_at_the_same_hits(after, times):
    assert _fire_log(tfault, after, times) == _fire_log(jfault, after, times)


@pytest.mark.parametrize("kind", ["partial_write", "bit_flip"])
def test_file_damage_is_byte_identical(tmp_path, kind):
    data = bytes(range(256)) * 3
    out = []
    for f, _ in BOTH:
        p = tmp_path / f"{f.__name__}.bin"
        p.write_bytes(data)
        try:
            with f.inject("disk.*", kind=kind):
                f.fault_point("disk.write", str(p))
        except f.InjectedCrash:
            out.append("crash")
        out.append(p.read_bytes())
    n = len(out) // 2
    assert out[:n] == out[n:]
    assert out[-1] != data


def test_crash_is_a_base_exception_and_io_error_an_oserror():
    assert issubclass(tfault.InjectedCrash, BaseException)
    assert not issubclass(tfault.InjectedCrash, Exception)
    assert issubclass(tfault.InjectedIOError, OSError)


@pytest.mark.parametrize("point,kind", [("w.write", "crash"), ("w.rename", "crash"),
                                        ("w.write", "io_error"), ("w.rename", "partial_write")])
def test_atomic_write_leaves_old_or_new(tmp_path, point, kind):
    out = []
    for f, _ in BOTH:
        p = tmp_path / f.__name__ / "file.json"
        os.makedirs(p.parent)
        f.atomic_write(str(p), b"old")
        try:
            with f.inject(point, kind=kind):
                f.atomic_write(str(p), b"new contents", point="w")
        except (f.InjectedCrash, OSError):
            pass
        f.atomic_write(str(p.parent / "other"), b"x")  # no point: never fires
        out.append((p.read_bytes(), sorted(os.listdir(p.parent))))
    assert out[0] == out[1]
    assert out[1][0] == b"old"


def test_atomic_write_replaces_and_fsync_dir_tolerates_missing(tmp_path):
    p = tmp_path / "f"
    tfault.atomic_write(str(p), b"a")
    tfault.atomic_write(str(p), b"bb")
    assert p.read_bytes() == b"bb" and not (tmp_path / "f.tmp").exists()
    tfault.fsync_dir(str(tmp_path / "does-not-exist"))  # best effort


@pytest.mark.parametrize("attempts,fails", [(4, 3), (3, 1), (2, 5), (1, 1)])
def test_retry_schedule_and_counters_alike(attempts, fails):
    out = []
    for f, Reg in ((jfault, JMetrics), (tfault, TMetrics)):
        reg = Reg()
        sleeps, calls = [], {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] <= fails:
                raise OSError("blip")
            return "ok"

        try:
            res = f.with_retries(flaky, attempts=attempts, backoff_s=0.01,
                                 sleep=sleeps.append, metrics=reg, rng=lambda lo, hi: hi)
        except OSError:
            res = "raised"
        out.append((res, calls["n"], sleeps, reg.counter_value("geomesa.fault.retry"),
                    reg.counter_value("geomesa.fault.retries_exhausted"),
                    reg.snapshot()["histograms"].get("geomesa.fault.retry.giveup.ms", {})
                    .get("count", 0)))
    assert out[0] == out[1]


def test_retry_jitter_bounds_and_elapsed_budget():
    sleeps = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 4:
            raise OSError("blip")
        return "ok"

    assert tfault.with_retries(flaky, attempts=4, backoff_s=0.01, sleep=sleeps.append) == "ok"
    assert len(sleeps) == 3 and all(0.01 <= s <= 0.08 for s in sleeps), sleeps
    calls["n"] = 0
    with pytest.raises(OSError):  # the elapsed budget gives up at once
        tfault.with_retries(flaky, attempts=10, backoff_s=0.01, sleep=sleeps.append,
                            max_elapsed_s=0.0)
    assert calls["n"] == 1


def test_retries_read_the_environment(monkeypatch):
    monkeypatch.setenv("GEOMESA_TPU_IO_RETRIES", "2")
    monkeypatch.setenv("GEOMESA_TPU_IO_BACKOFF_S", "0.5")
    for f, _ in BOTH:
        sleeps, calls = [], {"n": 0}

        def dead():
            calls["n"] += 1
            raise OSError("down")

        with pytest.raises(OSError):
            f.with_retries(dead, sleep=sleeps.append, rng=lambda lo, hi: lo)
        assert calls["n"] == 2 and sleeps == [0.5]


def test_crash_is_never_retried():
    for f, _ in BOTH:
        calls = {"n": 0}

        def dies():
            calls["n"] += 1
            raise f.InjectedCrash("dead")

        with pytest.raises(f.InjectedCrash):
            f.with_retries(dies, attempts=5, backoff_s=0.0)
        assert calls["n"] == 1


# -- the fold's fault points --------------------------------------------------

T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000


def _fold_store(pkg, kw, n=4_000):
    rng = np.random.default_rng(3)
    sft = pkg.FeatureType.from_spec("t", "v:Integer,dtg:Date,*geom:Point:srid=4326")
    ds = pkg.DataStore(tile=1024, **kw)
    ds.create_schema(sft)
    ds.write("t", pkg.FeatureCollection.from_columns(sft, np.arange(n), {
        "v": np.arange(n), "dtg": T0 + rng.integers(0, 20 * DAY, n),
        "geom": (rng.uniform(-50, 50, n), rng.uniform(-50, 50, n))}))
    return ds


def _fold_batch(pkg, ds, n=900):
    rng = np.random.default_rng(8)
    n_old = min(600, n // 2)  # replaced ids; the rest are appends
    ids = np.concatenate([np.arange(0, 4_000, 3)[:n_old], 10_000 + np.arange(n - n_old)])
    return pkg.FeatureCollection.from_columns(ds.get_schema("t"), ids, {
        "v": -np.arange(n), "dtg": T0 + rng.integers(0, 20 * DAY, n),
        "geom": (rng.uniform(-50, 50, n), rng.uniform(-50, 50, n))})


def _state(ds):
    q = "bbox(geom, -20, -20, 30, 30)"
    return (np.asarray(ds.features("t").ids).tolist(), np.asarray(ds.query("t", q).ids).tolist(),
            ds.row_count("t"))


@pytest.mark.parametrize("slice_rows", [0, 200])
def test_fold_points_fire_as_the_jax_package(slice_rows):
    hits = []
    for (pkg, kw), (f, _) in zip(PKGS, BOTH):
        ds = _fold_store(pkg, kw)
        with f.inject("stream.fold.slice", kind="latency", times=None) as s, \
                f.inject("stream.fold.publish", kind="latency", times=None) as p:
            ds.fold_upsert("t", _fold_batch(pkg, ds), slice_rows=slice_rows)
        hits.append((s.fired, p.fired, _state(ds)))
    assert hits[0] == hits[1]
    assert hits[1][1] == (5 if slice_rows else 1)  # one publish per slice
    assert hits[1][0] == (5 if slice_rows else 0)  # the slice point is the sliced loop's


@pytest.mark.parametrize("point,after", [("stream.fold.publish", 0), ("stream.fold.publish", 2),
                                         ("stream.fold.slice", 3)])
def test_crash_in_a_fold_keeps_the_published_slices(point, after):
    """A crash before a publish leaves the store at the fold of the
    slices already published, in both packages alike; the store still
    answers and a later fold completes it."""
    out = []
    for (pkg, kw), (f, _) in zip(PKGS, BOTH):
        ds = _fold_store(pkg, kw)
        before = _state(ds)
        with f.inject(point, kind="crash", after=after):
            with pytest.raises(f.InjectedCrash):
                ds.fold_upsert("t", _fold_batch(pkg, ds), slice_rows=200)
        mid = _state(ds)
        assert (mid == before) == (after == 0)
        assert ds._fold_progress == {}  # the progress entry is cleared
        ds.fold_upsert("t", _fold_batch(pkg, ds), slice_rows=200)
        out.append((mid, _state(ds)))
    assert out[0] == out[1]


def test_blocking_fault_points_under_the_write_lock_are_witnessed():
    """With the witness armed, the fold's points are reached under
    DataStore._write_lock in both packages: blocking events."""
    from geomesa_tpu import lockwitness as jlw
    from geomesa_tpu_torch import lockwitness as tlw

    out = []
    try:
        for (pkg, kw), lw in zip(PKGS, (jlw, tlw)):
            lw.enable()
            ds = _fold_store(pkg, kw, n=2_000)
            ds.fold_upsert("t", _fold_batch(pkg, ds, n=700), slice_rows=300)
            out.append(lw.REPORT.snapshot()["blocking"])
            lw.disable()
    finally:
        jlw.disable()
        tlw.disable()
    assert out[0] == out[1]
    assert out[1]["DataStore._write_lock @ stream.fold.publish"] == 3
