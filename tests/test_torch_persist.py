"""The port's persistence (storage.persist) against the JAX package's, on
the CPU.

Both packages run every scenario on the same seeded stores and the same
directory damage, and must agree: the manifests on every field except
``checksum`` and ``bytes`` (``np.savez_compressed`` stamps each zip
entry with the wall clock, so the partition bytes differ between two
saves of the same data), the loaded ids in order, the store health and
its damage records, the quarantine report, the planner's warning and the
counters. The classes mirror tests/test_crash_recovery.py's
``TestAtomicSave``, ``TestQuarantine``, ``TestRetryAndEnv``,
``TestChaosSchedule``, ``TestSignature`` and ``TestFaultPointCoverage``
(this slice's points); beside them, a store saved by either package
loads in the other (point, extent and attribute-indexed schemas), and
the legacy v1 and v2 layouts load in both. Tolerance: exact.
"""

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu import fault as jfault
from geomesa_tpu.metrics import MetricsRegistry as JMetrics
from geomesa_tpu.planning.explain import Explainer as JExplainer
from geomesa_tpu.storage import persist as jpersist
from geomesa_tpu_torch import fault as tfault
from geomesa_tpu_torch.metrics import MetricsRegistry as TMetrics
from geomesa_tpu_torch.planning.explain import Explainer as TExplainer
from geomesa_tpu_torch.storage import persist as tpersist

torch.set_num_threads(1)

SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"
T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000

JAX = SimpleNamespace(
    name="jax", pkg=geomesa_tpu, fault=jfault, persist=jpersist, Metrics=JMetrics,
    Explainer=JExplainer, kw={},
)
PORT = SimpleNamespace(
    name="port", pkg=geomesa_tpu_torch, fault=tfault, persist=tpersist, Metrics=TMetrics,
    Explainer=TExplainer, kw={"device": "cpu"},
)
BOTH = (JAX, PORT)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    """No fault leaks between tests, and retries back off in microseconds."""
    monkeypatch.setenv("GEOMESA_TPU_IO_BACKOFF_S", "0.0001")
    yield
    jfault.injector().reset()
    tfault.injector().reset()


def _store(P, n=120, seed=0, prefix="f", **kw):
    """A store whose dtg spread covers several 28-day partitions."""
    sft = P.pkg.FeatureType.from_spec("t", SPEC)
    ds = P.pkg.DataStore(**P.kw, **kw)
    ds.create_schema(sft)
    rng = np.random.default_rng(seed)
    ds.write("t", P.pkg.FeatureCollection.from_columns(
        sft, [f"{prefix}{i}" for i in range(n)],
        {"name": np.array([f"n{i % 5}" for i in range(n)]),
         "dtg": T0 + rng.integers(0, 80 * DAY, n),
         "geom": (rng.uniform(-50, 50, n), rng.uniform(-50, 50, n))},
    ))
    return ds


def _append(P, ds, start, n=40, seed=9):
    sft = ds.get_schema("t")
    rng = np.random.default_rng(seed)
    ds.write("t", P.pkg.FeatureCollection.from_columns(
        sft, [f"x{start + i}" for i in range(n)],
        {"name": np.array(["x"] * n),
         "dtg": T0 + rng.integers(0, 80 * DAY, n),
         "geom": (rng.uniform(-50, 50, n), rng.uniform(-50, 50, n))},
    ))


def _ids(ds, name="t"):
    """The store's ids in feature order (not sorted: the order is part of
    what a load must reproduce)."""
    return np.asarray(ds.features(name).ids).tolist()


def _load(P, root, **kw):
    return P.persist.load(root, **P.kw, **kw)


def _manifest(root) -> dict:
    """metadata.json without the two fields that carry the zip's clock."""
    meta = json.load(open(os.path.join(root, "metadata.json")))
    for info in meta["types"].values():
        for entry in info.get("partitions", {}).values():
            if isinstance(entry, dict):
                entry.pop("checksum", None)
                entry.pop("bytes", None)
    return meta


def _flip_byte(path, offset=None):
    with open(path, "rb+") as fh:
        data = fh.read()
        off = len(data) // 2 if offset is None else offset
        fh.seek(off)
        fh.write(bytes([data[off] ^ 0x20]))


def _damage(health) -> list:
    return [(d.type_name, d.file, d.reason, d.rows_lost, d.quarantined_to)
            for d in health.damage]


def _report(root) -> list:
    return [{k: v for k, v in r.items() if k != "time"}
            for r in jpersist.damage_report(root)]


SAVE_FAULT_POINTS = [
    "persist.partition.write",
    "persist.partition.rename",
    "persist.manifest.write",
    "persist.manifest.rename",
]
# every persist.* point: the four above, the partition's post-commit
# point, the manifest's post-commit point and the garbage collection
PERSIST_POINTS = SAVE_FAULT_POINTS + [
    "persist.partition.commit", "persist.manifest.commit", "persist.gc",
]


class TestAtomicSave:
    def test_v3_roundtrip_and_manifest(self, tmp_path):
        stores = {P.name: _store(P) for P in BOTH}
        for P in BOTH:
            P.persist.save(stores[P.name], tmp_path / P.name)
        meta = json.load(open(tmp_path / "port" / "metadata.json"))
        assert meta["version"] == 3
        parts = meta["types"]["t"]["partitions"]
        assert len(parts) >= 2  # the dtg spread covers several partitions
        for entry in parts.values():
            assert set(entry) >= {"file", "sig", "checksum", "bytes", "rows"}
            assert (tmp_path / "port" / "t" / entry["file"]).stat().st_size == entry["bytes"]
        assert _manifest(tmp_path / "port") == _manifest(tmp_path / "jax")
        assert sorted(os.listdir(tmp_path / "port" / "t")) == sorted(
            os.listdir(tmp_path / "jax" / "t"))
        for P in BOTH:
            back = _load(P, tmp_path / P.name)
            assert _ids(back) == _ids(_load(JAX, tmp_path / "jax"))
            assert back.store_health.status == "ok"

    def test_incremental_save_reuses_committed_files(self, tmp_path):
        ds = _store(PORT)
        root = tmp_path / "s"
        tpersist.save(ds, root)
        before = {f: (root / "t" / f).stat().st_mtime_ns for f in os.listdir(root / "t")}
        tpersist.save(ds, root)  # no changes: nothing rewritten
        after = {f: (root / "t" / f).stat().st_mtime_ns for f in os.listdir(root / "t")}
        assert before == after
        # an append rewrites only the partitions it touches, as the JAX
        # package's save does
        names = {}
        for P in BOTH:
            d = _store(P)
            P.persist.save(d, tmp_path / P.name)
            old = set(os.listdir(tmp_path / P.name / "t"))
            _append(P, d, 0, n=3, seed=4)
            P.persist.save(d, tmp_path / P.name)
            new = set(os.listdir(tmp_path / P.name / "t"))
            names[P.name] = (sorted(old & new), sorted(new - old))
        assert names["port"] == names["jax"]
        assert names["port"][0] and names["port"][1]  # some kept, some rewritten

    @pytest.mark.parametrize("point", PERSIST_POINTS)
    def test_crash_at_fault_point_leaves_old_or_new(self, tmp_path, point):
        outcome = {}
        for P in BOTH:
            ds = _store(P)
            root = tmp_path / P.name
            P.persist.save(ds, root)
            old = _ids(_load(P, root))
            _append(P, ds, 0)
            with P.fault.inject(point, kind="crash"):
                with pytest.raises(P.fault.InjectedCrash):
                    P.persist.save(ds, root)
            back = _load(P, root)
            assert back.store_health.status == "ok"
            got = _ids(back)
            P.persist.save(ds, root)  # the next clean save converges
            new = _ids(_load(P, root))
            assert got in (old, new)
            outcome[P.name] = ("old" if got == old else "new", got)
        assert outcome["port"] == outcome["jax"]

    def test_partial_write_crash_recovers_old_store(self, tmp_path):
        for P in BOTH:
            ds = _store(P)
            root = tmp_path / P.name
            P.persist.save(ds, root)
            old = _ids(_load(P, root))
            _append(P, ds, 0)
            with P.fault.inject("persist.partition.commit", kind="partial_write"):
                with pytest.raises(P.fault.InjectedCrash):
                    P.persist.save(ds, root)
            back = _load(P, root)
            assert _ids(back) == old and back.store_health.status == "ok"

    def test_crash_mid_way_through_partitions(self, tmp_path):
        for P in BOTH:
            ds = _store(P)
            root = tmp_path / P.name
            P.persist.save(ds, root)
            old = _ids(_load(P, root))
            _append(P, ds, 0, n=60, seed=3)  # touches every partition
            with P.fault.inject("persist.partition.write", kind="crash", after=1):
                with pytest.raises(P.fault.InjectedCrash):
                    P.persist.save(ds, root)
            assert _ids(_load(P, root)) == old
        assert sorted(os.listdir(tmp_path / "port" / "t")) == sorted(
            os.listdir(tmp_path / "jax" / "t"))  # the same orphans

    def test_gc_crash_leaves_loadable_new_store(self, tmp_path):
        for P in BOTH:
            ds = _store(P)
            root = tmp_path / P.name
            P.persist.save(ds, root)
            _append(P, ds, 0)
            with P.fault.inject("persist.gc", kind="crash"):
                with pytest.raises(P.fault.InjectedCrash):
                    P.persist.save(ds, root)
            back = _load(P, root)
            assert sorted(_ids(back)) == sorted(_ids(ds))
            assert back.store_health.status == "ok"
            P.persist.save(ds, root)  # the next save sweeps the orphans
            files = {e["file"] for e in json.load(open(root / "metadata.json"))
                     ["types"]["t"]["partitions"].values()}
            assert set(os.listdir(root / "t")) == files

    def test_corrupt_manifest_raises_store_corruption(self, tmp_path):
        for P in BOTH:
            root = tmp_path / P.name
            P.persist.save(_store(P), root)
            _flip_byte(root / "metadata.json", offset=2)
            with pytest.raises(P.persist.StoreCorruptionError):
                _load(P, root)

    def test_crash_matrix_over_growing_stores(self, tmp_path):
        """Every save point at several hit offsets over a growing store:
        no combination gives a torn store, and both packages land on the
        same state each time."""
        runs = {}
        for P in BOTH:
            ds = _store(P, n=90, seed=11)
            root = tmp_path / P.name
            P.persist.save(ds, root)
            states = [_ids(_load(P, root))]
            seen = []
            for rnd in range(2):
                _append(P, ds, 1000 * rnd, n=25, seed=rnd)
                for point in SAVE_FAULT_POINTS + ["persist.partition.commit"]:
                    kind = "partial_write" if "commit" in point else "crash"
                    for after in (0, 1):
                        with P.fault.inject(point, kind=kind, after=after):
                            try:
                                P.persist.save(ds, root)
                            except P.fault.InjectedCrash:
                                pass
                        got = _ids(_load(P, root))
                        seen.append(got)
                P.persist.save(ds, root)
                states.append(_ids(_load(P, root)))
                assert all(g in states for g in seen)
            runs[P.name] = (states, seen)
        assert runs["port"] == runs["jax"]


def _saved_pair(tmp_path, **kw):
    """One store saved by the port, and a byte copy of its directory for
    the JAX package, so both see the same damage."""
    root = tmp_path / "port"
    tpersist.save(_store(PORT, **kw), root)
    shutil.copytree(root, tmp_path / "jax")
    return {"port": root, "jax": tmp_path / "jax"}


def _make_unreadable(root):
    """A partition whose bytes match its manifest entry (length and
    checksum) but do not unpack: the 'unreadable' reason."""
    import hashlib

    meta = json.load(open(root / "metadata.json"))
    pkey = sorted(meta["types"]["t"]["partitions"])[0]
    entry = meta["types"]["t"]["partitions"][pkey]
    junk = b"this is not a zip archive" * 8
    (root / "t" / entry["file"]).write_bytes(junk)
    entry["bytes"] = len(junk)
    entry["checksum"] = hashlib.blake2b(junk, digest_size=16).hexdigest()
    json.dump(meta, open(root / "metadata.json", "w"))
    return entry["file"]


def _first_file(root):
    return sorted(os.listdir(root / "t"))[0]


def _damage_checksum(root):
    f = _first_file(root)
    _flip_byte(root / "t" / f)
    return f


def _damage_truncated(root):
    f = _first_file(root)
    with open(root / "t" / f, "rb+") as fh:
        fh.truncate(os.path.getsize(root / "t" / f) // 2)
    return f


def _damage_missing(root):
    f = _first_file(root)
    os.remove(root / "t" / f)
    return f


def _damage_manifest(root):
    meta = json.load(open(root / "metadata.json"))
    parts = meta["types"]["t"]["partitions"]
    bad = sorted(parts)[0]
    del parts[bad]["file"]
    json.dump(meta, open(root / "metadata.json", "w"))
    return bad


DAMAGE = {
    "checksum": _damage_checksum,
    "truncated": _damage_truncated,
    "missing": _damage_missing,
    "unreadable": _make_unreadable,
    "manifest": _damage_manifest,
}


class TestQuarantine:
    @pytest.mark.parametrize("reason", sorted(DAMAGE))
    def test_each_reason_quarantines_reports_and_degrades(self, tmp_path, reason):
        roots = _saved_pair(tmp_path)
        full = _ids(_load(PORT, roots["port"]))
        out = {}
        for P in BOTH:
            fname = DAMAGE[reason](roots[P.name])
            reg = P.Metrics()
            back = _load(P, roots[P.name], metrics=reg)
            h = back.store_health
            assert h.status == "degraded" and not h.ok
            [rec] = h.damage
            assert rec.reason == reason and rec.type_name == "t" and rec.file == fname
            if reason == "missing":
                assert rec.quarantined_to is None
            elif reason != "manifest":
                # the damaged file moved out of the data dir, into quarantine
                assert not (roots[P.name] / "t" / fname).exists()
                assert (roots[P.name] / "_quarantine" / "t" / fname).exists()
            assert os.path.exists(roots[P.name] / "_quarantine" / "report.json")
            assert reg.counter_value("geomesa.store.quarantined") == 1
            ids = _ids(back)
            assert 0 < len(ids) < len(full) and set(ids) <= set(full)
            exp = P.Explainer()
            res = back.query("t", "bbox(geom, -60, -60, 60, 60)", explain=exp)
            assert len(res) > 0 and any("quarantined" in w for w in exp.warnings)
            assert reg.counter_value("geomesa.query.degraded") == 1
            out[P.name] = (_damage(h), _report(roots[P.name]), ids, exp.warnings,
                           h.warning_for("t"), sorted(h.degraded_types()))
        assert out["port"] == out["jax"]

    def test_bit_flip_injected_at_commit_is_quarantined(self, tmp_path):
        out = {}
        for P in BOTH:
            root = tmp_path / P.name
            ds = _store(P)
            with P.fault.inject("persist.partition.commit", kind="bit_flip"):
                P.persist.save(ds, root)  # the save succeeds; one file damaged
            back = _load(P, root)
            assert back.store_health.status == "degraded"
            [rec] = back.store_health.damage
            assert rec.reason == "checksum" and rec.type_name == "t"
            assert not (root / "t" / rec.file).exists()
            assert (root / "_quarantine" / "t" / rec.file).exists()
            assert 0 < len(back.features("t")) < len(ds.features("t"))
            out[P.name] = (_damage(back.store_health), _ids(back))
        assert out["port"] == out["jax"]

    def test_damage_report_is_machine_readable(self, tmp_path):
        roots = _saved_pair(tmp_path)
        for P in BOTH:
            f = _damage_checksum(roots[P.name])
            _load(P, roots[P.name])
            report = P.persist.damage_report(roots[P.name])
            assert len(report) == 1
            assert set(report[0]) >= {
                "type", "file", "reason", "rows_lost", "quarantined_to", "time",
            }
            assert report[0]["file"] == f
        assert _report(roots["port"]) == _report(roots["jax"])
        assert tpersist.damage_report(tmp_path / "nowhere") == []

    def test_on_damage_raise(self, tmp_path):
        roots = _saved_pair(tmp_path)
        for P in BOTH:
            f = _damage_checksum(roots[P.name])
            with pytest.raises(P.persist.StoreCorruptionError):
                _load(P, roots[P.name], on_damage="raise")
            assert (roots[P.name] / "t" / f).exists()  # nothing quarantined
            with pytest.raises(ValueError, match="on_damage"):
                _load(P, roots[P.name], on_damage="ignore")

    def test_degraded_query_warns_and_counts(self, tmp_path):
        roots = _saved_pair(tmp_path)
        out = {}
        for P in BOTH:
            _damage_checksum(roots[P.name])
            reg = P.Metrics()
            back = _load(P, roots[P.name], metrics=reg)
            assert reg.counters["geomesa.store.quarantined"] == 1
            exp = P.Explainer()
            res = back.query("t", "bbox(geom, -60, -60, 60, 60)", explain=exp)
            assert len(res) > 0  # degraded, not dead: the survivors answer
            assert any("quarantined" in w for w in exp.warnings)
            assert any("WARNING" in line for line in exp.lines)
            assert reg.counters["geomesa.query.degraded"] == 1
            # the damaged type warns on every plan, aggregations included
            back.query("t", "bbox(geom, 0, 0, 1, 1)")
            back.count("t", "bbox(geom, -10, -10, 10, 10)")
            back.density("t", "bbox(geom, -10, -10, 10, 10)", width=8, height=8)
            back.bounds("t", "bbox(geom, -10, -10, 10, 10)")
            plan = back.planner.plan("t", "bbox(geom, 0, 0, 1, 1)")
            assert plan.warnings == [back.store_health.warning_for("t")]
            out[P.name] = (np.asarray(res.ids).tolist(), exp.warnings,
                           reg.counters["geomesa.query.degraded"])
        assert out["port"] == out["jax"]

    def test_repeated_loads_do_not_duplicate_report_records(self, tmp_path):
        roots = _saved_pair(tmp_path)
        out = {}
        for P in BOTH:
            _damage_checksum(roots[P.name])
            counts = []
            for _ in range(3):
                reg = P.Metrics()
                back = _load(P, roots[P.name], metrics=reg)
                assert back.store_health.status == "degraded"
                counts.append(reg.counters.get("geomesa.store.quarantined", 0))
            assert len(P.persist.damage_report(roots[P.name])) == 1
            assert counts == [1, 0, 0]  # only the first sighting counts
            out[P.name] = (_damage(back.store_health), _report(roots[P.name]))
        assert out["port"] == out["jax"]

    def test_unwritable_store_still_loads_degraded(self, tmp_path):
        from unittest import mock

        roots = _saved_pair(tmp_path)
        out = {}
        for P in BOTH:
            _damage_checksum(roots[P.name])
            with mock.patch("os.makedirs", side_effect=OSError(30, "Read-only file system")):
                back = _load(P, roots[P.name])
            assert back.store_health.status == "degraded"
            [rec] = back.store_health.damage
            assert rec.reason == "checksum" and rec.quarantined_to is None
            assert P.persist.damage_report(roots[P.name]) == []  # nothing loggable
            out[P.name] = (_damage(back.store_health), _ids(back))
        assert out["port"] == out["jax"]

    def test_quarantine_name_collision_rejected(self, tmp_path):
        for P in BOTH:
            sft = P.pkg.FeatureType.from_spec("_quarantine", "name:String,*geom:Point:srid=4326")
            ds = P.pkg.DataStore(**P.kw)
            ds.create_schema(sft)
            with pytest.raises(ValueError, match="_quarantine"):
                P.persist.save(ds, tmp_path / P.name)

    def test_quarantined_rows_reappear_after_resave(self, tmp_path):
        for P in BOTH:
            ds = _store(P)
            root = tmp_path / P.name
            P.persist.save(ds, root)
            _damage_checksum(root)
            _load(P, root)  # quarantines
            P.persist.save(ds, root)  # the full store heals the directory
            back = _load(P, root)
            assert back.store_health.status == "ok"
            assert sorted(_ids(back)) == sorted(_ids(ds))


class TestRetryAndEnv:
    def test_transient_io_error_is_retried(self, tmp_path):
        for P in BOTH:
            ds = _store(P)
            with P.fault.inject("persist.partition.write", kind="io_error", times=2) as spec:
                P.persist.save(ds, tmp_path / P.name)  # 3 attempts by default
            assert spec.fired == 2
            assert sorted(_ids(_load(P, tmp_path / P.name))) == sorted(_ids(ds))

    def test_persistent_io_error_raises_after_retries(self, tmp_path):
        for P in BOTH:
            ds = _store(P)
            with P.fault.inject("persist.partition.write", kind="io_error", times=None):
                with pytest.raises(OSError):
                    P.persist.save(ds, tmp_path / P.name)
            assert not (tmp_path / P.name / "metadata.json").exists()

    def test_latency_fault_only_slows(self, tmp_path):
        for P in BOTH:
            ds = _store(P, n=30)
            with P.fault.inject("persist.*", kind="latency", times=None, delay_s=0.001) as spec:
                P.persist.save(ds, tmp_path / P.name)
            assert spec.fired >= 5
            assert sorted(_ids(_load(P, tmp_path / P.name))) == sorted(_ids(ds))

    def test_env_var_armed_faults(self, tmp_path, monkeypatch):
        monkeypatch.setenv("GEOMESA_TPU_FAULTS", "persist.manifest.rename:crash:0:1")
        for P in BOTH:
            ds = _store(P, n=30)
            specs = P.fault.injector().load_env()
            try:
                with pytest.raises(P.fault.InjectedCrash):
                    P.persist.save(ds, tmp_path / P.name)
            finally:
                for s in specs:
                    P.fault.injector().remove(s)
            P.persist.save(ds, tmp_path / P.name)  # spec removed
            assert sorted(_ids(_load(P, tmp_path / P.name))) == sorted(_ids(ds))

    def test_env_retries_bound_the_attempts(self, tmp_path, monkeypatch):
        """GEOMESA_TPU_IO_RETRIES sets the attempts: one attempt turns a
        single transient fault into a failed save."""
        monkeypatch.setenv("GEOMESA_TPU_IO_RETRIES", "1")
        for P in BOTH:
            with P.fault.inject("persist.partition.write", kind="io_error", times=1):
                with pytest.raises(OSError):
                    P.persist.save(_store(P, n=30), tmp_path / P.name)


class TestChaosSchedule:
    def test_schedule_is_deterministic_and_shared(self):
        runs = {}
        for P in BOTH:
            out = []
            for _ in range(2):
                fired = []
                with P.fault.chaos(seed=5, rate=0.5, points="demo.*",
                                   kinds=("io_error",), delay_s=0.0) as spec:
                    for i in range(30):
                        try:
                            P.fault.fault_point("demo.p")
                        except OSError:
                            fired.append(i)
                assert spec.hits == 30 and spec.fired == len(fired)
                out.append((fired, list(spec.log)))
            assert out[0] == out[1] and out[0][0]  # same seed, same schedule
            runs[P.name] = out[0]
        assert runs["port"] == runs["jax"]  # and the reference's schedule

    def test_non_matching_points_never_fire(self):
        for P in BOTH:
            with P.fault.chaos(seed=1, rate=1.0, points="persist.*") as spec:
                P.fault.fault_point("stream.wal.append")
            assert spec.hits == 0 and spec.fired == 0

    def test_validation_and_single_schedule(self):
        for P in BOTH:
            with pytest.raises(ValueError, match="rate"):
                P.fault.ChaosSpec(1, rate=1.5)
            with pytest.raises(ValueError, match="kind"):
                P.fault.ChaosSpec(1, kinds=("segfault",))
            with P.fault.chaos(seed=1):
                with pytest.raises(RuntimeError, match="already installed"):
                    P.fault.injector().install_chaos(P.fault.ChaosSpec(2))
            with P.fault.chaos(seed=3):  # the exit released the slot
                pass

    def test_chaos_over_a_save_is_old_or_new(self, tmp_path):
        """A seeded chaos schedule of crashes and IO errors over repeated
        saves: every load is a committed state, as in the JAX package."""
        runs = {}
        for P in BOTH:
            ds = _store(P, n=60, seed=2)
            root = tmp_path / P.name
            P.persist.save(ds, root)
            states, got = [_ids(_load(P, root))], []
            with P.fault.chaos(seed=11, rate=0.3, points="persist.*",
                               kinds=("io_error", "crash", "latency"), delay_s=0.0) as spec:
                for k in range(4):
                    _append(P, ds, 100 * k, n=10, seed=k)
                    states.append(_ids(ds))
                    try:
                        P.persist.save(ds, root)
                    except (OSError, P.fault.InjectedCrash):
                        pass
                    got.append(_ids(_load(P, root)))
            assert all(sorted(g) in [sorted(s) for s in states] for g in got)
            runs[P.name] = (got, list(spec.log))
        assert runs["port"] == runs["jax"]


class TestSignature:
    def _sig(self, P, ids, names=None):
        sft = P.pkg.FeatureType.from_spec("t", SPEC)
        n = len(ids)
        fc = P.pkg.FeatureCollection.from_columns(
            sft, ids,
            {"name": np.array(["a"] * n if names is None else names),
             "dtg": np.full(n, T0, dtype=np.int64),
             "geom": (np.zeros(n), np.zeros(n))},
        )
        return P.persist._signature(np.asarray(fc.ids), P.persist._pack_columns(sft, fc))

    @staticmethod
    def _obj(vals):
        a = np.empty(len(vals), dtype=object)
        a[:] = vals
        return a

    def test_mixed_type_ids_do_not_collide(self):
        for P in BOTH:
            sigs = {self._sig(P, self._obj(v))
                    for v in (["1", "2"], [1, 2], [b"1", b"2"], ["1", 2])}
            assert len(sigs) == 4  # str, int and bytes forms all hash apart

    def test_separator_injection_does_not_collide(self):
        for P in BOTH:
            assert self._sig(P, self._obj(["a\nb", "c"])) != self._sig(P, self._obj(["a", "b\nc"]))

    def test_signature_stable_across_unicode_width(self):
        for P in BOTH:
            assert self._sig(P, np.array(["a", "b"])) == self._sig(
                P, np.array(["a", "b", "longerid"])[:2])

    def test_signature_covers_attribute_values(self):
        ids = np.array(["1", "2"])
        for P in BOTH:
            assert self._sig(P, ids, ["a", "a"]) != self._sig(P, ids, ["a", "B"])

    @pytest.mark.parametrize("case", ["str", "int", "obj", "values"])
    def test_signature_equals_the_jax_package(self, case):
        ids = {"str": np.array(["x1", "x2", "x3"]), "int": np.arange(3),
               "obj": self._obj(["a\nb", "c:d", "e"]), "values": np.array(["1", "2", "3"])}[case]
        names = ["p", "q", "r"] if case == "values" else None
        assert self._sig(PORT, ids, names) == self._sig(JAX, ids, names)

    def test_value_only_update_persists_through_incremental_save(self, tmp_path):
        """A modify that changes values under unchanged ids must rewrite
        the touched partition, not be skipped by the incremental save."""
        out = {}
        for P in BOTH:
            ds = _store(P, n=40)
            root = tmp_path / P.name
            P.persist.save(ds, root)
            ds.modify_features("t", {"name": "UPDATED"}, "IN ('f0')")
            P.persist.save(ds, root)  # incremental save over the old manifest
            back = _load(P, root)
            row = back.query("t", "IN ('f0')")
            assert np.asarray(row.columns["name"])[0] == "UPDATED"
            out[P.name] = _ids(back)
        assert out["port"] == out["jax"]

    def test_roundtrip_with_object_ids_persists(self, tmp_path):
        out = {}
        for P in BOTH:
            sft = P.pkg.FeatureType.from_spec("m", "name:String,*geom:Point:srid=4326")
            ds = P.pkg.DataStore(**P.kw)
            ds.create_schema(sft)
            ds.write("m", P.pkg.FeatureCollection.from_columns(
                sft, self._obj(["a\nb", "c:d", "e"]),
                {"name": np.array(["a", "b", "c"]), "geom": (np.zeros(3), np.zeros(3))},
            ))
            P.persist.save(ds, tmp_path / P.name)
            back = _load(P, tmp_path / P.name)
            assert len(back.features("m")) == 3
            out[P.name] = _ids(back, "m")
        assert out["port"] == out["jax"]
        assert _manifest(tmp_path / "port") == _manifest(tmp_path / "jax")


class TestFaultPointCoverage:
    def test_load_partition_read_transient_fault_retried(self, tmp_path):
        for P in BOTH:
            ds = _store(P, n=40)
            P.persist.save(ds, tmp_path / P.name)
            with P.fault.inject("load.partition.read", kind="io_error", times=1) as spec:
                back = _load(P, tmp_path / P.name)
            assert spec.fired == 1
            assert sorted(_ids(back)) == sorted(_ids(ds))
            assert back.store_health.status == "ok"

    def test_metadata_write_and_rename_points_fire(self, tmp_path):
        from geomesa_tpu.storage.metadata import FileMetadata as JFile
        from geomesa_tpu_torch.storage.metadata import FileMetadata as TFile

        for P, File in ((JAX, JFile), (PORT, TFile)):
            md = File(str(tmp_path / P.name))
            with P.fault.inject("metadata.write", kind="latency", times=None, delay_s=0.0) as w:
                with P.fault.inject("metadata.rename", kind="io_error", times=1) as r:
                    md.insert("schema/t", "spec")  # one blip, retried inside
            assert w.fired >= 1 and r.fired == 1
            assert md.get("schema/t") == "spec"

    def test_adapter_create_table_point_fires(self):
        for P in BOTH:
            with P.fault.inject("adapter.create_table", kind="latency", times=None,
                                delay_s=0.0) as spec:
                ds = _store(P, n=30)
                ds.compact("t")
            assert spec.fired >= 1
            assert ds.count("t") == 30

    def test_every_persist_point_is_reached_by_a_save(self, tmp_path):
        """A save over a committed store with an append reaches each of
        the seven persist.* points, in both packages, as often."""
        hits = {}
        for P in BOTH:
            ds = _store(P)
            root = tmp_path / P.name
            P.persist.save(ds, root)
            _append(P, ds, 0)
            specs = {p: P.fault.injector().install(
                P.fault.FaultSpec(point=p, kind="latency", times=None)) for p in PERSIST_POINTS}
            P.persist.save(ds, root)
            hits[P.name] = {p: s.fired for p, s in specs.items()}
            assert all(hits[P.name].values()), hits[P.name]
        assert hits["port"] == hits["jax"]


# -- the on-disk store carried across -----------------------------------------

ATTR_SPEC = "code:String:index=true,rank:Integer,score:Double,flag:Boolean,dtg:Date,*geom:Point:srid=4326"
EXT_SPEC = "tag:String,dtg:Date,*geom:Polygon:srid=4326"
QUERIES = {
    "pts": ["bbox(geom, -30, -20, 10, 10)", "INCLUDE",
            "bbox(geom, -50, -50, 50, 50) AND dtg DURING 2024-01-20T00:00:00Z/2024-02-20T00:00:00Z",
            "code = 'b' OR rank > 7", "code >= 'c'", "IN ('3', '77', '150', '9999')"],
    "ext": ["bbox(geom, -30, -20, 10, 10)", "INCLUDE",
            "INTERSECTS(geom, POLYGON ((0 0, 30 0, 15 25, 0 0))) AND "
            "dtg DURING 2024-01-10T00:00:00Z/2024-03-01T00:00:00Z",
            "tag = 'b'"],
}


def _cross_store(P, schema, n=2_000, seed=4):
    rng = np.random.default_rng(seed)
    x0, y0 = rng.uniform(-50, 48, n), rng.uniform(-50, 48, n)
    t = T0 + rng.integers(0, 90 * DAY, n)
    tags = np.array(["a", "b", "cc", "dddd"])[rng.integers(0, 4, n)]
    if schema == "pts":
        sft = P.pkg.FeatureType.from_spec("pts", ATTR_SPEC)
        cols = {"code": tags, "rank": rng.integers(0, 10, n).astype(np.int32),
                "score": rng.normal(0, 5, n), "flag": rng.uniform(size=n) < 0.5,
                "dtg": t, "geom": (x0, y0)}
    else:
        sft = P.pkg.FeatureType.from_spec("ext", EXT_SPEC)
        w, h = rng.uniform(0.01, 2, n), rng.uniform(0.01, 2, n)
        cols = {"tag": tags, "dtg": t,
                "geom": P.pkg.geometry.PackedGeometryColumn.from_boxes(x0, y0, x0 + w, y0 + h)}
    sft.user_data["geomesa.z3.interval"] = "week"
    ds = P.pkg.DataStore(tile=1024, **P.kw)
    ds.create_schema(sft)
    ds.write(sft.name, P.pkg.FeatureCollection.from_columns(sft, np.arange(n // 2), {
        k: (tuple(c[: n // 2] for c in v) if isinstance(v, tuple) else
            (v.take(np.arange(n // 2)) if hasattr(v, "bboxes") else v[: n // 2]))
        for k, v in cols.items()}))
    ds.write(sft.name, P.pkg.FeatureCollection.from_columns(sft, np.arange(n // 2, n), {
        k: (tuple(c[n // 2:] for c in v) if isinstance(v, tuple) else
            (v.take(np.arange(n // 2, n)) if hasattr(v, "bboxes") else v[n // 2:]))
        for k, v in cols.items()}))
    return ds


def _answers(ds, schema) -> list:
    out = [np.asarray(ds.query(schema, q).ids).tolist() for q in QUERIES[schema]]
    out.append(np.asarray(ds.query(schema, QUERIES[schema][0], limit=7).ids).tolist())
    return out


@pytest.mark.parametrize("schema", ["pts", "ext"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_load_answers_alike(tmp_path, schema, writer):
    """A store saved by one package loads in the other; the loaded stores
    answer every query with the same ids in the same order, and the two
    packages' own saves of the same data give the same manifest."""
    src = {P.name: _cross_store(P, schema) for P in BOTH}
    for P in BOTH:
        P.persist.save(src[P.name], tmp_path / P.name)
    assert _manifest(tmp_path / "port") == _manifest(tmp_path / "jax")
    root = tmp_path / writer
    loaded = {P.name: _load(P, root) for P in BOTH}
    want = _answers(src["jax"], schema)
    assert sum(map(len, want)) > 0
    for P in BOTH:
        back = loaded[P.name]
        assert back.store_health.status == "ok"
        assert back.get_schema(schema).to_spec() == src["jax"].get_schema(schema).to_spec()
        assert _answers(back, schema) == _answers(loaded["jax"], schema)
    assert _ids(loaded["port"], schema) == _ids(loaded["jax"], schema)
    # every column of the loaded rows carried across, dtypes included
    a, b = loaded["port"].features(schema), loaded["jax"].features(schema)
    for name in a.columns:
        ca, cb = a.columns[name], b.columns[name]
        if hasattr(ca, "bboxes"):
            for f in ("coords", "ring_offsets", "part_ring_offsets", "geom_part_offsets",
                      "types", "bboxes"):
                x, y = getattr(ca, f), getattr(cb, f)
                assert x.dtype == y.dtype and np.array_equal(x, y), (name, f)
        elif hasattr(ca, "x"):
            assert np.array_equal(ca.x, cb.x) and np.array_equal(ca.y, cb.y)
        else:
            assert np.asarray(ca).dtype == np.asarray(cb).dtype, name
            assert np.array_equal(np.asarray(ca), np.asarray(cb)), name


def test_loaded_aggregations_equal_the_jax_package(tmp_path):
    src = _cross_store(JAX, "pts")
    jpersist.save(src, tmp_path / "s")
    t, j = _load(PORT, tmp_path / "s"), _load(JAX, tmp_path / "s")
    q = "bbox(geom, -40, -40, 40, 40) AND dtg DURING 2024-01-05T00:00:00Z/2024-03-01T00:00:00Z"
    assert t.count("pts", q) == j.count("pts", q)
    assert np.array_equal(t.density("pts", q, width=16, height=8),
                          j.density("pts", q, width=16, height=8))
    for est in (True, False):
        assert t.bounds("pts", q, estimate=est) == j.bounds("pts", q, estimate=est)
    assert [s.to_json() for s in t.stats_query("pts", "Count();MinMax(rank)", q)] == \
        [s.to_json() for s in j.stats_query("pts", "Count();MinMax(rank)", q)]


def test_bytes_and_null_columns_carry_across(tmp_path):
    """A Bytes attribute (with a null) and a string attribute with a None
    round-trip through either package's save into the other's load."""
    out = {}
    for P in BOTH:
        sft = P.pkg.FeatureType.from_spec("b", "blob:Bytes,label:String,*geom:Point:srid=4326")
        ds = P.pkg.DataStore(**P.kw)
        ds.create_schema(sft)
        blob = np.empty(3, dtype=object)
        blob[:] = [b"\x00\x01", None, b""]
        label = np.empty(3, dtype=object)
        label[:] = ["x", None, "zz"]
        ds.write("b", P.pkg.FeatureCollection.from_columns(
            sft, ["a", "b", "c"], {"blob": blob, "label": label,
                                   "geom": (np.zeros(3), np.ones(3))}))
        P.persist.save(ds, tmp_path / P.name)
    for writer in ("jax", "port"):
        for P in BOTH:
            back = _load(P, tmp_path / writer)
            fc = back.features("b")
            out[(writer, P.name)] = (np.asarray(fc.ids).tolist(),
                                     list(fc.columns["blob"]), list(fc.columns["label"]))
    assert len(set(map(repr, out.values()))) == 1
    assert out[("jax", "port")][1] == [b"\x00\x01", None, b""]


def _legacy(tmp_path, version):
    """A pre-v3 directory (v2: per-partition files under a manifest of
    signatures; v1: one npz per type), written by hand from the JAX
    package's packing."""
    src = _store(JAX, n=80, seed=6)
    sft = src.get_schema("t")
    fc = src.features("t")
    root = tmp_path / f"v{version}"
    os.makedirs(root)
    info = {"spec": sft.to_spec(), "user_data": {}}
    if version == 1:
        np.savez_compressed(root / "t.npz", **jpersist._pack_columns(sft, fc))
    else:
        os.makedirs(root / "t")
        parts = jpersist._partition_ids(fc, sft.dtg_field)
        info["partitions"] = {}
        for p in np.unique(parts):
            sub = fc.take(np.flatnonzero(parts == p))
            packed = jpersist._pack_columns(sft, sub)
            fname = f"p{int(p)}.npz"
            np.savez_compressed(root / "t" / fname, **packed)
            info["partitions"][fname] = jpersist._signature(np.asarray(sub.ids), packed)
    json.dump({"version": version, "types": {"t": info}}, open(root / "metadata.json", "w"))
    return root, src


@pytest.mark.parametrize("version", [1, 2])
def test_legacy_layouts_load_alike(tmp_path, version):
    root, src = _legacy(tmp_path, version)
    loaded = {P.name: _load(P, root) for P in BOTH}
    assert _ids(loaded["port"]) == _ids(loaded["jax"])
    assert sorted(_ids(loaded["port"])) == sorted(_ids(src))
    q = "bbox(geom, -40, -40, 20, 30)"
    assert np.asarray(loaded["port"].query("t", q).ids).tolist() == \
        np.asarray(loaded["jax"].query("t", q).ids).tolist()
    # a v3 save over the legacy directory converges on the v3 layout (its
    # rows in partition order), and both packages read it back alike
    tpersist.save(loaded["port"], root)
    assert json.load(open(root / "metadata.json"))["version"] == 3
    again = {P.name: _ids(_load(P, root)) for P in BOTH}
    assert again["port"] == again["jax"] and sorted(again["port"]) == sorted(_ids(src))


def test_unsupported_format_and_unsafe_names_refused(tmp_path):
    for P in BOTH:
        root = tmp_path / P.name
        os.makedirs(root)
        json.dump({"version": 9, "types": {}}, open(root / "metadata.json", "w"))
        with pytest.raises(ValueError, match="unsupported"):
            _load(P, root)
        json.dump({"version": 3, "types": {"../x": {"spec": SPEC, "partitions": {}}}},
                  open(root / "metadata.json", "w"))
        with pytest.raises(P.persist.StoreCorruptionError):
            _load(P, root)


def test_load_builds_every_table_through_the_bulk_commit(tmp_path, monkeypatch):
    """persist.load publishes each type's rows with one _bulk_commit: one
    compaction, every index table built, ids in the JAX load's order."""
    from geomesa_tpu_torch.datastore import DataStore

    src = _cross_store(JAX, "pts")
    jpersist.save(src, tmp_path / "s")
    calls = []
    orig = DataStore._bulk_commit
    monkeypatch.setattr(DataStore, "_bulk_commit",
                        lambda self, *a, **k: calls.append(a[0]) or orig(self, *a, **k))
    back = _load(PORT, tmp_path / "s")
    assert calls == ["pts"]
    assert back.row_count("pts") == back._main_rows["pts"] == 2_000  # no delta left
    assert sorted(i.name for i in back.indexes("pts")) == sorted(
        k[1] for k in back._tables)
    assert _ids(back, "pts") == _ids(_load(JAX, tmp_path / "s"), "pts")
