"""The port's pod tier against the JAX package's.

- host groups: host-major slices shared with the flat multihost mesh,
  the sim driver over an explicit device list, knob resolution, the
  distributed driver raising ``PodUnsupported`` in a single process, the
  per-host link caps and their stamping onto each host's shards;
- ``PodIndexTable`` on a sim group of 4 hosts x 2 ``"cpu"`` shards
  against the JAX pod table on ``make_host_group(4, 2, "sim")`` and
  against the port's flat 8-shard mesh over the same devices: the z2/z3
  and xz matrix of ``tests/test_pod_table.py``, ids in order, counts,
  density grids, bounds, explain, the cross-host fused batch, mixed
  per-host slot caps and the ``pod.dispatch`` / ``pod.join`` fault
  points; a selective query launches nothing on hosts that own none of
  its blocks;
- ``PodStore`` against the JAX ``PodStore`` with the same seeds and
  fault points: routed writes, deletes and alerts, auto ids, ownership,
  host-local bulk loads, a host killed mid-flush and rejoined, the WAL
  route and replay fault points;
- the two-process gloo probe (the counterpart of
  ``tests/test_multihost_mesh.py::test_two_process_probe``).

Both packages run with their native helpers. Tolerance: exact.
"""

import zlib

import numpy as np
import pytest

from geomesa_tpu import fault as jfault
from geomesa_tpu import geometry as jgeo
from geomesa_tpu.datastore import DataStore as JDataStore
from geomesa_tpu.features import FeatureCollection as JFC
from geomesa_tpu.pod import PodStore as JPodStore
from geomesa_tpu.pod import make_host_group as jmake_host_group
from geomesa_tpu.sft import FeatureType as JFT
from geomesa_tpu.streaming.standing import Subscription as JSubscription
from geomesa_tpu.streaming.wal import WalConfig as JWalConfig
from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType, conf
from geomesa_tpu_torch import fault as tfault
from geomesa_tpu_torch import geometry as tgeo
from geomesa_tpu_torch.parallel import DistributedIndexTable
from geomesa_tpu_torch.parallel.mesh import host_major_slices
from geomesa_tpu_torch.pod import (
    PodIndexTable, PodStore, PodUnsupported, make_host_group, probe_capability,
)
from geomesa_tpu_torch.scan import block_kernels as bk
from geomesa_tpu_torch.storage.table import FUSED_CHUNK_SLOTS
from geomesa_tpu_torch.streaming.standing import Subscription
from geomesa_tpu_torch.streaming.wal import WalConfig
from test_pod_table import Q_POLY, Q_PTS
from test_torch_native import ensure_jax_native

CPU8 = ["cpu"] * 8
DAY = 86_400_000
T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
N_PTS = 40_000  # ten 4,096-row blocks: every host owns a real run
N_POLY = 8_000


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    ensure_jax_native()


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    jfault.injector().reset()
    tfault.injector().reset()


def _group(**kw):
    return make_host_group(hosts=4, devices_per_host=2, driver="sim", devices=CPU8, **kw)


def _ids(fc) -> list:
    return np.asarray(fc.ids).astype(str).tolist()


# -- host groups -------------------------------------------------------------


def test_sim_slices_are_host_major_and_agree_with_the_flat_mesh():
    group = _group()
    assert (group.driver, group.hosts, group.devices_per_host) == ("sim", 4, 2)
    jgroup = jmake_host_group(4, 2, driver="sim")
    assert [len(s) for s in group.device_slices] == [len(s) for s in jgroup.device_slices]
    for h in range(4):
        assert group.mesh(h).devices == group.device_slices[h] and group.mesh(h) is group.mesh(h)
    assert group.flat_mesh().devices == group.devices and len(group.devices) == 8
    ids = list(range(8))
    assert host_major_slices(ids, 4, 2) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert make_host_group(hosts=2, driver="sim", devices=CPU8).devices_per_host == 4


@pytest.mark.parametrize("case", ["no_count", "too_few", "unknown", "no_cards"])
def test_sim_driver_refusals(case):
    if case == "no_count":
        with pytest.raises(ValueError, match="host count"):
            make_host_group(driver="sim", devices=CPU8)
    elif case == "too_few":
        with pytest.raises(PodUnsupported, match="devices"):
            make_host_group(hosts=64, driver="sim", devices=CPU8)
    elif case == "unknown":
        with pytest.raises(ValueError, match="driver"):
            make_host_group(hosts=2, driver="nope", devices=CPU8)
    else:  # no card here: the visible devices back nothing
        with pytest.raises(PodUnsupported, match="0 devices"):
            make_host_group(hosts=2, driver="sim")


def test_knobs_settle_the_group():
    from geomesa_tpu import conf as jconf

    for c in (conf, jconf):
        c.POD_HOSTS.set(2)
        c.POD_DEVICES_PER_HOST.set(3)
        c.POD_DRIVER.set("sim")
    try:
        group = make_host_group(devices=CPU8)
        jgroup = jmake_host_group()
        assert (group.hosts, group.devices_per_host) == (jgroup.hosts, jgroup.devices_per_host)
        assert (group.hosts, group.devices_per_host, group.driver) == (2, 3, "sim")
    finally:
        for c in (conf, jconf):
            c.POD_HOSTS.clear()
            c.POD_DEVICES_PER_HOST.clear()
            c.POD_DRIVER.clear()


def test_distributed_driver_in_one_process_raises_pod_unsupported():
    """A single-process world never runs the distributed driver; the
    verdict of the gloo probe says why (here: supported, but this process
    is no multi-process world)."""
    v = probe_capability()
    assert v["verdict"] in ("supported", "UNSUPPORTED", "error")
    assert v["supported"] == (v["verdict"] == "supported") and "reason" in v
    with pytest.raises(PodUnsupported, match="torch.distributed|unavailable"):
        make_host_group(driver="distributed", devices=CPU8)


def test_link_caps_ride_the_doubling_ladder_per_host():
    group, jgroup = _group(), jmake_host_group(4, 2, driver="sim")
    rtts = [66.0, 0.4, None, 16.5]
    caps = group.set_link_profile(rtts)
    assert caps == jgroup.set_link_profile(rtts) == [FUSED_CHUNK_SLOTS, 256, None, 512]
    assert [group.slot_cap(h) for h in range(4)] == caps and group.link_rtts_ms == rtts
    assert bk.fused_slot_cap(caps[1]) == 256 and bk.fused_slot_cap(None) == FUSED_CHUNK_SLOTS
    with pytest.raises(ValueError, match="RTTs"):
        group.set_link_profile([1.0])
    measured = make_host_group(hosts=2, devices_per_host=2, driver="sim",
                               devices=CPU8).probe_links(samples=1)
    assert len(measured) == 2 and all(r >= 0 for r in measured)
    conf.SCAN_FUSED_SLOTS.set(512)
    try:
        assert bk.fused_slot_cap(2048) == 512  # the pinned knob beats a host's cap
    finally:
        conf.SCAN_FUSED_SLOTS.clear()


# -- the pod table -----------------------------------------------------------


def _point_cols(n=N_PTS, seed=7):
    rng = np.random.default_rng(seed)
    return [str(i) for i in range(n)], {
        "kind": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
        "dtg": T0 + rng.integers(0, 20 * DAY, n),
        "geom": (rng.uniform(-60, 60, n), rng.uniform(-45, 45, n)),
    }


def _poly_cols(geo, n=N_POLY, seed=9):
    rng = np.random.default_rng(seed)
    x0, y0 = rng.uniform(-60, 59, n), rng.uniform(-45, 44, n)
    polys = geo.PackedGeometryColumn.from_boxes(
        x0, y0, x0 + rng.uniform(0.01, 0.8, n), y0 + rng.uniform(0.01, 0.6, n))
    return [str(i) for i in range(n)], {"dtg": T0 + rng.integers(0, 20 * DAY, n), "geom": polys}


def _stores(mesh, jax: bool):
    make = (lambda: JDataStore(tile=64, mesh=mesh)) if jax else \
        (lambda: DataStore(device="cpu", tile=64, mesh=mesh))
    FT, FC, geo = (JFT, JFC, jgeo) if jax else (FeatureType, FeatureCollection, tgeo)
    out = {}
    for name, spec, (ids, cols) in (
        ("pts", "kind:String:index=true,dtg:Date,*geom:Point:srid=4326", _point_cols()),
        ("bld", "dtg:Date,*geom:Polygon:srid=4326", _poly_cols(geo)),
    ):
        ds = make()
        ds.create_schema(FT.from_spec(name, spec))
        ds.write(name, FC.from_columns(ds.get_schema(name), ids, cols))
        out[name] = ds
    return out


@pytest.fixture(scope="module")
def pods():
    """name -> (JAX pod store, port pod store, port flat-mesh store)."""
    group = _group()
    jax_pod = _stores(jmake_host_group(4, 2, driver="sim"), jax=True)
    pod, flat = _stores(group, jax=False), _stores(group.flat_mesh(), jax=False)
    return {k: (jax_pod[k], pod[k], flat[k]) for k in pod}


def test_pod_tables_cut_host_major(pods):
    _, pod, flat = pods["pts"]
    table, ftable = pod.table("pts", "z3"), flat.table("pts", "z3")
    assert isinstance(table, PodIndexTable) and type(ftable) is DistributedIndexTable
    assert table.n_blocks == ftable.n_blocks and table.n_blocks % 8 == 0
    assert [sh.mesh for sh in table.shards] == [table.group.mesh(h) for h in range(4)]
    for h, sh in enumerate(table.shards):
        assert sh.n_blocks == table.blocks_per_host and sh.n_devices == 2
        r0 = h * table.rows_per_host
        for k in ("x", "y"):
            got = np.stack([t.numpy() for t in sh.cols3[k]], 1).reshape(-1)
            want = np.stack([t.numpy() for t in ftable.cols3[k]], 1).reshape(-1)
            assert np.array_equal(got, want[r0 : r0 + table.rows_per_host]), (h, k)
    assert table.nbytes_device == ftable.nbytes_device


@pytest.mark.parametrize("qi", range(len(Q_PTS)))
def test_point_queries_equal_the_jax_pod_and_the_flat_mesh(pods, qi):
    jpod, pod, flat = pods["pts"]
    q = Q_PTS[qi]
    got = _ids(pod.query("pts", q))
    assert got == _ids(jpod.query("pts", q)) == _ids(flat.query("pts", q))
    assert pod.count("pts", q) == jpod.count("pts", q) == len(got)


@pytest.mark.parametrize("qi", range(len(Q_POLY)))
def test_extent_queries_equal_the_jax_pod_and_the_flat_mesh(pods, qi):
    jpod, pod, flat = pods["bld"]
    q = Q_POLY[qi]
    got = _ids(pod.query("bld", q))
    assert got == _ids(jpod.query("bld", q)) == _ids(flat.query("bld", q)) and got
    assert pod.count("bld", q) == jpod.count("bld", q)


def test_aggregations_and_explain_equal_the_jax_pod(pods):
    jpod, pod, flat = pods["pts"]
    env = (-60, -45, 60, 45)
    for q in (Q_PTS[0], Q_PTS[2]):
        g = pod.density("pts", q, envelope=env, width=32, height=16)
        assert np.array_equal(g, np.asarray(jpod.density("pts", q, envelope=env, width=32,
                                                         height=16)))
        assert np.array_equal(g, flat.density("pts", q, envelope=env, width=32, height=16))
        assert pod.bounds("pts", q) == jpod.bounds("pts", q) == flat.bounds("pts", q)
        est = [s.stats_query("pts", "Count()", q, estimate=True)[0].count
               for s in (pod, jpod, flat)]
        assert est[0] == est[1] == est[2] > 0
    for tn, queries in (("pts", Q_PTS), ("bld", Q_POLY)):
        jp, p, _ = pods[tn]
        for q in queries:
            assert p.explain(tn, q) == jp.explain(tn, q)


def test_query_many_crosses_hosts_fused(pods, monkeypatch):
    jpod, pod, flat = pods["pts"]
    calls = []
    orig = DistributedIndexTable._fused_raw_finishes

    def spy(self, *a, **kw):
        calls.append(self)
        return orig(self, *a, **kw)

    monkeypatch.setattr(DistributedIndexTable, "_fused_raw_finishes", spy)
    rng = np.random.default_rng(21)
    boxes = []
    for _ in range(10):
        x0, y0 = rng.uniform(-55, 30), rng.uniform(-40, 20)
        boxes.append(f"bbox(geom, {x0:.3f}, {y0:.3f}, {x0 + 18:.3f}, {y0 + 14:.3f})")
    batch = boxes + Q_PTS
    got = [_ids(o) for o in pod.query_many("pts", batch)]
    assert got == [_ids(o) for o in jpod.query_many("pts", batch)]
    shards = {sh for t in pod._tables.values() if isinstance(t, PodIndexTable) for sh in t.shards}
    assert any(c in shards for c in calls), "the pod batch never took the fused launch"
    assert got == [_ids(o) for o in flat.query_many("pts", batch)]
    assert sum(len(g) for g in got[:10]) > 0
    jb, b, fb = pods["bld"]
    assert [_ids(o) for o in b.query_many("bld", Q_POLY)] == \
        [_ids(o) for o in jb.query_many("bld", Q_POLY)]


def test_a_selective_query_launches_only_on_owning_hosts(pods, monkeypatch):
    """Non-owning hosts do no work: every shard call of a selective query
    lands on a host that owns one of its candidate blocks, and at least
    one host is left out."""
    _, pod, _ = pods["pts"]
    table = pod.table("pts", "z2")
    host_of = {id(sh): h for h, sh in enumerate(table.shards)}
    seen = []
    for name in ("_device_scan_submit", "_device_pops", "_device_density_submit",
                 "_device_bounds"):
        orig = getattr(DistributedIndexTable, name)

        def spy(self, blocks, *a, _orig=orig, **kw):
            seen.append(host_of.get(id(self)))
            return _orig(self, blocks, *a, **kw)

        monkeypatch.setattr(DistributedIndexTable, name, spy)
    q = "bbox(geom, -50, -40, -45, -35)"
    plan = pod.planner.plan("pts", q)
    assert plan.index == "z2"
    overlap, contained = table.candidate_spans_split(plan.config)
    from geomesa_tpu_torch.storage.table import _merge_spans

    owners = {h for h, _ in table._host_blocks(
        table.candidate_blocks(_merge_spans(overlap + contained)))}
    pod.query("pts", q)
    pod.stats_query("pts", "Count()", q, estimate=True)
    pod.bounds("pts", q)
    pod.density("pts", q, envelope=(-60, -45, 60, 45), width=8, height=8)
    assert seen and set(seen) <= owners and len(owners) < table.hosts


def test_mixed_link_profile_stays_bit_identical():
    group = _group()
    group.set_link_profile([0.4, 66.0, 8.25, None])
    pod = _stores(group, jax=False)["pts"]
    flat = _stores(group.flat_mesh(), jax=False)["pts"]
    assert len({s._slot_cap for s in pod.table("pts", "z2").shards}) > 1
    assert [s._slot_cap for s in pod.table("pts", "z2").shards] == group.slot_caps
    for q in (Q_PTS[0], Q_PTS[2], Q_PTS[3]):
        assert _ids(pod.query("pts", q)) == _ids(flat.query("pts", q))
    assert [_ids(o) for o in pod.query_many("pts", Q_PTS[:4])] == \
        [_ids(o) for o in flat.query_many("pts", Q_PTS[:4])]


@pytest.mark.parametrize("point", ["pod.dispatch", "pod.join"])
def test_pod_fault_points_surface_and_recover(pods, point):
    jpod, pod, _ = pods["pts"]
    for P, ds in ((jfault, jpod), (tfault, pod)):
        with P.inject(point, kind="io_error", times=1):
            with pytest.raises(OSError):
                ds.count("pts", Q_PTS[0]) if point == "pod.join" else ds.query("pts", Q_PTS[0])
    assert _ids(pod.query("pts", Q_PTS[0])) == _ids(jpod.query("pts", Q_PTS[0]))


# -- the pod store -----------------------------------------------------------

JAX = dict(geo=jgeo, Pod=JPodStore, FT=JFT, Sub=JSubscription, Wal=JWalConfig, fault=jfault,
           group=lambda: jmake_host_group(4, 2, driver="sim"))
PORT = dict(geo=tgeo, Pod=PodStore, FT=FeatureType, Sub=Subscription, Wal=WalConfig,
            fault=tfault, group=_group)


def _rows(P, n, seed):
    r = np.random.default_rng(seed)
    return [{"dtg": int(T0 + r.integers(0, 10 * DAY)),
             "geom": P["geo"].Point(float(r.uniform(-60, 60)), float(r.uniform(-30, 30)))}
            for _ in range(n)]


def _subs(P):
    return [
        P["Sub"]("fence", "geofence", geom=P["geo"].Polygon(
            [(-20.0, -20.0), (20.0, -20.0), (20.0, 20.0), (-20.0, 20.0)])),
        P["Sub"]("near", "proximity", points=np.array([[5.0, 5.0], [-40.0, 10.0]]),
                 distance_m=400_000.0),
    ]


def _pod(P, root=None):
    return P["Pod"](P["FT"].from_spec("pd", "dtg:Date,*geom:Point:srid=4326"), P["group"](),
                    root=None if root is None else str(root), wal_config=P["Wal"](sync="always"))


def _alerts(alerts):
    return sorted((a["sub"], a["kind"], a["id"]) for a in alerts)


def _routed_run(P):
    pod = _pod(P)
    out = []
    try:
        for s in _subs(P):
            pod.subscribe(s)
        out.append(pod.write(_rows(P, 300, 1), [f"f{i}" for i in range(300)]))
        out.append(pod.write(_rows(P, 200, 2), [f"g{i}" for i in range(200)]))
        out.append(_alerts(pod.drain_alerts()))
        out += [pod.count(), sorted(_ids(pod.query()))]
        out.append(pod.delete([f"f{i}" for i in range(0, 300, 3)]))
        out += [pod.count(), sorted(_ids(pod.query())), pod.unsubscribe("fence")]
        pod.write(_rows(P, 100, 3), [f"h{i}" for i in range(100)])
        out.append(_alerts(pod.drain_alerts()))
        out.append(pod.write(_rows(P, 50, 4)))  # auto ids
        out.append([sorted(_ids(pod.stores[h].query())) for h in range(4)])
    finally:
        pod.close()
    return out


def test_routed_writes_deletes_and_alerts_equal_the_jax_pod():
    got, want = _routed_run(PORT), _routed_run(JAX)
    assert got == want
    assert got[2] and {k for _, k, _ in got[2]} == {"geofence", "proximity"}
    assert all(s != "fence" for s, _, _ in got[9])
    per_host = got[-1]
    assert all(per_host) and sum(map(len, per_host)) == got[6] + 100 + 50
    assert all(zlib.crc32(i.encode()) % 4 == h for h, ids in enumerate(per_host) for i in ids)


def test_bulk_load_is_host_local_and_equals_routed_writes():
    pod = _pod(PORT)
    try:
        rng = np.random.default_rng(8)
        n = 400
        fc = FeatureCollection.from_columns(
            pod.stores[0].cold.get_schema("pd"), [f"bl{i}" for i in range(n)],
            {"dtg": T0 + rng.integers(0, 10 * DAY, n),
             "geom": (rng.uniform(-60, 60, n), rng.uniform(-30, 30, n))})
        results = pod.bulk_load(fc)
        assert len(results) == 4 and sum(r.written for r in results if r is not None) == n
        assert pod.count() == n and sorted(_ids(pod.query())) == sorted(fc.ids.astype(str))
        for h in range(4):
            assert isinstance(pod.stores[h].cold.table("pd", "z3"), DistributedIndexTable)
            assert all(pod.owner(i) == h for i in _ids(pod.stores[h].query()))
    finally:
        pod.close()


def _kill_run(P, root):
    """A host crashed inside its flush, killed and rejoined, beside a
    never-crashed pod; returns what both answer."""
    pod, ref = _pod(P, root / "crash"), _pod(P, root / "ref")
    out = []
    try:
        for s in _subs(P):
            pod.subscribe(s)
            ref.subscribe(P["Sub"].from_record(s.to_record()))
        b0, ids0 = _rows(P, 300, 10), [f"f{i}" for i in range(300)]
        pod.write(b0, ids0), ref.write(b0, ids0)
        out.append(_alerts(pod.drain_alerts()) == _alerts(ref.drain_alerts()))
        pod.flush(), ref.flush()
        pod.checkpoint(), ref.checkpoint()
        b1, ids1 = _rows(P, 160, 11), [f"g{i}" for i in range(160)]
        out.append(pod.write(b1, ids1) == ref.write(b1, ids1) == 160)
        ref.flush()
        with P["fault"].inject("streaming.persist", kind="crash", times=1):
            with pytest.raises(P["fault"].InjectedCrash):
                pod.stores[2].flush()
        pod.kill(2)
        with pytest.raises(RuntimeError, match="down"):
            pod.count()
        out.append(all(sorted(_ids(pod.stores[h].query())) == sorted(_ids(ref.stores[h].query()))
                       for h in (0, 1, 3)))
        pod.rejoin(2)
        out += [pod.count(), sorted(_ids(pod.query())) == sorted(_ids(ref.query()))]
        pa, ra = pod.drain_alerts(), ref.drain_alerts()
        out.append(_alerts([a for a in pa if pod.owner(a["id"]) != 2])
                   == _alerts([a for a in ra if ref.owner(a["id"]) != 2]))
        b2, ids2 = _rows(P, 80, 12), [f"k{i}" for i in range(80)]
        pod.write(b2, ids2), ref.write(b2, ids2)
        alerts = _alerts(pod.drain_alerts())
        out += [alerts == _alerts(ref.drain_alerts()), alerts, sorted(_ids(pod.query()))]
    finally:
        pod.close(), ref.close()
    return out


def test_a_host_killed_mid_flush_rejoins_like_the_jax_pod(tmp_path):
    got = _kill_run(PORT, tmp_path / "port")
    assert got == _kill_run(JAX, tmp_path / "jax")
    assert got[:3] == [True, True, True] and got[3] == 460 and all(got[4:7]) and got[7]


def test_acked_rows_survive_a_kill_without_any_flush(tmp_path):
    pod = _pod(PORT, tmp_path / "p")
    try:
        assert pod.write(_rows(PORT, 240, 13), [f"f{i}" for i in range(240)]) == 240
        before = sorted(_ids(pod.query()))
        pod.kill(1)
        pod.rejoin(1)
        assert sorted(_ids(pod.query())) == before and pod.count() == 240
        assert isinstance(pod.stores[1].cold, DataStore) and pod.stores[1].cold.mesh.size == 2
    finally:
        pod.close()


@pytest.mark.parametrize("P", [JAX, PORT], ids=["jax", "port"])
def test_wal_route_and_replay_fault_points(P, tmp_path):
    pod = _pod(P, tmp_path / "p")
    try:
        ids = [f"f{i}" for i in range(120)]
        rows = _rows(P, 120, 14)
        with P["fault"].inject("pod.wal.route", kind="io_error", after=1, times=1):
            with pytest.raises(OSError):
                pod.write(rows, ids)
        partial = pod.count()
        assert 0 < partial < 120
        assert pod.write(rows, ids) == 120 and pod.count() == 120
        assert sorted(_ids(pod.query())) == sorted(ids)
        pod.kill(3)
        with P["fault"].inject("pod.wal.replay", kind="crash", times=1):
            with pytest.raises(P["fault"].InjectedCrash):
                pod.rejoin(3)
        with pytest.raises(RuntimeError, match="down"):
            pod.count()
        pod.rejoin(3)
        assert sorted(_ids(pod.query())) == sorted(ids)
        with pytest.raises(RuntimeError, match="not down"):
            pod.rejoin(0)
    finally:
        pod.close()
    bare = _pod(P)
    try:
        with pytest.raises(ValueError, match="root"):
            bare.checkpoint()
    finally:
        bare.close()


# -- the two-process probe ---------------------------------------------------


def test_two_process_gloo_probe():
    """Two real processes in one gloo world, each a 4-shard CPU mesh
    store, one density all-reduce across the process boundary, held
    against a one-device store over both halves."""
    import os
    import subprocess
    import sys

    script = os.path.join(os.path.dirname(__file__), "..", "geomesa_tpu_torch", "scripts",
                          "probe_multiprocess.py")
    out = subprocess.run([sys.executable, os.path.abspath(script)], capture_output=True,
                         text=True, timeout=120, start_new_session=True)
    assert out.returncode == 0, (out.stdout[-800:], out.stderr[-800:])
    assert "cross-process density sum" in out.stdout and "supported" in out.stdout
