"""The port's shard mesh and distributed table against the JAX package's.

``DataStore(mesh=...)`` of the port on explicit virtual meshes of D
``"cpu"`` shards (D = 1, 3, 8) against the JAX store on ``make_mesh(D)``
of the forced 8-device CPU platform (tests/conftest.py), both fed the
same seeded numpy rows and ``tests/test_parallel.py``'s queries, both
with their native helpers. Tolerance: exact everywhere. Ids are compared
in order (and under ``limit``), fused batches, counts and count
estimates, density grids word for word and bounds; the mesh table's
ordinals and certainty flags equal the one-device table's; a skewed
fused chunk splits as the JAX package's does; a mesh store's writes and
compactions rebuild the mesh table and never fold. No fallback:
``make_mesh(n)`` past the visible cards raises, so does a mesh whose
devices disagree with the store's, and a shard on a device without a
kernel raises instead of taking a plain version.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu.datastore import DataStore as JDataStore
from geomesa_tpu.features import FeatureCollection as JFC
from geomesa_tpu.parallel import make_mesh as jmake_mesh
from geomesa_tpu.sft import FeatureType as JFT
from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType, conf
from geomesa_tpu_torch.parallel import DistributedIndexTable, Mesh, make_mesh
from geomesa_tpu_torch.parallel.mesh import _host_major, make_multihost_mesh
from test_parallel import QUERIES, SPEC, _points
from test_torch_native import ensure_jax_native

N = 40_000  # ten 4,096-row blocks: every shard of an 8-shard mesh owns blocks
MESH_SIZES = (1, 3, 8)
ENV = (-20, -10, 40, 35)


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    ensure_jax_native()


def _columns(n=N, seed=0):
    x, y, t = _points(n, seed)
    return [str(i) for i in range(n)], {
        "name": np.array([f"n{i % 17}" for i in range(n)]),
        "age": np.arange(n) % 90,
        "dtg": t,
        "geom": (x, y),
    }


def _jax_store(d, n=N, seed=0):
    sft = JFT.from_spec("pts", SPEC)
    ds = JDataStore(mesh=None if d is None else jmake_mesh(d))
    ds.create_schema(sft)
    ids, cols = _columns(n, seed)
    ds.write("pts", JFC.from_columns(sft, ids, cols))
    return ds


def _port_store(d, n=N, seed=0):
    sft = FeatureType.from_spec("pts", SPEC)
    ds = DataStore(device="cpu", mesh=None if d is None else make_mesh(devices=["cpu"] * d))
    ds.create_schema(sft)
    ids, cols = _columns(n, seed)
    ds.write("pts", FeatureCollection.from_columns(sft, ids, cols))
    return ds


@pytest.fixture(scope="module")
def single():
    return _port_store(None)


@pytest.fixture(scope="module", params=MESH_SIZES, ids=[f"D{d}" for d in MESH_SIZES])
def pair(request):
    """(JAX mesh store, port mesh store) over the same rows."""
    return _jax_store(request.param), _port_store(request.param)


def _ids(fc) -> list:
    return np.asarray(fc.ids).astype(str).tolist()


def test_mesh_tables_deal_round_robin(pair, single):
    """Local slot j of shard d holds global block j * D + d of the sorted
    padded columns: the one-device table's blocks, then sentinel pads."""
    from geomesa_tpu_torch.storage.table import _SENTINELS

    _, ds = pair
    table, one = ds.table("pts", "z3"), single.table("pts", "z3")
    D = table.n_devices
    assert isinstance(table, DistributedIndexTable)
    assert table.n_blocks % D == 0 and table.rows_uploaded == table.n_pad
    assert table.n_blocks == -(-one.n_blocks // D) * D
    for k, shards in table.cols3.items():
        assert len(shards) == D and all(s.is_contiguous() for s in shards)
        for g in range(table.n_blocks):
            blk = shards[g % D][g // D]
            if g < one.n_blocks:
                assert torch.equal(blk, one.cols3[k][g]), (k, g)
            else:
                assert bool((blk == torch.tensor(_SENTINELS[k])).all()), (k, g)


@pytest.mark.parametrize("q", QUERIES)
def test_ids_in_order_equal_the_jax_package(pair, single, q):
    jds, ds = pair
    got = _ids(ds.query("pts", q))
    assert got == _ids(jds.query("pts", q))
    assert got == _ids(single.query("pts", q))
    assert _ids(ds.query("pts", q, limit=7)) == _ids(jds.query("pts", q, limit=7)) == got[:7]


@pytest.mark.parametrize("q", [QUERIES[i] for i in (0, 1, 3)])
def test_counts_and_estimates_equal_the_jax_package(pair, single, q):
    jds, ds = pair
    assert ds.count("pts", q) == jds.count("pts", q) == single.count("pts", q)
    est = [s.stats_query("pts", "Count()", q, estimate=True)[0].count for s in (ds, jds, single)]
    assert est[0] == est[1] == est[2] > 0


def test_density_and_bounds_equal_the_jax_package(pair, single):
    jds, ds = pair
    for q in QUERIES[:2]:
        g = ds.density("pts", q, envelope=ENV, width=32, height=16)
        jg = np.asarray(jds.density("pts", q, envelope=ENV, width=32, height=16))
        assert g.dtype == jg.dtype and np.array_equal(g, jg) and g.sum() > 0
        assert np.array_equal(g, single.density("pts", q, envelope=ENV, width=32, height=16))
        b = ds.bounds("pts", q, estimate=True)
        assert b == jds.bounds("pts", q, estimate=True) == single.bounds("pts", q, estimate=True)
        assert b is not None


def test_query_many_fuses_and_equals_the_jax_package(pair, single, monkeypatch):
    jds, ds = pair
    calls = []
    orig = DistributedIndexTable._fused_raw_finishes

    def spy(self, *a, **kw):
        out = orig(self, *a, **kw)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(DistributedIndexTable, "_fused_raw_finishes", spy)
    rng = np.random.default_rng(21)
    boxes = [f"bbox(geom, {x:.3f}, {y:.3f}, {x + 9:.3f}, {y + 7:.3f})"
             for x, y in zip(rng.uniform(-170, 150, 12), rng.uniform(-80, 70, 12))]
    batch = boxes + QUERIES
    got = [_ids(o) for o in ds.query_many("pts", batch)]
    assert got == [_ids(o) for o in jds.query_many("pts", batch)]
    assert got == [_ids(ds.query("pts", q)) for q in batch]
    assert got == [_ids(o) for o in single.query_many("pts", batch)]
    assert any(calls), "the batch never took the fused mesh launch"


def test_scan_ordinals_and_certainty_equal_the_one_device_table(pair, single):
    """The mesh table returns the one-device table's exactness tier:
    identical ordinals and certain flags, some of them certain."""
    _, ds = pair
    certain = 0
    for q in QUERIES:
        plan = single.planner.plan("pts", q)
        if plan.config is None or plan.union is not None:
            continue
        o1, c1 = single.table("pts", plan.index).scan(plan.config)
        o2, c2 = ds.table("pts", plan.index).scan(plan.config)
        assert o1.tolist() == o2.tolist() and c1.tolist() == c2.tolist()
        certain += int(c2.sum())
    assert certain > 0


def _skewed_batch(ds, n_members=9):
    """Tiny box-and-window queries around rows of sorted block 0, so every
    member's candidates sit on shard 0."""
    table = ds.table("pts", "z3")
    x, y, t = _points(N, 0)
    rows = np.asarray(table.perm[: table.block], np.int64)
    rng = np.random.default_rng(5)
    out = []
    for i in rng.choice(rows, n_members, replace=False):
        t0 = np.datetime64(int(t[i]) - 3_600_000, "ms")
        t1 = np.datetime64(int(t[i]) + 3_600_000, "ms")
        out.append(f"bbox(geom, {x[i] - 0.01:.5f}, {y[i] - 0.01:.5f}, {x[i] + 0.01:.5f}, "
                   f"{y[i] + 0.01:.5f}) AND dtg DURING {t0}Z/{t1}Z")
    return out


def test_skewed_fused_chunk_splits_like_the_jax_package(monkeypatch):
    """With the fused slot cap pinned to 4 a chunk of members whose
    candidates all sit on one shard overflows that shard's slots: the
    chunk splits in half and recurses, the results equal the JAX
    package's (same knob), the per-query scans' and the ids' brute
    force."""
    from geomesa_tpu import conf as jconf

    for c in (conf, jconf):
        monkeypatch.setattr(c.SCAN_FUSED_SLOTS, "_override", 4)
    jds, ds = _jax_store(8), _port_store(8)
    outcomes = []
    orig = DistributedIndexTable._fused_raw_finishes

    def spy(self, *a, **kw):
        out = orig(self, *a, **kw)
        outcomes.append(out is not None)
        return out

    monkeypatch.setattr(DistributedIndexTable, "_fused_raw_finishes", spy)
    batch = _skewed_batch(ds)
    got = [_ids(o) for o in ds.query_many("pts", batch)]
    assert got == [_ids(o) for o in jds.query_many("pts", batch)]
    assert got == [_ids(ds.query("pts", q)) for q in batch]
    assert all(got)
    assert False in outcomes and True in outcomes  # overflowed, then launched


def test_mesh_writes_and_compaction_rebuild_and_never_fold(monkeypatch):
    """A mesh store's second write waits in the delta tier, a compaction
    rebuilds the mesh table (never the one-device merge), and
    ``fold_upsert`` takes the rebuild path: the adapter refuses the fold
    and the sliced fold is off. Ids equal the JAX mesh store's after each
    step."""
    monkeypatch.setattr(conf.STREAM_FOLD_SLICE_ROWS, "_override", 64)
    from geomesa_tpu_torch.storage.delta import TieredTable

    jds, ds = _jax_store(4, n=20_000), _port_store(4, n=20_000)
    x, y, t = _points(500, seed=9)
    extra = {"name": np.array([f"n{i % 17}" for i in range(500)]), "age": np.arange(500) % 90,
             "dtg": t, "geom": (x, y)}
    ids = [f"extra{i}" for i in range(500)]
    jds.write("pts", JFC.from_columns(jds.get_schema("pts"), ids, dict(extra)))
    ds.write("pts", FeatureCollection.from_columns(ds.get_schema("pts"), ids, dict(extra)))
    assert isinstance(ds.table("pts", "z3"), TieredTable)
    for q in QUERIES[:3]:
        assert _ids(ds.query("pts", q)) == _ids(jds.query("pts", q))
    jds.compact("pts")
    ds.compact("pts")
    assert type(ds.table("pts", "z3")) is DistributedIndexTable
    for q in QUERIES[:3]:
        assert _ids(ds.query("pts", q)) == _ids(jds.query("pts", q))
    # an upsert of 200 existing ids: the fold is refused, the table rebuilt
    assert not ds._fold_sliceable("pts", {})
    old = ds.table("pts", "z3")
    assert ds.adapter.fold_table(old.keyspace, old, None) is None
    up_ids = [str(i) for i in range(0, 2_000, 10)]
    ux, uy, ut = _points(200, seed=11)
    up = {"name": np.array(["up"] * 200), "age": np.zeros(200, np.int64), "dtg": ut,
          "geom": (ux, uy)}
    jds.fold_upsert("pts", JFC.from_columns(jds.get_schema("pts"), up_ids, dict(up)))
    ds.fold_upsert("pts", FeatureCollection.from_columns(ds.get_schema("pts"), up_ids, dict(up)))
    new = ds.table("pts", "z3")
    assert type(new) is DistributedIndexTable and new is not old and new.rows_uploaded == new.n_pad
    for q in QUERIES:
        assert _ids(ds.query("pts", q)) == _ids(jds.query("pts", q))


def test_make_mesh_takes_visible_cards_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_mesh(2)
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh.size == 2 and mesh.axis == "shard" and mesh.device_type == "cuda"
    with pytest.raises(ValueError, match="asked for 4 devices, have 2"):
        make_mesh(4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="asked for 1 devices, have 0"):
        make_mesh(1)
    with pytest.raises(ValueError, match="at least one device"):
        make_mesh()
    with pytest.raises(ValueError, match="mixes"):
        make_mesh(devices=["cpu", "cuda:0"])
    virtual = make_mesh(devices=["cuda:0"] * 8)
    assert virtual.size == 8 and set(virtual.devices) == {torch.device("cuda", 0)}


def test_store_refuses_a_mesh_that_disagrees_with_its_device():
    with pytest.raises(ValueError, match="disagree"):
        DataStore(device="cpu", mesh=make_mesh(devices=["cuda:0"] * 2))
    ds = DataStore(device="cpu", mesh=make_mesh(devices=["cpu"] * 2))
    assert ds.mesh.size == 2 and ds.adapter.mesh is ds.mesh


@pytest.mark.parametrize("call", ["query", "count", "density", "bounds", "query_many"])
def test_a_shard_without_a_kernel_raises_instead_of_falling_back(call):
    """One shard's columns moved to the ``meta`` device (no kernel there):
    every device path through that shard raises; none takes the plain
    version."""
    ds = _port_store(4, n=20_000)
    table = ds.table("pts", "z3")
    for k in table.cols3:
        table.cols3[k][1] = table.cols3[k][1].to("meta")
    q = QUERIES[1]
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        if call == "query":
            ds.query("pts", q)
        elif call == "count":
            ds.stats_query("pts", "Count()", q, estimate=True)
        elif call == "density":
            ds.density("pts", q, envelope=ENV, width=8, height=8)
        elif call == "bounds":
            ds.bounds("pts", q, estimate=True)
        else:
            ds.query_many("pts", [QUERIES[0]] * 12 + [q] * 12)


def test_multihost_mesh_is_host_major():
    mesh = make_multihost_mesh(hosts=2, devices_per_host=4, devices=["cpu"] * 8)
    assert isinstance(mesh, Mesh) and mesh.size == 8

    class Dev:
        def __init__(self, name, process_index):
            self.name, self.process_index = name, process_index

    stub = [Dev(f"d{h}_{i}", h) for i in (0, 1, 2, 3) for h in (1, 0)]
    got = _host_major(stub, hosts=2, devices_per_host=3)
    assert [d.name for d in got] == ["d0_0", "d0_1", "d0_2", "d1_0", "d1_1", "d1_2"]
    with pytest.raises(ValueError, match="has 4 devices, need 5"):
        _host_major(stub, hosts=2, devices_per_host=5)
    with pytest.raises(ValueError, match="do not divide"):
        make_multihost_mesh(hosts=3, devices=["cpu"] * 8)


def test_jax_saved_store_loads_onto_a_port_mesh(tmp_path):
    """A store the JAX package saves loads into a port mesh store
    (``persist.load(root, mesh=...)``): its tables are mesh tables and
    answer as the JAX mesh store does."""
    from geomesa_tpu.storage import persist as jpersist
    from geomesa_tpu_torch.storage import persist

    jds = _jax_store(4, n=20_000)
    root = str(tmp_path / "cat")
    jpersist.save(jds, root)
    back = persist.load(root, device="cpu", mesh=make_mesh(devices=["cpu"] * 4))
    assert type(back._tables[("pts", "z3")]) is DistributedIndexTable
    for q in QUERIES:
        assert _ids(back.query("pts", q)) == _ids(jds.query("pts", q))
