"""The port's catalog tier (storage.metadata), adapter seam
(storage.adapter) and ``FeatureType.to_spec`` against the JAX package's,
on the CPU.

Following tests/test_catalog.py and tests/test_host_adapter.py: the
three metadata backends answer the same sequence of inserts, reads,
scans and removes as the JAX package's; ``create_schema`` writes the
JAX package's catalog entries and ``delete_schema`` removes them; every
table build goes through the store's adapter (a counting adapter sees
each build and each release); concurrent writers serialize and readers
racing appends see whole publishes; and a store on ``HostAdapter``
answers every query, aggregation and mutation as the device-backed
store does and as the JAX package's ``HostAdapter`` store does, ids in
order. ``to_spec`` round-trips the spec and the user data as the JAX
package's does. Tolerance: exact.
"""

import json
import threading

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu.storage import adapter as jadapter
from geomesa_tpu.storage import metadata as jmeta
from geomesa_tpu_torch.storage import adapter as tadapter
from geomesa_tpu_torch.storage import metadata as tmeta

torch.set_num_threads(1)

T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000


# -- FeatureType.to_spec ------------------------------------------------------

SPECS = [
    "name:String,dtg:Date,*geom:Point:srid=4326",
    "arrest:String:index=true,age:Integer,dtg:Date,*geom:Point:srid=4326;geomesa.z3.interval=week",
    "tag:String,*geom:Polygon:srid=4326;geomesa.indices.enabled=xz2,geomesa.feature.expiry=7 days",
    "blob:Bytes,flag:Boolean,score:Double,n:Long,*geom:LineString:srid=4326",
]


@pytest.mark.parametrize("spec", SPECS)
def test_to_spec_round_trips_as_the_jax_package(spec):
    t = geomesa_tpu_torch.FeatureType.from_spec("t", spec)
    j = geomesa_tpu.FeatureType.from_spec("t", spec)
    assert t.to_spec() == j.to_spec()
    back = geomesa_tpu_torch.FeatureType.from_spec("t", t.to_spec())
    assert back.to_spec() == t.to_spec()
    assert back.user_data == t.user_data == j.user_data
    assert [(a.name, a.type, a.default, a.options) for a in back.attributes] == \
        [(a.name, a.type, a.default, a.options) for a in j.attributes]


# -- metadata backends ---------------------------------------------------------

def _exercise(md) -> list:
    out = [md.get("t~schema")]
    md.insert("t~schema", "a:Int,*geom:Point:srid=4326")
    md.insert("t~user_data", "{}")
    md.insert("u~schema", "other")
    out += [md.get("t~schema"), dict(md.scan("t~")), dict(md.scan(""))]
    md.remove("t~schema")
    md.remove("never~there")
    out += [md.get("t~schema"), md.get("u~schema"), dict(md.scan("t"))]
    return out


@pytest.mark.parametrize("backend", ["memory", "file", "cached-memory", "cached-file"])
def test_metadata_backends_answer_as_the_jax_package(tmp_path, backend):
    outs = []
    for mod in (jmeta, tmeta):
        if backend.endswith("memory"):
            md = mod.InMemoryMetadata()
        else:
            md = mod.FileMetadata(str(tmp_path / mod.__name__))
        if backend.startswith("cached"):
            md = mod.CachedMetadata(md)
        assert isinstance(md, mod.Metadata)
        outs.append(_exercise(md))
    assert outs[0] == outs[1]
    assert outs[1][1].startswith("a:Int") and outs[1][4] is None


def test_file_metadata_rejects_traversal_and_skips_tmp(tmp_path):
    md = tmeta.FileMetadata(str(tmp_path / "md"))
    for key in ("../evil", "a/../../b", "bad key", ""):
        with pytest.raises(ValueError):
            md.insert(key, "x")
    md.insert("schema/t", "spec")
    (tmp_path / "md" / "schema" / "u.tmp").write_text("torn")
    assert dict(md.scan("schema/")) == {"schema/t": "spec"}


def test_cached_metadata_invalidation(tmp_path):
    backend = tmeta.FileMetadata(str(tmp_path / "md"))
    md = tmeta.CachedMetadata(backend)
    md.insert("k", "v1")
    backend.insert("k", "v2")  # an external change: the cache is stale
    assert md.get("k") == "v1"
    md.invalidate()
    assert md.get("k") == "v2"
    md.remove("k")
    assert md.get("k") is None and backend.get("k") is None


# -- the store's catalog and adapter seam --------------------------------------

def _store(pkg, kw, name="c", spec="name:String:index=true,dtg:Date,*geom:Point:srid=4326",
           n=1500, **extra):
    sft = pkg.FeatureType.from_spec(name, spec)
    ds = pkg.DataStore(**kw, **extra)
    ds.create_schema(sft)
    rng = np.random.default_rng(2)
    fc = pkg.FeatureCollection.from_columns(
        sft, [str(i) for i in range(n)],
        {"name": np.array([f"n{i % 5}" for i in range(n)]),
         "dtg": T0 + rng.integers(0, DAY * 10, n),
         "geom": (rng.uniform(-40, 40, n), rng.uniform(-30, 30, n))},
    )
    ds.write(name, fc)
    return ds


PKGS = ((geomesa_tpu, {}), (geomesa_tpu_torch, {"device": "cpu"}))


def test_store_catalog_entries_equal_the_jax_package():
    cats = []
    for pkg, kw in PKGS:
        ds = _store(pkg, kw)
        cats.append({k: ds.metadata.get(k) for k in ("c~schema", "c~user_data", "c~indices")})
        assert "geom:Point" in ds.metadata.get("c~schema")
        assert json.loads(ds.metadata.get("c~user_data")) == {}
        ds.delete_schema("c")
        assert all(ds.metadata.get(k) is None for k in ("c~schema", "c~user_data", "c~indices"))
        assert ds.type_names() == []
    assert cats[0] == cats[1]
    assert cats[1]["c~indices"] == "z3,z2,attr_name"


def test_file_catalog_persists_the_schema(tmp_path):
    md = tmeta.FileMetadata(str(tmp_path / "cat"))
    ds = _store(geomesa_tpu_torch, {"device": "cpu"}, metadata=md)
    back = tmeta.FileMetadata(str(tmp_path / "cat"))
    spec = back.get("c~schema")
    assert spec == ds.get_schema("c").to_spec()
    assert geomesa_tpu_torch.FeatureType.from_spec("c", spec).to_spec() == spec


class CountingAdapter(tadapter.InProcessAdapter):
    """Counts every build and release the store asks of its adapter."""

    def __init__(self):
        super().__init__()
        self.calls = {"create": 0, "fold": 0, "delete": 0}

    def create_table(self, keyspace, keys, old=None, main_rows=0):
        self.calls["create"] += 1
        return super().create_table(keyspace, keys, old=old, main_rows=main_rows)

    def fold_table(self, *a, **k):
        self.calls["fold"] += 1
        return super().fold_table(*a, **k)

    def delete_table(self, table):
        self.calls["delete"] += 1


def test_every_table_build_goes_through_the_adapter():
    ad = CountingAdapter()
    ds = _store(geomesa_tpu_torch, {"device": "cpu"}, adapter=ad, n=3000)
    assert ad.device == ds.device  # an adapter without a device takes the store's
    assert ad.calls == {"create": 3, "fold": 0, "delete": 0}  # z3, z2, attr_name
    out = ds.query("c", "bbox(geom, -10, -10, 10, 10)")
    assert len(out) > 0
    sft = ds.get_schema("c")
    rng = np.random.default_rng(4)
    batch = geomesa_tpu_torch.FeatureCollection.from_columns(
        sft, [str(i) for i in range(0, 600, 2)],
        {"name": np.array(["z"] * 300), "dtg": T0 + rng.integers(0, DAY, 300),
         "geom": (rng.uniform(-5, 5, 300), rng.uniform(-5, 5, 300))})
    ds.fold_upsert("c", batch, slice_rows=100)
    # three slices, each folding all three tables and releasing the old ones
    assert ad.calls == {"create": 3, "fold": 9, "delete": 9}
    ds.delete_features("c", "name = 'n1'")  # a major compaction: every table rebuilt
    assert ad.calls == {"create": 6, "fold": 9, "delete": 12}
    n_before = ad.calls["delete"]
    ds.delete_schema("c")
    assert ad.calls["delete"] == n_before + 3  # every table released


def test_custom_adapter_store_equals_the_jax_store():
    """A store built through a counting adapter answers as the JAX
    package's counting-adapter store does."""

    class JCounting(jadapter.InProcessAdapter):
        def __init__(self):
            super().__init__()
            self.n = 0

        def create_table(self, keyspace, keys, old=None, main_rows=0):
            self.n += 1
            return super().create_table(keyspace, keys, old=old, main_rows=main_rows)

    ja, ta = JCounting(), CountingAdapter()
    j = _store(geomesa_tpu, {}, adapter=ja)
    t = _store(geomesa_tpu_torch, {"device": "cpu"}, adapter=ta)
    assert ja.n == ta.calls["create"]
    for q in ("bbox(geom, -10, -10, 10, 10)", "name = 'n3'", "INCLUDE"):
        assert np.asarray(t.query("c", q).ids).tolist() == np.asarray(j.query("c", q).ids).tolist()


def test_concurrent_writes_serialized():
    sft = geomesa_tpu_torch.FeatureType.from_spec("w", "dtg:Date,*geom:Point:srid=4326")
    ds = geomesa_tpu_torch.DataStore(device="cpu")
    ds.create_schema(sft)
    rng = np.random.default_rng(0)

    def batch(tag):
        n = 400
        return geomesa_tpu_torch.FeatureCollection.from_columns(
            sft, [f"{tag}{i}" for i in range(n)],
            {"dtg": T0 + rng.integers(0, DAY, n),
             "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n))},
        )

    batches = [batch(t) for t in "abcdefgh"]
    threads = [threading.Thread(target=ds.write, args=("w", b)) for b in batches]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ds.count("w") == 8 * 400
    ds.compact("w")
    assert ds.count("w") == 8 * 400
    with pytest.raises(ValueError, match="duplicate"):
        ds.write("w", batches[0])


def test_readers_during_writes():
    """Queries racing appends never fail and see whole publishes (row
    counts between the totals before and after; ids unique)."""
    sft = geomesa_tpu_torch.FeatureType.from_spec("rw", "v:Integer,*geom:Point:srid=4326")
    ds = geomesa_tpu_torch.DataStore(tile=64, device="cpu")
    ds.create_schema(sft)
    rng = np.random.default_rng(3)
    base = 2000
    ds.write("rw", geomesa_tpu_torch.FeatureCollection.from_columns(
        sft, np.arange(base),
        {"v": np.arange(base), "geom": (rng.uniform(-10, 10, base), rng.uniform(-10, 10, base))},
    ), check_ids=False)
    errors, counts = [], []
    stop = threading.Event()

    def reader():
        try:
            while not stop.is_set():
                out = ds.query("rw", "bbox(geom, -10, -10, 10, 10)")
                ids = np.asarray(out.ids)
                assert len(np.unique(ids)) == len(ids)
                counts.append(len(out))
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    readers = [threading.Thread(target=reader) for _ in range(3)]
    for r in readers:
        r.start()
    n_batches, per = 6, 500
    for b in range(n_batches):
        start = base + b * per
        ds.write("rw", geomesa_tpu_torch.FeatureCollection.from_columns(
            sft, np.arange(start, start + per),
            {"v": np.arange(start, start + per),
             "geom": (rng.uniform(-10, 10, per), rng.uniform(-10, 10, per))},
        ), check_ids=False)
    stop.set()
    for r in readers:
        r.join(timeout=30)
    assert not errors, errors[:3]
    total = base + n_batches * per
    assert len(ds.query("rw", "INCLUDE")) == total
    assert counts and all(base <= c <= total for c in counts)


# -- HostAdapter ---------------------------------------------------------------

HOST_SPEC = "name:String:index=true,dtg:Date,*geom:Point:srid=4326"
HOST_QUERIES = [
    "bbox(geom, -40, -20, 40, 20)",
    "bbox(geom, 0, 0, 90, 45) AND dtg DURING 2024-01-03T00:00:00Z/2024-01-12T00:00:00Z",
    "name = 'b'",
    "name = 'a' AND bbox(geom, -90, -45, 90, 45)",
    "INTERSECTS(geom, POLYGON((0 0, 60 0, 30 40, 0 0)))",
    "IN ('3', '77', '3999') OR dtg DURING 2024-01-20T00:00:00Z/2024-01-21T00:00:00Z",
    "dtg DURING 2024-01-05T00:00:00Z/2024-01-06T00:00:00Z",
]


def _host_cols(n=4000):
    rng = np.random.default_rng(12)
    return n, {
        "name": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
        "dtg": T0 + rng.integers(0, 30 * DAY, n),
        "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)),
    }


@pytest.fixture(scope="module")
def host_stores():
    """(port device store, port host store, JAX host store), one write of
    4000 rows and one of 400 kept in the delta tier each."""
    n, cols = _host_cols()
    out = []
    for pkg, kw, adapter in ((geomesa_tpu_torch, {"device": "cpu"}, None),
                             (geomesa_tpu_torch, {"device": "cpu"}, tadapter.HostAdapter()),
                             (geomesa_tpu, {}, jadapter.HostAdapter())):
        ds = pkg.DataStore(adapter=adapter, tile=64, **kw)
        ds.create_schema(pkg.FeatureType.from_spec("t", HOST_SPEC))
        ds.write("t", pkg.FeatureCollection.from_columns(
            ds.get_schema("t"), [str(i) for i in range(n)], dict(cols)))
        out.append(ds)
    return out


def test_host_adapter_conforms_to_the_protocol():
    assert isinstance(tadapter.HostAdapter(), tadapter.IndexAdapter)
    assert isinstance(tadapter.InProcessAdapter(), tadapter.IndexAdapter)


def test_host_adapter_is_chosen_only_by_the_caller():
    ds = geomesa_tpu_torch.DataStore(device="cpu")
    assert type(ds.adapter) is tadapter.InProcessAdapter
    host = _store(geomesa_tpu_torch, {"device": "cpu"}, adapter=tadapter.HostAdapter())
    tables = {k[1]: type(t).__name__ for k, t in host._tables.items()}
    assert tables == {"z3": "HostTable", "z2": "HostTable", "attr_name": "HostTable"}
    assert all(t.nbytes_device == 0 for t in host._tables.values())


@pytest.mark.parametrize("q", HOST_QUERIES)
def test_host_queries_match_device_backend_and_jax_host(host_stores, q):
    dev, host, jhost = host_stores
    a = np.asarray(dev.query("t", q).ids).tolist()
    b = np.asarray(host.query("t", q).ids).tolist()
    c = np.asarray(jhost.query("t", q).ids).tolist()
    assert a == b == c and len(a) > 0
    assert np.asarray(host.query("t", q, limit=9).ids).tolist() == \
        np.asarray(jhost.query("t", q, limit=9).ids).tolist()
    assert [np.asarray(r.ids).tolist() for r in host.query_many("t", [q, HOST_QUERIES[0]])] == \
        [a, np.asarray(dev.query("t", HOST_QUERIES[0]).ids).tolist()]


def test_host_aggregations_match(host_stores):
    dev, host, jhost = host_stores
    q = "bbox(geom, -60, -30, 60, 30)"
    assert dev.count("t", q) == host.count("t", q) == jhost.count("t", q)
    env = (-60, -30, 60, 30)
    ga = dev.density("t", q, envelope=env, width=16, height=8)
    gb = host.density("t", q, envelope=env, width=16, height=8)
    gc = jhost.density("t", q, envelope=env, width=16, height=8)
    assert np.array_equal(ga, gb) and np.array_equal(np.asarray(gc), gb)
    assert dev.bounds("t", q) == host.bounds("t", q) == jhost.bounds("t", q)
    est = [ds.stats_query("t", "Count()", q, estimate=True)[0].to_json()
           for ds in host_stores]
    assert est[0] == est[1] == est[2]
    reqs = [(q, env), (HOST_QUERIES[1], None)]
    for g, h in zip(dev.density_many("t", reqs, width=8, height=8),
                    host.density_many("t", reqs, width=8, height=8)):
        assert np.array_equal(g, h)


def test_host_delta_tier_and_compaction_match():
    """Writes kept in the delta tier and a compaction, on a host store and
    the JAX package's host store."""
    n, cols = _host_cols(3000)
    stores = []
    for pkg, kw, adapter in ((geomesa_tpu_torch, {"device": "cpu"}, tadapter.HostAdapter()),
                             (geomesa_tpu, {}, jadapter.HostAdapter())):
        ds = pkg.DataStore(adapter=adapter, tile=64, **kw)
        ds.create_schema(pkg.FeatureType.from_spec("t", HOST_SPEC))
        sft = ds.get_schema("t")
        for lo, hi in ((0, 2500), (2500, 3000)):
            sub = {k: (v[0][lo:hi], v[1][lo:hi]) if k == "geom" else v[lo:hi]
                   for k, v in cols.items()}
            ds.write("t", pkg.FeatureCollection.from_columns(
                sft, [str(i) for i in range(lo, hi)], sub))
        stores.append(ds)
    for step in ("tiered", "compacted"):
        if step == "compacted":
            for ds in stores:
                ds.compact("t")
        for q in HOST_QUERIES:
            a, b = (np.asarray(ds.query("t", q).ids).tolist() for ds in stores)
            assert a == b, (step, q)


def test_mutations_through_host_adapter(host_stores):
    _, host, jhost = host_stores
    out = []
    for ds, pkg in ((host, geomesa_tpu_torch), (jhost, geomesa_tpu)):
        n0 = len(ds.features("t"))
        ds.upsert("t", pkg.FeatureCollection.from_columns(
            ds.get_schema("t"), ["0"],
            {"name": np.array(["z"]), "dtg": np.array([T0]),
             "geom": (np.array([1.0]), np.array([1.0]))}))
        assert np.asarray(ds.query("t", "name = 'z'").ids).tolist() == ["0"]
        assert len(ds.features("t")) == n0
        ds.fold_upsert("t", pkg.FeatureCollection.from_columns(
            ds.get_schema("t"), ["1", "2", "new"],
            {"name": np.array(["y", "y", "y"]), "dtg": np.array([T0] * 3),
             "geom": (np.array([2.0, 3.0, 4.0]), np.array([2.0, 3.0, 4.0]))}),
            slice_rows=1)
        ds.delete_features("t", "bbox(geom, 100, 0, 180, 90)")
        ds.modify_features("t", {"name": "w"}, "IN ('5', '6')")
        ds.age_off("t", ttl_ms=0, now_ms=T0 + 2 * DAY)
        out.append([np.asarray(ds.features("t").ids).tolist()] +
                   [np.asarray(ds.query("t", q).ids).tolist() for q in HOST_QUERIES])
    assert out[0] == out[1]
