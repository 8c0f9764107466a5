"""The port's streaming hot tier and FeatureStream against the JAX
package's, on the CPU.

The same seeded operations go through both packages'
``StreamingFeatureCache``: upserts (explicit ids, ``__id__`` and auto
ids, WKT strings and geometries, large batches applied in lock chunks),
deletes, ``expire`` at a given clock, identity-checked ``evict`` (a row
replaced after the snapshot stays), the replay mode and its bulk
``replay_upsert``; after each step ``query_shadow`` gives the same ids
in order (the bucket prune's ``sorted`` candidates, then the exact host
filter), the same values and the same live-id set. Listener events,
``FeatureStream`` topologies (filter, map, a cache sink, a LambdaStore
sink, a callable sink) and the three streaming-interplay cases of the
JAX package's cache tests (``TestStreamingInterplay``) on the port's
cache tier complete the file. Tolerance: exact.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu import geometry as jgeo
from geomesa_tpu import streaming as jstream
from geomesa_tpu_torch import geometry as tgeo
from geomesa_tpu_torch import streaming as tstream
from test_torch_native import ensure_jax_native

torch.set_num_threads(1)

SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"
T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000
QUERIES = (
    "INCLUDE",
    "bbox(geom, -40, -40, 10, 30)",
    "bbox(geom, -60, -60, 60, 60) AND name = 'n3'",
    "bbox(geom, 0, 0, 50, 50) AND dtg DURING 2024-01-01T00:00:00Z/2024-01-05T00:00:00Z",
    "INTERSECTS(geom, POLYGON((-30 -30, 40 -30, 40 40, -30 -30)))",
    "name IN ('n1', 'n2')",
    "bbox(geom, 100, 70, 110, 80)",
)

JAX = SimpleNamespace(name="jax", pkg=geomesa_tpu, geo=jgeo, st=jstream, kw={})
PORT = SimpleNamespace(name="port", pkg=geomesa_tpu_torch, geo=tgeo, st=tstream,
                       kw={"device": "cpu"})
BOTH = (JAX, PORT)


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    ensure_jax_native()


def _sft(P):
    return P.pkg.FeatureType.from_spec("t", SPEC)


def _msgs(P, seed, n, prefix="h", wkt_every=0):
    rng = np.random.default_rng(seed)
    xs, ys = rng.uniform(-60, 60, n), rng.uniform(-60, 60, n)
    ts = T0 + rng.integers(0, 8 * DAY, n)
    rows = []
    for j in range(n):
        g = (f"POINT ({float(xs[j])!r} {float(ys[j])!r})" if wkt_every and j % wkt_every == 0
             else P.geo.Point(float(xs[j]), float(ys[j])))
        rows.append({"name": f"n{int(rng.integers(0, 6))}", "dtg": int(ts[j]), "geom": g})
    ids = [f"{prefix}{int(i)}" for i in rng.integers(0, max(n // 2, 1), n)]  # repeats
    return rows, ids


def _fc(fc) -> tuple:
    """(ids in order, every column's values in order)."""
    cols = {}
    for name, col in fc.columns.items():
        if hasattr(col, "x"):
            cols[name] = (np.asarray(col.x).tolist(), np.asarray(col.y).tolist())
        else:
            cols[name] = np.asarray(col).tolist()
    return [str(i) for i in np.asarray(fc.ids).tolist()], cols


def _shadow(cache, q):
    fc, live = cache.query_shadow(q)
    return _fc(fc), sorted(live)


def _all_queries(cache):
    return [_shadow(cache, q) for q in QUERIES]


def _both(fn):
    return [fn(P) for P in BOTH]


def test_upsert_auto_ids_wkt_and_lock_chunks_equal():
    def run(P):
        c = P.st.StreamingFeatureCache(_sft(P), grid=(90, 45))
        rows, ids = _msgs(P, 1, 9000, wkt_every=5)  # > two lock chunks
        c.upsert(rows, ids)
        auto, _ = _msgs(P, 2, 40)
        c.upsert(auto)  # auto ids from the counter
        tagged, _ = _msgs(P, 3, 10)
        for j, r in enumerate(tagged):
            r["__id__"] = f"tag{j}"
        c.upsert(tagged)
        return len(c), c.assign_ids(auto[:3], None), _all_queries(c)

    a, b = _both(run)
    assert a == b


def test_delete_expire_evict_equal():
    def run(P):
        c = P.st.StreamingFeatureCache(_sft(P), expiry_ms=1000, grid=(90, 45))
        rows, ids = _msgs(P, 4, 3000)
        c.upsert(rows, ids)
        steps = [_all_queries(c)]
        c.delete(ids[:200] + ["missing"])
        steps.append(_all_queries(c))
        snap = c.snapshot_rows()
        fresh, fids = _msgs(P, 5, 50)
        fids = [fid for fid, _ in snap[:50]]  # replaced after the snapshot
        c.upsert(fresh, fids)
        steps.append(c.evict(snap))  # the replaced rows stay
        steps.append(_all_queries(c))
        steps.append(c.expire(now_ms=int(time.time() * 1000) + 10_000))
        steps.append(_all_queries(c))
        return steps

    a, b = _both(run)
    assert a == b
    assert a[2] > 0  # evicted the rows nothing replaced


def test_full_drain_evict_fast_path_equal():
    def run(P):
        c = P.st.StreamingFeatureCache(_sft(P), grid=(90, 45))
        rows, ids = _msgs(P, 6, 500)
        c.upsert(rows, ids)
        n = c.evict(c.snapshot_rows())
        return n, len(c), _all_queries(c)

    a, b = _both(run)
    assert a == b and a[1] == 0


def test_replay_mode_equal():
    def run(P):
        c = P.st.StreamingFeatureCache(_sft(P), grid=(90, 45))
        c.begin_replay()
        rows, ids = _msgs(P, 7, 2000)
        xy = np.array([[r["geom"].x, r["geom"].y] for r in rows])
        c.replay_upsert(rows[:1000], ids[:1000], xy=xy[:1000])
        c.replay_upsert(rows[1000:], ids[1000:])
        c.delete(ids[:100])
        c.evict(c.snapshot_pairs(ids[100:300]))
        c.bump_next_id(77)
        c.end_replay()
        return len(c), c.assign_ids([{}], None), _all_queries(c)

    a, b = _both(run)
    assert a == b


def test_replay_upsert_equals_upsert():
    rows, ids = _msgs(PORT, 8, 1500)
    a = tstream.StreamingFeatureCache(_sft(PORT), grid=(90, 45))
    a.upsert(list(rows), list(ids))
    b = tstream.StreamingFeatureCache(_sft(PORT), grid=(90, 45))
    xy = np.array([[r["geom"].x, r["geom"].y] for r in rows])
    b.replay_upsert(list(rows), list(ids), xy=xy)
    assert _all_queries(a) == _all_queries(b)


def test_listener_events_equal():
    def run(P):
        c = P.st.StreamingFeatureCache(_sft(P), expiry_ms=1)
        events = []
        c.listeners.append(lambda e, fid, row: events.append((e, fid)))
        rows, ids = _msgs(P, 9, 30)
        c.upsert(rows, ids)
        c.delete(ids[:3])
        c.expire(now_ms=int(time.time() * 1000) + 10_000)
        return events

    a, b = _both(run)
    assert a == b and {e for e, _ in a} == {"added", "updated", "removed", "expired"}


def test_expire_survives_raising_listener():
    for P in BOTH:
        c = P.st.StreamingFeatureCache(_sft(P), expiry_ms=1)
        rows, ids = _msgs(P, 10, 20)
        c.upsert(rows, ids)

        def bad(event, fid, row):
            raise RuntimeError("listener fault")

        c.listeners.append(bad)
        assert c.expire(now_ms=int(time.time() * 1000) + 10_000) == len(set(ids))
        assert len(c) == 0


def _lam(P, n=600, seed=0, **kw):
    sft = _sft(P)
    ds = P.pkg.DataStore(**P.kw, **kw)
    ds.create_schema(sft)
    rng = np.random.default_rng(seed)
    ds.write("t", P.pkg.FeatureCollection.from_columns(sft, [f"c{i}" for i in range(n)], {
        "name": np.array([f"n{i % 6}" for i in range(n)]),
        "dtg": T0 + rng.integers(0, 8 * DAY, n),
        "geom": (rng.uniform(-60, 60, n), rng.uniform(-60, 60, n))}))
    return ds, P.st.LambdaStore(ds, "t", config=P.st.StreamConfig(workers=2, fold_rows=50))


def test_feature_stream_sinks_equal():
    def run(P):
        src = P.st.StreamingFeatureCache(_sft(P), expiry_ms=1)
        rows, ids = _msgs(P, 11, 40)
        src.upsert(rows[:20], ids[:20])  # replayed into the sinks at wiring
        view = P.st.StreamingFeatureCache(_sft(P))
        msgs = []
        ds, lam = _lam(P)
        P.st.FeatureStream.wrap(src).filter(lambda r: r["name"] != "n0").map(
            lambda r: {**r, "name": r["name"].upper()}).to(view)
        P.st.FeatureStream.wrap(src).to(lambda a, fid, row: msgs.append((a, fid)))
        P.st.FeatureStream.wrap(src).filter(lambda r: r["name"] in ("n1", "n2")).to(lam)
        src.upsert(rows[20:], ids[20:])
        src.delete(ids[:4])
        src.expire(now_ms=int(time.time() * 1000) + 10_000)
        out = (_all_queries(view), msgs, [_fc(lam.query(q)) for q in QUERIES])
        lam.close()
        return out

    a, b = _both(run)
    assert a == b
    with pytest.raises(TypeError):
        tstream.FeatureStream.wrap(tstream.StreamingFeatureCache(_sft(PORT))).to(object())


# -- the cache tier's streaming interplay (the JAX package's
# tests/test_cache.py TestStreamingInterplay, on the port's cache) ---------

Q = "bbox(geom, -10, -10, 10, 10)"


def _cached(P, n=200):
    return _lam(P, n=n, cache=True)[0]


def test_lambda_hot_mutations_bump_generations():
    for P in BOTH:
        ds = _cached(P)
        lam = P.st.LambdaStore(ds, "t", expiry_ms=10_000)
        assert lam.hot.generations is ds.cache.generations
        t0 = ds.cache.generations.tick()
        lam.write([{"name": "h", "dtg": int(T0), "geom": "POINT(1 1)"}], ids=["h0"])
        assert ds.cache.generations.tick() > t0
        t1 = ds.cache.generations.tick()
        lam.hot.delete(["h0"])
        assert ds.cache.generations.tick() > t1
        lam.close()


def test_lambda_expiry_bumps():
    for P in BOTH:
        ds = _cached(P)
        lam = P.st.LambdaStore(ds, "t", expiry_ms=1)
        lam.write([{"name": "h", "dtg": int(T0), "geom": "POINT(1 1)"}], ids=["h0"])
        t0 = ds.cache.generations.tick()
        assert lam.hot.expire(now_ms=int(time.time() * 1000) + 10_000) == 1
        assert ds.cache.generations.tick() > t0
        lam.close()


def test_flush_invalidates_cold_cached_results():
    outs = []
    for P in BOTH:
        ds = _cached(P)
        n0 = len(ds.query("t", Q))  # populate the cold result cache
        lam = P.st.LambdaStore(ds, "t")
        lam.write([{"name": "h", "dtg": int(T0), "geom": "POINT(5 5)"}], ids=["hot0"])
        lam.persist_hot()
        after = ds.query("t", Q)
        assert len(after) == n0 + 1
        outs.append(_fc(after))
        lam.close()
    assert outs[0] == outs[1]


def test_hot_bump_scoped_to_rows_bbox():
    """A hot write far from a cached query's box leaves that entry a hit,
    in both packages alike."""
    status = []
    for P in BOTH:
        ds = _cached(P, n=400)
        ds.query("t", Q)
        lam = P.st.LambdaStore(ds, "t")
        lam.write([{"name": "h", "dtg": int(T0), "geom": "POINT(55 55)"}], ids=["far"])
        plan = ds.planner.plan("t", Q)
        ds.planner.execute(plan)
        status.append(plan.cache_status)
        lam.close()
    assert status == ["hit", "hit"]
