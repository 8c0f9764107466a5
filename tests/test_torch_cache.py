"""The port's query and aggregation cache tier against the JAX package,
on the CPU (after tests/test_cache.py).

- ``canonical_key`` equals the JAX package's on the differential test's
  200 seeded filter trees (and on reordered conjunctions), and the
  fingerprints of the same plans, hints and auths are equal;
- the generation tracker, the result cache (hits, invalidation by
  write, delete, upsert and fold, disjoint writes kept warm, bypass and
  pin hints, TTL, LRU under a byte budget, schema drop, zero budget,
  cached against uncached), single-flight, the scan-config memo, the
  tile-aggregate cache (exact counts and bounds, tile-edge rows,
  shifted boxes, invalidation, the cost gate, visibility declines),
  explain lines and metrics: each run on both packages, with the same
  answers, ids in order, and the same cache counters where they are
  deterministic;
- ``persist.load(root, cache=...)`` with a warm cache: a healthy load
  revalidates every entry, a quarantined partition drops the entries
  over it; the answers stay those of an uncached store.

The cache tier's streaming interplay (the JAX package's
``TestStreamingInterplay``) waits for the port's streaming tier. Both
packages take their native host helpers. Tolerance: exact.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu.filter import ecql as jecql
from geomesa_tpu.filter.predicates import canonical_key as jkey
from geomesa_tpu_torch.cache import (
    BUCKET_MS, CacheConfig, GenerationTracker, KeyRange, fingerprint, schema_signature,
)
from geomesa_tpu_torch.filter import ecql
from geomesa_tpu_torch.filter.predicates import canonical_key
from geomesa_tpu_torch.metrics import MetricsRegistry
from geomesa_tpu_torch.planning.explain import Explainer
from geomesa_tpu_torch.planning.hints import QueryHints
from test_torch_native import ensure_jax_native

torch.set_num_threads(1)

T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000
SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"
PKGS = (geomesa_tpu, geomesa_tpu_torch)
KW = {geomesa_tpu: {}, geomesa_tpu_torch: {"device": "cpu"}}
Q = "bbox(geom, -10, -10, 40, 30)"


@pytest.fixture(autouse=True)
def _native():
    ensure_jax_native()


def _cache_arg(pkg, cache):
    """A CacheConfig of the test, as the package's own class."""
    if isinstance(cache, CacheConfig):
        from importlib import import_module

        return import_module(pkg.__name__ + ".cache").CacheConfig(**vars(cache))
    return cache


def _store(pkg=geomesa_tpu_torch, n=3000, seed=0, cache=True, metrics=None, indices="z3", **kw):
    sft = pkg.FeatureType.from_spec("t", SPEC)
    sft.user_data["geomesa.indices.enabled"] = indices
    ds = pkg.DataStore(metrics=metrics or pkg.metrics.MetricsRegistry(),
                       cache=_cache_arg(pkg, cache), **KW[pkg], **kw)
    ds.create_schema(sft)
    rng = np.random.default_rng(seed)
    ds.write("t", pkg.FeatureCollection.from_columns(
        sft, [f"f{i}" for i in range(n)],
        {"name": np.array([f"n{i % 5}" for i in range(n)], dtype=object),
         "dtg": T0 + rng.integers(0, 60 * DAY, n),
         "geom": (rng.uniform(-170, 170, n), rng.uniform(-80, 80, n))},
    ), check_ids=False)
    return ds


def _pair(**kw):
    return tuple(_store(pkg, **kw) for pkg in PKGS)


def _batch(pkg, ds, ids, x, y, t=T0, name="z"):
    n = len(ids)
    return pkg.FeatureCollection.from_columns(
        ds.get_schema("t"), list(ids),
        {"name": np.array([name] * n, dtype=object), "dtg": np.full(n, int(t)),
         "geom": (np.asarray(x, float), np.asarray(y, float))})


def _ids(fc):
    return np.asarray(fc.ids).tolist()


def _cache_counters(reg) -> dict:
    return {k: v for k, v in sorted(reg.counters.items())
            if k.startswith("geomesa.cache") and v}


def _same_rows(a, b):
    assert _ids(a) == _ids(b)
    ax, ay = a.representative_xy()
    bx, by = b.representative_xy()
    assert np.array_equal(np.asarray(ax), np.asarray(bx))
    assert np.array_equal(np.asarray(ay), np.asarray(by))


# -- fingerprints -------------------------------------------------------------


def test_canonical_key_equals_the_jax_package_on_seeded_trees():
    from test_torch_differential import CASES

    n = 0
    for schema in ("pts", "ext"):
        for q, _, _ in CASES[schema]:
            assert canonical_key(ecql.parse(q)) == jkey(jecql.parse(q)), q
            n += 1
    assert n == 200


@pytest.mark.parametrize("a,b", [
    ("bbox(geom, -10, -10, 40, 30) AND name = 'n1'", "name = 'n1' AND bbox(geom, -10, -10, 40, 30)"),
    ("(name = 'n1' OR name = 'n2') AND bbox(geom, 0, 0, 9, 9)",
     "bbox(geom, 0, 0, 9, 9) AND (name = 'n2' OR name = 'n1')"),
], ids=["and", "or-nested"])
def test_reordered_children_collide(a, b):
    ka, kb = canonical_key(ecql.parse(a)), canonical_key(ecql.parse(b))
    assert ka == kb == jkey(jecql.parse(a)) == jkey(jecql.parse(b))
    f = ecql.parse(a)
    inner = ka[len(type(f).__name__) + 1:-1]
    assert inner == ",".join(sorted(canonical_key(c) for c in f.filters))
    assert canonical_key(ecql.parse("bbox(geom, -10, -10, 40, 30)")) != canonical_key(
        ecql.parse("bbox(geom, -10, -10, 40, 31)"))


def test_fingerprints_equal_the_jax_package():
    """Schema signature, hints token and fingerprint of the same plans,
    hints and auths: letter for letter."""
    from geomesa_tpu.cache import fingerprint_plan as jfp
    from geomesa_tpu.cache import schema_signature as jsig
    from geomesa_tpu.planning.hints import QueryHints as JHints
    from geomesa_tpu_torch.cache import fingerprint_plan as tfp

    jds, tds = _pair(n=500)
    assert schema_signature(tds.get_schema("t")) == jsig(jds.get_schema("t"))
    hints = [None, dict(), dict(timeout=5.0), dict(transforms=["name"]), dict(sort_by="-dtg"),
             dict(loose=True), dict(sample=0.5, sample_by="name"), dict(offset=3),
             dict(cache="pin")]
    for q in (Q, "name = 'n1'", "bbox(geom, 0, 0, 9, 9) AND (name = 'n2' OR name = 'n1')",
              "IN ('f1', 'f2')", "dtg DURING 2024-01-02T00:00:00Z/2024-01-09T00:00:00Z"):
        for limit in (None, 7):
            jp, tp = jds.planner.plan("t", q, limit=limit), tds.planner.plan("t", q, limit=limit)
            for h in hints:
                for auths in (None, (), ("b", "a")):
                    want = jfp(jp, None if h is None else JHints(**h), jds.get_schema("t"), auths, 3)
                    got = tfp(tp, None if h is None else QueryHints(**h), tds.get_schema("t"),
                              auths, 3)
                    assert got == want, (q, h, auths)
    sig = schema_signature(tds.get_schema("t"))
    f = ecql.parse(Q)

    def fp(h, auths=None):
        return fingerprint("t", sig, 0, "z3", f, None, h, auths)

    assert fp(QueryHints(timeout=5.0)) == fp(None) == fp(QueryHints())
    assert len({fp(None), fp(QueryHints(transforms=["name"])), fp(QueryHints(sort_by="name")),
                fp(QueryHints(loose=True)), fp(None, ("admin",)), fp(None, ("user",))}) == 6


def test_store_level_collision():
    out = []
    for pkg in PKGS:
        reg = pkg.metrics.MetricsRegistry()
        ds = _store(pkg, metrics=reg)
        r1 = ds.query("t", "bbox(geom, -10, -10, 40, 30) AND name = 'n1'")
        r2 = ds.query("t", "name = 'n1' AND bbox(geom, -10, -10, 40, 30)")
        _same_rows(r1, r2)
        assert len(ds.cache.result) == 1
        out.append((_ids(r1), _cache_counters(reg)))
    assert out[1] == out[0]
    assert out[1][1]["geomesa.cache.hit"] == out[1][1]["geomesa.cache.miss"] == 1


# -- generations ---------------------------------------------------------------


@pytest.mark.parametrize("case", ["overlap", "disjoint-space", "disjoint-time", "unknown",
                                  "other-type", "schema", "wide-span"])
def test_generation_tracker_agrees(case):
    from geomesa_tpu.cache import GenerationTracker as J
    from geomesa_tpu.cache import KeyRange as JK

    kr = {"overlap": ((0.0, 0.0, 10.0, 10.0), (T0, T0 + DAY)),
          "disjoint-space": ((0.0, 0.0, 10.0, 10.0), None),
          "disjoint-time": (None, (T0, T0 + DAY)),
          "unknown": ((0.0, 0.0, 1.0, 1.0), (T0, T0 + 1)),
          "other-type": (None, None), "schema": ((5.0, 5.0, 6.0, 6.0), None),
          "wide-span": ((0.0, 0.0, 1.0, 1.0), (T0, T0 + 1))}[case]
    bump = {"overlap": ("t", (5.0, 5.0, 6.0, 6.0), (T0, T0 + DAY)),
            "disjoint-space": ("t", (100.0, 50.0, 120.0, 60.0), None),
            "disjoint-time": ("t", None, (T0 + 200 * DAY, T0 + 201 * DAY)),
            "unknown": ("t", None, None), "other-type": ("other", None, None),
            "schema": None, "wide-span": ("t", (-1.0, -1.0, 0.5, 0.5), (0, 10 ** 15))}[case]
    res = []
    for G, K in ((J, JK), (GenerationTracker, KeyRange)):
        g = G()
        tick = g.tick()
        k = K(boxes=None if kr[0] is None else (kr[0],), interval=kr[1])
        before = g.stale("t", k, tick)
        if bump is None:
            g.bump_schema("t")
        else:
            g.bump(bump[0], bounds=bump[1], time_range=bump[2])
        res.append((before, g.stale("t", k, tick), g.tick(), g.schema_gen("t")))
    assert res[1] == res[0]
    assert res[1][1] == (case in ("overlap", "unknown", "schema", "wide-span"))


def test_bucket_width_matches_persistence_partitions():
    from geomesa_tpu_torch.storage.persist import PARTITION_MS

    assert BUCKET_MS == PARTITION_MS


def test_key_range_and_mutation_range_agree():
    from geomesa_tpu.cache import key_range_of as jkr
    from geomesa_tpu.cache import mutation_range as jmr
    from geomesa_tpu_torch.cache import key_range_of, mutation_range
    from test_torch_differential import CASES

    jds, tds = _pair(n=300)
    for q, _, _ in CASES["pts"][:60] + [(Q, 0, 0), ("INCLUDE", 0, 0)]:
        q = q.replace("age", "name").replace("score", "name")
        try:
            jf = jecql.parse(q)
        except Exception:
            continue
        got = key_range_of(ecql.parse(q), tds.get_schema("t"))
        want = jkr(jf, jds.get_schema("t"))
        assert (got.boxes, got.interval) == (want.boxes, want.interval), q
    assert mutation_range(tds.features("t")) == jmr(jds.features("t"))


# -- the result cache -------------------------------------------------------------


def _run(steps):
    """Run ``steps(pkg, ds, reg)`` on a cached store of each package;
    return both results."""
    out = []
    for pkg in PKGS:
        reg = pkg.metrics.MetricsRegistry()
        out.append(steps(pkg, _store(pkg, metrics=reg), reg))
    return out


def test_hit_returns_identical_rows():
    def steps(pkg, ds, reg):
        r1, r2 = ds.query("t", Q), ds.query("t", Q)
        _same_rows(r1, r2)
        assert reg.gauges["geomesa.cache.bytes"] > 0
        return _ids(r1), _cache_counters(reg), reg.gauges["geomesa.cache.bytes"]

    j, t = _run(steps)
    assert t == j and t[1] == {"geomesa.cache.hit": 1, "geomesa.cache.miss": 1}


@pytest.mark.parametrize("op", ["write", "disjoint-write", "delete-upsert", "fold", "modify",
                                "age-off"])
def test_mutations_invalidate_what_they_touch(op):
    """Each mutation path bumps its key range: entries over it are
    invalidated, entries away from it stay hits; the answers equal an
    uncached store's after every step."""

    def steps(pkg, ds, reg):
        plain = _store(pkg, cache=False)
        far = "bbox(geom, 100, 40, 170, 80)"
        seen = []
        for q in (Q, far, "name = 'n1'"):
            seen.append(_ids(ds.query("t", q)))
        if op == "write":
            for s in (ds, plain):
                s.write("t", _batch(pkg, s, ["new0", "new1"], [5, 6], [5, 6]), check_ids=False)
        elif op == "disjoint-write":
            for s in (ds, plain):
                s.write("t", _batch(pkg, s, ["far0"], [-150.0], [-70.0]), check_ids=False)
        elif op == "delete-upsert":
            for s in (ds, plain):
                s.delete_features("t", "bbox(geom, 0, 0, 20, 20)")
                s.upsert("t", _batch(pkg, s, ["f1", "f2"], [1.0, 2.0], [1.0, 2.0], name="n1"))
        elif op == "fold":
            for s in (ds, plain):
                s.fold_upsert("t", _batch(pkg, s, ["f3", "f8", "x9"], [3.0, 4.0, 5.0],
                                          [3.0, 4.0, 5.0]), slice_rows=0)
        elif op == "modify":
            for s in (ds, plain):
                s.modify_features("t", {"name": "mod"}, "bbox(geom, 0, 0, 15, 15)")
        else:
            for s in (ds, plain):
                s.age_off("t", ttl_ms=0, now_ms=T0 + 10 * DAY)
        for q in (Q, far, "name = 'n1'"):
            got = ds.query("t", q)
            _same_rows(got, plain.query("t", q))
            _same_rows(got, ds.query("t", q, hints=QueryHints(cache="bypass")))
            seen.append(_ids(got))
        return seen, _cache_counters(reg)

    j, t = _run(steps)
    assert t == j
    counters = t[1]
    if op == "disjoint-write":
        assert counters["geomesa.cache.hit"] >= 1  # away from the write: still warm
    else:
        assert counters.get("geomesa.cache.invalidation", 0) >= 1


def test_bypass_hint_skips_probe_and_populate():
    def steps(pkg, ds, reg):
        from importlib import import_module

        H = import_module(pkg.__name__ + ".planning.hints").QueryHints
        out = _ids(ds.query("t", Q, hints=H(cache="bypass")))
        assert len(ds.cache.result) == 0
        return out, _cache_counters(reg)

    j, t = _run(steps)
    assert t == j and t[1] == {}


def test_pin_hint_beats_admission_and_eviction():
    conf = CacheConfig(max_bytes=1 << 16, min_cost_s=1e9, tile_max_entries=0)
    out = []
    for pkg in PKGS:
        from importlib import import_module

        H = import_module(pkg.__name__ + ".planning.hints").QueryHints
        reg = pkg.metrics.MetricsRegistry()
        ds = _store(pkg, metrics=reg, cache=conf)
        ds.query("t", Q)
        assert len(ds.cache.result) == 0 and reg.counters["geomesa.cache.reject"] >= 1
        ds.query("t", Q, hints=H(cache="pin"))
        assert len(ds.cache.result) == 1
        for i in range(12):
            ds.query("t", f"bbox(geom, {-60 + i}, -40, {60 + i}, 40)", hints=H(cache="pin"))
        ds.query("t", Q)
        assert reg.counters["geomesa.cache.hit"] >= 1
        out.append((_cache_counters(reg), len(ds.cache.result), ds.cache.result.bytes_resident))
    assert out[1] == out[0]


def test_ttl_expires_entries():
    reg = MetricsRegistry()
    ds = _store(metrics=reg, cache=CacheConfig(ttl_s=0.05, tile_max_entries=0))
    ds.query("t", Q)
    ds.query("t", Q)
    assert reg.counters["geomesa.cache.hit"] == 1
    time.sleep(0.06)
    ds.query("t", Q)
    assert reg.counters["geomesa.cache.expired"] == 1
    assert reg.counters["geomesa.cache.miss"] == 2


def test_lru_eviction_respects_byte_budget():
    """Entries sized alike in both packages (collection_nbytes): the same
    admissions and evictions under a 96 KB budget."""
    conf = CacheConfig(max_bytes=96_000, tile_max_entries=0)
    out = []
    for pkg in PKGS:
        reg = pkg.metrics.MetricsRegistry()
        ds = _store(pkg, metrics=reg, cache=conf)
        sizes = []
        for i in range(16):
            r = ds.query("t", f"bbox(geom, {-80 + i}, -60, {80 - i}, 60)")
            sizes.append(ds.cache.result.bytes_resident)
        assert ds.cache.result.bytes_resident <= conf.max_bytes
        assert reg.counters["geomesa.cache.eviction"] >= 1
        out.append((sizes, _cache_counters(reg), len(ds.cache.result), _ids(r)))
    assert out[1] == out[0]


def test_collection_nbytes_counts_like_the_jax_package():
    from geomesa_tpu.cache import collection_nbytes as jnb
    from geomesa_tpu_torch.cache import collection_nbytes as tnb

    jds, tds = _pair(n=500)
    for q in (Q, "INCLUDE", "name = 'n3'"):
        assert tnb(tds.query("t", q)) == jnb(jds.query("t", q))
    assert tnb(np.zeros(7)) == jnb(np.zeros(7)) == 56
    from test_torch_differential import extent_data, extent_store

    ext = [extent_store(pkg, extent_data(n=200), writes=(200,), **KW[pkg]) for pkg in PKGS]
    assert tnb(ext[1].query("ext", "INCLUDE")) == jnb(ext[0].query("ext", "INCLUDE"))


def test_schema_drop_and_zero_budget():
    ds = _store()
    ds.query("t", Q)
    assert len(ds.cache.result) == 1
    ds.delete_schema("t")
    assert len(ds.cache.result) == 0
    reg = MetricsRegistry()
    ds = _store(metrics=reg, cache=CacheConfig(max_bytes=0))
    ds.query("t", Q)
    ds.query("t", Q)
    assert reg.counters["geomesa.cache.hit"] == 0


def test_cache_on_vs_off_identical():
    cached = _store(cache=True)
    plain = _store(cache=False)
    assert plain.cache is None and plain.adapter.generations is None
    assert cached.adapter.generations is cached.cache.generations
    jcached = _store(geomesa_tpu, cache=True)
    for q in (Q, "name = 'n2'", "bbox(geom, 0, 0, 90, 45) AND name = 'n3'"):
        for _ in range(2):  # the second pass serves from the cache
            got = cached.query("t", q)
            _same_rows(got, plain.query("t", q))
            _same_rows(got, jcached.query("t", q))
    assert cached.cache.stats() == {k: v for k, v in jcached.cache.stats().items()
                                    if k in cached.cache.stats()}


# -- single-flight ---------------------------------------------------------------


def test_concurrent_identical_queries_share_one_scan():
    reg = MetricsRegistry()
    ds = _store(metrics=reg)
    n_threads = 8
    scans = []
    orig = ds.planner._execute

    def counting_execute(plan, explain=None, hints=None, **kw):
        scans.append(1)
        time.sleep(0.15)  # hold the flight open so waiters pile up
        return orig(plan, explain, hints, **kw)

    ds.planner._execute = counting_execute
    barrier = threading.Barrier(n_threads)
    results, errors = [None] * n_threads, []

    def worker(i):
        try:
            barrier.wait()
            results[i] = ds.query("t", Q)
        except Exception as e:  # pragma: no cover - diagnostic
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors
    assert len(scans) == 1
    assert reg.counters["geomesa.cache.miss"] == 1
    assert reg.counters["geomesa.cache.stampede.coalesced"] >= 1
    assert (reg.counters["geomesa.cache.stampede.coalesced"]
            + reg.counters["geomesa.cache.hit"]) == n_threads - 1
    for r in results[1:]:
        _same_rows(results[0], r)


def test_waiter_recomputes_when_write_lands_mid_flight():
    reg = MetricsRegistry()
    ds = _store(metrics=reg)
    orig = ds.planner._execute
    started = threading.Event()

    def slow_execute(plan, explain=None, hints=None, **kw):
        first = not started.is_set()
        started.set()
        out = orig(plan, explain, hints, **kw)
        if first:
            ds.write("t", _batch(geomesa_tpu_torch, ds, ["mid0"], [5.0], [5.0]),
                     check_ids=False)
            time.sleep(0.08)  # hold the flight so the waiter joins it
        return out

    ds.planner._execute = slow_execute
    out = {}
    t1 = threading.Thread(target=lambda: out.__setitem__("leader", ds.query("t", Q)))
    t2 = threading.Thread(target=lambda: (started.wait(timeout=5),
                                          out.__setitem__("waiter", ds.query("t", Q))))
    t1.start()
    t2.start()
    t1.join()
    t2.join()
    assert len(out["waiter"]) == len(out["leader"]) + 1
    assert reg.counters["geomesa.cache.stampede.coalesced"] == 0


# -- the scan-config memo ----------------------------------------------------------


def test_memo_dropped_on_every_mutation():
    """The memo may not outlive a write: z3 time bins clamp to the data's
    bin_range, which grows with writes (bypass queries too)."""
    out = []
    for pkg in PKGS:
        from importlib import import_module

        H = import_module(pkg.__name__ + ".planning.hints").QueryHints
        sft = pkg.FeatureType.from_spec("t", SPEC)
        sft.user_data["geomesa.indices.enabled"] = "z3"
        ds = pkg.DataStore(cache=True, **KW[pkg])
        ds.create_schema(sft)
        ds.write("t", _batch(pkg, ds, ["a0"], [0.0], [0.0], t=T0, name="a"), check_ids=False)
        q = "bbox(geom, -1, -1, 1, 1) AND dtg DURING 2024-01-01T00:00:00Z/2024-03-01T00:00:00Z"
        bypass = H(cache="bypass")
        res = [len(ds.query("t", q, hints=bypass)), len(ds.planner._config_memo)]
        e0 = ds.planner.mutation_epoch
        ds.write("t", _batch(pkg, ds, ["a1"], [0.0], [0.0], t=T0 + 40 * DAY, name="a"),
                 check_ids=False)
        res += [len(ds.planner._config_memo), ds.planner.mutation_epoch > e0]
        res += [len(ds.query("t", q, hints=bypass)), len(ds.query("t", q))]
        for mutate in (lambda: ds.fold_upsert("t", _batch(pkg, ds, ["a0"], [0.5], [0.5],
                                                          t=T0 + 80 * DAY, name="a")),
                       lambda: ds.delete_features("t", "IN ('a1')"),
                       lambda: ds.delete_schema("t")):
            ds.query("t", q, hints=bypass) if "t" in ds.type_names() else None
            mutate()
            res.append(len(ds.planner._config_memo))
        out.append(res)
    assert out[1] == out[0]
    assert out[1][:6] == [1, 1, 0, True, 2, 2]


# -- the tile-aggregate cache --------------------------------------------------------


def test_count_and_bounds_composition_exact():
    out = []
    for pkg in PKGS:
        reg = pkg.metrics.MetricsRegistry()
        ds = _store(pkg, n=4000, metrics=reg)
        plain = _store(pkg, n=4000, cache=False)
        rng = np.random.default_rng(7)
        res = []
        for _ in range(12):
            x0, y0 = float(rng.uniform(-170, 100)), float(rng.uniform(-80, 40))
            w = float(rng.uniform(15, 70))
            q = f"bbox(geom, {x0}, {y0}, {x0 + w}, {y0 + w / 2})"
            rows = plain.query("t", q)
            assert ds.count("t", q) == len(rows), q
            x, y = rows.representative_xy()
            want = None if not len(rows) else (float(np.min(x)), float(np.min(y)),
                                               float(np.max(x)), float(np.max(y)))
            assert ds.bounds("t", q) == want, q
            c = ds.stats_query("t", "Count()", q)
            assert c[0].count == len(rows)
            res.append((len(rows), want))
        assert reg.counters.get("geomesa.cache.tile.reused", 0) > 0
        out.append((res, _cache_counters(reg)))
    assert out[1][0] == out[0][0]
    tile = {k: v for k, v in out[1][1].items() if ".tile." in k}
    assert tile == {k: v for k, v in out[0][1].items() if ".tile." in k}


def test_tile_edge_rows_never_double_count():
    conf = CacheConfig(tile_bits=4)  # 22.5 x 11.25 degree tiles
    step_x, step_y = 360.0 / 16, 180.0 / 16
    gx = -180.0 + np.arange(1, 15) * step_x
    gy = -90.0 + np.arange(1, 15) * step_y
    xx, yy = np.meshgrid(gx, gy)
    x, y = xx.ravel(), yy.ravel()
    n = len(x)
    sft = geomesa_tpu_torch.FeatureType.from_spec("t", SPEC)
    sft.user_data["geomesa.indices.enabled"] = "z2"
    ds = geomesa_tpu_torch.DataStore(cache=conf, device="cpu")
    ds.create_schema(sft)
    plain = geomesa_tpu.DataStore()
    plain.create_schema(geomesa_tpu.FeatureType.from_spec("t", SPEC))
    for s, pkg in ((ds, geomesa_tpu_torch), (plain, geomesa_tpu)):
        s.write("t", _batch(pkg, s, [f"e{i}" for i in range(n)], x, y, name="e"),
                check_ids=False)
    for x0, y0, x1, y1 in ((-180.0 + step_x, -90.0 + step_y, step_x * 3, step_y * 2),
                           (-step_x * 2, -step_y * 2, step_x * 2, step_y * 2),
                           (0.0, 0.0, step_x * 4, step_y * 3)):
        q = f"bbox(geom, {x0}, {y0}, {x1}, {y1})"
        want = len(plain.query("t", q))
        assert ds.count("t", q) == want, q
        assert ds.count("t", q) == want, q


def test_shifted_bbox_reuses_interior_and_writes_invalidate():
    out = []
    for pkg in PKGS:
        reg = pkg.metrics.MetricsRegistry()
        ds = _store(pkg, n=4000, metrics=reg)
        plain = _store(pkg, n=4000, cache=False)
        q = "bbox(geom, -60, -40, 60, 40)"
        res = [ds.count("t", q)]
        filled = reg.counters["geomesa.cache.tile.filled"]
        assert filled > 0
        res.append(ds.count("t", "bbox(geom, -48, -36, 72, 44)"))
        assert reg.counters["geomesa.cache.tile.reused"] > 0
        for s in (ds, plain):
            s.write("t", _batch(pkg, s, ["w0", "w1", "w2"], [0, 1, 2], [0, 1, 2], name="w"),
                    check_ids=False)
        assert ds.count("t", q) == len(plain.query("t", q))
        res.append(ds.count("t", q))
        out.append((res, _cache_counters(reg)))
    assert out[1][0] == out[0][0]
    assert {k: v for k, v in out[1][1].items() if ".tile." in k} == {
        k: v for k, v in out[0][1].items() if ".tile." in k}


def test_adaptive_cost_gate():
    reg = MetricsRegistry()
    ds = _store(n=1000, metrics=reg)
    tc = ds.cache.tiles
    for _ in range(6):  # losing compositions against a 10 ms plain scan
        tc._note_compose("t", 0.050)
    tc.note_scan("t", 0.010)
    opened = [tc.worth_composing("t") for _ in range(16)]
    assert opened.count(False) >= 10
    assert opened[1:].count(True) >= 1  # but re-probes
    assert reg.counters["geomesa.cache.tile.gated"] >= 10
    for _ in range(12):  # cheap composes reopen the gate
        tc._note_compose("t", 0.001)
    assert all(tc.worth_composing("t") for _ in range(8))
    tc._scanning.active = True
    tc.note_scan("t", 99.0)
    tc._scanning.active = False
    assert tc._scan_s["t"] < 1.0
    # the gate's decisions equal the JAX package's on the same samples
    jds = _store(geomesa_tpu, n=1000)
    decisions = []
    for c in (ds.cache.tiles, jds.cache.tiles):
        c._scan_s.clear()
        c._compose_s.clear()
        c._probe.clear()
        for k in range(30):
            c._note_compose("t", 0.02 + 0.01 * (k % 3))
            c.note_scan("t", 0.015)
        decisions.append([c.worth_composing("t") for _ in range(20)])
    assert decisions[0] == decisions[1]


def test_compose_duration_not_a_scan_sample():
    ds = _store(n=2000)
    tc = ds.cache.tiles
    assert ds.stats_query("t", "Count()", "bbox(geom, -60, -40, 60, 40)")[0].count > 0
    assert "t" not in tc._scan_s
    ds.query("t", "bbox(geom, -60, -40, 60, 40)")
    assert "t" in tc._scan_s


def test_tile_cache_declines_visibility_and_interceptors():
    sft = geomesa_tpu_torch.FeatureType.from_spec(
        "t", "name:String,vis:String,dtg:Date,*geom:Point:srid=4326")
    sft.user_data["geomesa.vis.field"] = "vis"
    ds = geomesa_tpu_torch.DataStore(cache=True, auths=("a",), device="cpu")
    ds.create_schema(sft)
    n = 50
    ds.write("t", geomesa_tpu_torch.FeatureCollection.from_columns(
        sft, [f"v{i}" for i in range(n)],
        {"name": np.array(["x"] * n, dtype=object),
         "vis": np.array(["a" if i % 2 else "b" for i in range(n)], dtype=object),
         "dtg": np.full(n, int(T0)),
         "geom": (np.linspace(-50, 50, n), np.linspace(-40, 40, n))}), check_ids=False)
    box = ecql.parse("bbox(geom, -60, -60, 60, 60)")
    assert ds._tile_compose("t", box) is None
    assert ds.count("t", box) == 25  # visibility applies to the row path
    open_ds = _store(n=500)
    assert open_ds._tile_compose("t", box) is not None
    from geomesa_tpu_torch.planning.guards import AgeOffInterceptor

    open_ds.interceptors.append(AgeOffInterceptor(ttl_ms=DAY, now_ms=T0 + DAY))
    assert open_ds._tile_compose("t", box) is None


# -- explain and metrics ------------------------------------------------------------


def test_explain_reports_status_and_probe_time():
    ds = _store()
    lines = []
    for _ in range(2):
        exp = Explainer()
        ds.query("t", Q, explain=exp)
        [line] = [l for l in exp.lines if l.strip().startswith("cache:")]
        lines.append(line)
    assert "miss" in lines[0] and "probe" in lines[0] and "ms" in lines[0]
    assert "hit" in lines[1]
    plan = ds.planner.plan("t", "name = 'n4'")
    ds.planner.execute(plan)
    assert plan.cache_status == "miss" and plan.cache_probe_s >= 0.0
    plan2 = ds.planner.plan("t", "name = 'n4'")
    ds.planner.execute(plan2)
    assert plan2.cache_status == "hit"


def test_probe_time_separate_from_scan_time():
    reg = MetricsRegistry()
    ds = _store(metrics=reg)
    ds.query("t", Q)
    ds.query("t", Q)
    probe = reg.timers["geomesa.query.cache_probe"]
    scan = reg.histograms["geomesa.query.scan"]
    assert probe.count == 2 and scan.count == 2
    assert probe.total_s <= scan.sum_s


def test_tile_explain_reports_partial_then_hit():
    ds = _store(n=4000)
    lines = []
    for _ in range(2):
        exp = Explainer()
        ds.stats_query("t", "Count()", f="bbox(geom, -60, -40, 60, 40)", explain=exp)
        [line] = [l for l in exp.lines if l.strip().startswith("cache:")]
        lines.append(line)
    assert "tiles reused" in lines[0]
    assert lines[1].strip().startswith("cache: hit")


def test_bad_cache_hint_rejected():
    with pytest.raises(ValueError):
        QueryHints(cache="nope").validate()


def test_hits_skip_estimate_accounting():
    """A result-cache hit scanned nothing: it records no estimate pair."""
    ds = _store()
    ds.query("t", Q)
    n = ds.accuracy.sample_count()
    ds.query("t", Q)
    assert ds.accuracy.sample_count() == n == 1


# -- persist.load with a warm cache ---------------------------------------------------


@pytest.mark.parametrize("damage", [False, True], ids=["healthy", "quarantined"])
def test_load_with_a_warm_cache(tmp_path, damage):
    """A warm cache passed through ``persist.load(root, cache=...)``: a
    reload bumps every loaded type, so no entry serves stale; a damaged
    partition's entries are dropped eagerly. Answers equal an uncached
    load's, in order, and the JAX package's."""
    qs = [Q, "name = 'n1'", "bbox(geom, 100, 40, 170, 80)",
          "dtg DURING 2024-01-03T00:00:00Z/2024-01-20T00:00:00Z"]
    out = []
    for pkg in PKGS:
        from importlib import import_module

        persist = import_module(pkg.__name__ + ".storage.persist")
        reg = pkg.metrics.MetricsRegistry()
        ds = _store(pkg, metrics=reg)
        root = tmp_path / pkg.__name__
        persist.save(ds, str(root))
        warm = [_ids(ds.query("t", q)) for q in qs]
        for q in qs:
            ds.count("t", q)
        if damage:
            f = sorted(os.listdir(root / "t"))[0]
            with open(root / "t" / f, "rb+") as fh:
                fh.truncate(os.path.getsize(root / "t" / f) // 2)
        entries = len(ds.cache.result)
        back = persist.load(str(root), cache=ds.cache, metrics=reg, **KW[pkg])
        plain = persist.load(str(root), **KW[pkg])
        assert back.cache is ds.cache
        dropped = entries - len(back.cache.result)
        res = []
        for q in qs:
            got = back.query("t", q)
            assert _ids(got) == _ids(plain.query("t", q)), q
            assert back.count("t", q) == plain.count("t", q)
            res.append(_ids(got))
        if not damage:  # the same rows came back (in the loaded table's order)
            assert [sorted(r) for r in res] == [sorted(w) for w in warm]
        out.append((res, dropped, _cache_counters(reg)))
    assert out[1] == out[0]
    if damage:
        assert out[1][1] > 0  # the quarantine swept entries eagerly
