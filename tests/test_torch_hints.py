"""Query hints in the port against the JAX package, both on the CPU.

The same seeded rows go into a JAX ``geomesa_tpu.DataStore`` and a port
``geomesa_tpu_torch.DataStore(device="cpu")``: a Z3 point store written
once, the same store written in two batches (the second kept in the
delta tier), and an XZ2 extent store. The same filters (box and window,
polygon, a ``BBOX OR DURING`` union, an attribute filter that takes the
full-table scan, an id lookup) run through both with each
``QueryHints`` field alone and in combination: sort ascending and
descending (ties keep their order), sample and stratified sample,
``loose`` (the widened device plane where the mask decides the filter),
transforms (projections, renames, ``st_x`` / ``st_y`` and the other
ST_ accessors, expressions),
reprojection to EPSG:3857, and ``offset`` pages under ``limit``.
Required: ids in order, the result schema, every column, and the pages
concatenating to the whole sorted result. Invalid hints raise the same
exception with the same message in both packages. Both packages take
their native host helpers (loose results follow the range
decomposition, which the two native libraries share). Tolerance: exact,
except reprojected coordinates (1e-9 relative).
"""

import numpy as np
import pytest
import torch

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu.planning.hints import QueryHints as JHints
from geomesa_tpu_torch.planning.hints import QueryHints as THints
from test_torch_native import ensure_jax_native

torch.set_num_threads(1)

N = 3_000
TILE = 1024
T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000
POINT_SPEC = "name:String,age:Integer,score:Double,dtg:Date,*geom:Point:srid=4326"
EXTENT_SPEC = "tag:String,rank:Integer,*geom:Polygon:srid=4326"
NAMES = np.array(["alpha", "bravo", "charlie", "delta", "echo", "UN", "UNITED"])


def point_data(seed=5, n=N):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-60, 60, n)
    y = rng.uniform(-40, 40, n)
    t = T0 + rng.integers(0, 20 * DAY, n)
    t[:40] = t[40:80]  # dtg ties: sorting keeps their order
    # just outside the first filter's box edges, inside its window: the
    # f32-widened device plane keeps them, the exact test does not
    x[100:140] = np.where(np.arange(40) % 2, 10.0 + 1e-6, -30.0 - 1e-6)
    y[100:140] = rng.uniform(-20, 10, 40)
    t[100:140] = T0 + rng.integers(3 * DAY, 11 * DAY, 40)
    age = rng.integers(0, 30, n).astype(np.int32)
    score = np.round(rng.normal(0, 10, n), 2)
    name = NAMES[rng.integers(0, len(NAMES), n)]
    return x, y, t, age, score, name


def extent_data(seed=9, n=N):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-60, 59, n)
    y0 = rng.uniform(-40, 39, n)
    w = rng.uniform(0.01, 1.0, n)
    h = rng.uniform(0.01, 1.0, n)
    tag = NAMES[rng.integers(0, len(NAMES), n)]
    rank = rng.integers(0, 10, n).astype(np.int32)
    return x0, y0, x0 + w, y0 + h, tag, rank


def point_store(pkg, data, writes=(N,), **kw):
    sft = pkg.FeatureType.from_spec("pts", POINT_SPEC)
    ds = pkg.DataStore(tile=TILE, **kw)
    ds.create_schema(sft)
    x, y, t, age, score, name = data
    lo = 0
    for n in writes:
        sl = slice(lo, lo + n)
        cols = {"geom": (x[sl], y[sl]), "dtg": t[sl], "age": age[sl], "score": score[sl],
                "name": name[sl]}
        ds.write("pts", pkg.FeatureCollection.from_columns(sft, np.arange(lo, lo + n), cols))
        lo += n
    return ds


def extent_store(pkg, data, writes=(N,), **kw):
    sft = pkg.FeatureType.from_spec("ext", EXTENT_SPEC)
    ds = pkg.DataStore(tile=TILE, **kw)
    ds.create_schema(sft)
    x0, y0, x1, y1, tag, rank = data
    lo = 0
    for n in writes:
        sl = slice(lo, lo + n)
        cols = {"geom": pkg.geometry.PackedGeometryColumn.from_boxes(x0[sl], y0[sl], x1[sl], y1[sl]),
                "tag": tag[sl], "rank": rank[sl]}
        ds.write("ext", pkg.FeatureCollection.from_columns(sft, np.arange(lo, lo + n), cols))
        lo += n
    return ds


def dur(d0, d1):
    return (f"dtg DURING {np.datetime64(T0 + d0 * DAY, 'ms')}Z/"
            f"{np.datetime64(T0 + d1 * DAY, 'ms')}Z")


STORES = {
    "z3-once": ("pts", lambda pkg, **kw: point_store(pkg, point_data(), **kw)),
    "z3-tiered": ("pts", lambda pkg, **kw: point_store(pkg, point_data(), writes=(2_400, 600), **kw)),
    "xz2-once": ("ext", lambda pkg, **kw: extent_store(pkg, extent_data(), **kw)),
}
FILTERS = {
    "pts": [
        f"bbox(geom, -30, -25, 10, 15) AND {dur(2, 12)}",
        "INTERSECTS(geom, POLYGON ((0 -10, 30 -10, 25 20, 5 15, 0 -10)))",
        f"bbox(geom, -50, -30, -20, 0) OR {dur(15, 16)}",
        "age > 20",
        "IN ('7', '70', '700', '2999', '12')",
    ],
    "ext": [
        "bbox(geom, -30, -25, 10, 15)",
        "bbox(geom, -10, -10, 20, 5) AND tag = 'UN'",
        "INTERSECTS(geom, POLYGON ((0 -10, 30 -10, 25 20, 5 15, 0 -10)))",
    ],
}
POINT_ONLY = {"lonlat", "lonlat-sorted"}
HINTS = {
    "none": {},
    "sort": {"sort_by": "dtg"},
    "sort-desc": {"sort_by": "-dtg"},
    "sort-name": {"sort_by": "name"},
    "sort-desc-int": {"sort_by": "-age"},
    "sample": {"sample": 0.25},
    "sample-by": {"sample": 0.5, "sample_by": "name"},
    "loose": {"loose": True},
    "loose-sorted": {"loose": True, "sort_by": "-dtg"},
    "lonlat": {"transforms": ["dtg", "lon=st_x(geom)", "lat=st_y(geom)"]},
    "lonlat-sorted": {"transforms": ["name", "lon=st_x(geom)"], "sort_by": "-age", "sample": 0.5},
    "project": {"transforms": ["geom", "name"]},
    "rename-expr": {"transforms": ["who=name", "tag2=concat(name, '-', age)", "a=age::double"]},
    "st-functions": {"transforms": ["kind=st_geometrytype(geom)", "n=st_numpoints(geom)",
                                     "wkt=st_astext(geom)", "env=st_envelope(geom)"]},
    "reproject": {"reproject": "EPSG:3857"},
    "reproject-project": {"reproject": "EPSG:3857", "transforms": ["geom"]},
    "page": {"sort_by": "-dtg", "offset": 10, "limit": 25},
    "page-sampled": {"sample": 0.5, "sort_by": "age", "offset": 3, "limit": 5},
    "timeout": {"timeout": 60.0},
}
EXTENT_RENAMES = {"name": "tag", "age": "rank", "dtg": "rank"}


def hints_for(schema, spec):
    """(hints kwargs, limit) of one HINTS entry on a schema: the extent
    schema names its attributes tag and rank."""
    kw = dict(spec)
    limit = kw.pop("limit", None)
    if schema == "ext":
        def sub(s):
            for a, b in EXTENT_RENAMES.items():
                s = s.replace(a, b)
            return s
        kw = {k: (sub(v) if isinstance(v, str) and k in ("sort_by", "sample_by") else v)
              for k, v in kw.items()}
        if "transforms" in kw:
            kw["transforms"] = [sub(t) for t in kw["transforms"]]
    return kw, limit


def same_collection(a, b, rtol=0.0):
    """Ids in order, schema, and every column of two result collections."""
    assert np.asarray(a.ids).tolist() == np.asarray(b.ids).tolist()
    assert [(x.name, x.type, x.default) for x in a.sft.attributes] == \
        [(x.name, x.type, x.default) for x in b.sft.attributes]
    assert a.sft.user_data.get("geomesa.crs") == b.sft.user_data.get("geomesa.crs")
    assert list(a.columns) == list(b.columns)
    for name, ca in a.columns.items():
        cb = b.columns[name]
        if hasattr(ca, "x"):
            np.testing.assert_allclose(cb.x, ca.x, rtol=rtol, atol=0)
            np.testing.assert_allclose(cb.y, ca.y, rtol=rtol, atol=0)
        elif hasattr(ca, "coords"):
            np.testing.assert_allclose(cb.coords, ca.coords, rtol=rtol, atol=0)
            for k in ("ring_offsets", "part_ring_offsets", "geom_part_offsets", "types", "bboxes"):
                assert np.array_equal(np.asarray(getattr(ca, k)), np.asarray(getattr(cb, k))), k
        else:
            ca, cb = np.asarray(ca), np.asarray(cb)
            assert ca.dtype.kind == cb.dtype.kind, name
            assert np.array_equal(ca, cb), name


@pytest.fixture(scope="module")
def stores():
    ensure_jax_native()  # loose results follow the native range decomposition
    return {
        cell: (schema, build(geomesa_tpu), build(geomesa_tpu_torch, device="cpu"))
        for cell, (schema, build) in STORES.items()
    }


CASES = [(c, h) for c in STORES for h in HINTS
         if not (STORES[c][0] == "ext" and h in POINT_ONLY)]


@pytest.mark.parametrize("cell,hint", CASES, ids=[f"{c}-{h}" for c, h in CASES])
def test_hint_results_equal_the_jax_package(stores, cell, hint):
    schema, jds, tds = stores[cell]
    kw, limit = hints_for(schema, HINTS[hint])
    rtol = 1e-9 if "reproject" in kw else 0.0
    for q in FILTERS[schema]:
        want = jds.query(schema, q, limit=limit, hints=JHints(**kw))
        got = tds.query(schema, q, limit=limit, hints=THints(**kw))
        try:
            same_collection(want, got, rtol)
        except AssertionError as e:
            raise AssertionError(f"{q}: {e}") from e
        if kw.get("loose") and kw.keys() == {"loose"}:
            # loose keeps every exact hit
            exact = set(np.asarray(jds.query(schema, q).ids).tolist())
            assert exact <= set(np.asarray(got.ids).tolist()), q


@pytest.mark.parametrize("cell", list(STORES))
def test_sorted_pages_concatenate_to_the_sorted_result(stores, cell):
    schema, jds, tds = stores[cell]
    key = "-dtg" if schema == "pts" else "-rank"
    q = FILTERS[schema][0]
    whole = tds.query(schema, q, hints=THints(sort_by=key))
    assert np.asarray(whole.ids).tolist() == \
        np.asarray(jds.query(schema, q, hints=JHints(sort_by=key)).ids).tolist()
    pages = []
    for off in range(0, len(whole) + 7, 7):
        page = tds.query(schema, q, limit=7, hints=THints(sort_by=key, offset=off))
        ref = jds.query(schema, q, limit=7, hints=JHints(sort_by=key, offset=off))
        assert np.asarray(page.ids).tolist() == np.asarray(ref.ids).tolist(), off
        pages.extend(np.asarray(page.ids).tolist())
    assert pages == np.asarray(whole.ids).tolist()


@pytest.mark.parametrize("cell", list(STORES))
def test_query_many_takes_per_query_hints_as_jax_does(stores, cell):
    schema, jds, tds = stores[cell]
    qs = FILTERS[schema]
    names = ["sort-desc", "sample", "loose", "page", "none"]
    per = [hints_for(schema, HINTS[names[i % len(names)]])[0] for i in range(len(qs))]
    want = jds.query_many(schema, qs, hints=[JHints(**k) for k in per])
    got = tds.query_many(schema, qs, hints=[THints(**k) for k in per])
    for w, g in zip(want, got):
        same_collection(w, g)
    one = hints_for(schema, HINTS["sort"])[0]
    for w, g in zip(jds.query_many(schema, qs, hints=JHints(**one)),
                    tds.query_many(schema, qs, hints=THints(**one))):
        same_collection(w, g)


BAD_HINTS = {
    "cache": {"cache": "always"},
    "crs": {"reproject": "EPSG:27700"},
    "sample-zero": {"sample": 0.0},
    "sample-big": {"sample": 1.5},
    "timeout-zero": {"timeout": 0.0},
    "timeout-negative": {"timeout": -1.0},
    "offset-negative": {"offset": -1},
    "offset-float": {"offset": 2.5},
}


@pytest.mark.parametrize("name", list(BAD_HINTS))
def test_invalid_hints_raise_as_jax_does(stores, name):
    _, jds, tds = stores["z3-once"]
    kw = BAD_HINTS[name]
    with pytest.raises(Exception) as want:
        jds.query("pts", FILTERS["pts"][0], hints=JHints(**kw))
    with pytest.raises(Exception) as got:
        tds.query("pts", FILTERS["pts"][0], hints=THints(**kw))
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    with pytest.raises(type(got.value)):
        THints(**kw).validate()


def test_valid_hints_validate():
    for spec in HINTS.values():
        kw = {k: v for k, v in spec.items() if k != "limit"}
        THints(**kw).validate()
    THints(cache="bypass").validate()
    THints(cache="pin", reproject="CRS:84").validate()


def test_loose_accepts_the_wide_plane_and_skips_refinement(stores):
    """A box-and-window query whose mask decides the filter: loose ids
    are the wide plane's rows (a superset of the exact ids), and the
    explain trail says nothing refined."""
    from geomesa_tpu_torch.planning.explain import Explainer

    _, jds, tds = stores["z3-once"]
    q = FILTERS["pts"][0]
    exp = Explainer()
    loose = tds.query("pts", q, explain=exp, hints=THints(loose=True))
    assert "Loose mode: device mask accepted without refinement" in exp.render()
    exact = tds.query("pts", q)
    plan = tds.planner.plan("pts", q)
    ordinals, _ = tds.table("pts", plan.index).scan(plan.config)
    assert sorted(np.asarray(loose.ids).tolist()) == sorted(
        np.asarray(tds.features("pts").ids)[ordinals].tolist())
    assert set(np.asarray(exact.ids).tolist()) <= set(np.asarray(loose.ids).tolist())
