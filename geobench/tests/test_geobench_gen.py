"""The seeded generators: the same seed gives the same data and requests,
another seed other ones with the same mix of shapes; the point generator
and the string vocabularies are chip_smoke's."""

import itertools
import os
import sys

import numpy as np

from geobench import gen
from geobench.run import load_spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ("gdelt-z3.dashboard",)


def small(cell, rows=5000):
    spec = load_spec(*cell.split(".", 1))
    spec["config"]["rows"] = rows
    return spec


def requests(spec, seed, client, n, warmup=False):
    cols = gen.make_columns(spec["config"], seed)
    s = gen.stream(spec["traffic"], spec["config"], seed, client, cols["centres"], warmup)
    return list(itertools.islice(s, n))


def key(r):
    return (r.ecql, r.box, r.window, r.transforms)


def test_columns_repeat_by_seed():
    cfg = small("gdelt-z3.dashboard")["config"]
    a, b = gen.make_columns(cfg, 2**31 + 7), gen.make_columns(cfg, 2**31 + 7)
    c = gen.make_columns(cfg, 2**31 + 8)
    for k in ("x", "y", "t"):
        assert np.array_equal(a[k], b[k])
        assert not np.array_equal(a[k], c[k])
    assert list(a["attrs"]) == list(cfg["attributes"])
    for name, v in a["attrs"].items():
        assert len(v) == cfg["rows"] and np.array_equal(v, b["attrs"][name])
        if name != "GLOBALEVENTID":
            assert not np.array_equal(v, c["attrs"][name]), name
    assert a["t"].min() >= gen.t0_ms(cfg) and a["t"].max() < gen.t0_ms(cfg) + gen.span_ms(cfg)


def test_attribute_shapes():
    cfg = small("gdelt-z3.dashboard", rows=20_000)["config"]
    a = gen.make_columns(cfg, 11)["attrs"]
    assert a["GLOBALEVENTID"][0] == "1100000000" and a["GLOBALEVENTID"][-1] == "1100019999"
    assert np.array_equal(a["GLOBALEVENTID"].astype(np.int64), 1_100_000_000 + np.arange(20_000))
    codes = set(a["EventCode"].tolist())
    assert all(c.isdigit() and 2 <= len(c) <= 4 for c in codes) and len(codes) > 100
    assert 0.25 < np.mean(a["Actor2Name"] == "") < 0.35
    assert all(len(c) == 3 for c in set(a["Actor1CountryCode"].tolist()) - {""})
    assert all(len(c) == 2 for c in set(a["ActionGeo_CountryCode"].tolist()) - {""})
    for name in ("NumMentions", "NumSources", "NumArticles", "ActionGeo_Type"):
        assert a[name].dtype == np.int32 and a[name].min() >= 0
    assert a["NumSources"].min() == 1 and set(np.unique(a["ActionGeo_Type"])) <= set(range(6))


def test_vocabularies_are_chip_smokes():
    sys.path.insert(0, ROOT)
    import chip_smoke

    assert gen.cameo_codes(np.random.default_rng(4), 300) == list(
        chip_smoke.cameo_codes(np.random.default_rng(4)))
    assert gen.actor_names(np.random.default_rng(4), 50) == list(
        chip_smoke.actor_names(np.random.default_rng(4), 50))


def test_points_are_chip_smokes():
    sys.path.insert(0, ROOT)
    import chip_smoke

    x, y, _ = gen.gdelt_points(10_000, np.random.default_rng(3))
    rx, ry = chip_smoke.gdelt_points(10_000, np.random.default_rng(3))
    assert np.array_equal(x, rx) and np.array_equal(y, ry)


def test_requests_repeat_by_seed_and_client():
    for cell in CELLS:
        spec = small(cell)
        a = [key(r) for r in requests(spec, 5, 0, 30)]
        assert a == [key(r) for r in requests(spec, 5, 0, 30)]
        assert a != [key(r) for r in requests(spec, 6, 0, 30)]
        assert a != [key(r) for r in requests(spec, 5, 1, 30)]
        assert a != [key(r) for r in requests(spec, 5, 0, 30, warmup=True)]


def test_every_seed_deals_the_same_shapes():
    spec = small("gdelt-z3.dashboard")
    shapes = [sorted((r.box[2] - r.box[0], r.box[3] - r.box[1], r.window[1] - r.window[0],
                      r.transforms or ()) for r in requests(spec, s, 0, 16)) for s in (1, 2)]
    assert shapes[0] == shapes[1]
    assert sum(1 for s in shapes[0] if s[3]) == 8


def test_request_shapes_are_the_quickstarts():
    spec = small("gdelt-z3.dashboard")
    t0 = gen.t0_ms(spec["config"])
    for r in requests(spec, 9, 0, 40):
        x0, y0, x1, y1 = r.box
        assert (x1 - x0, y1 - y0) == (45, 25) and all(float(v).is_integer() for v in r.box)
        assert -180 <= x0 and x1 <= 180 and -90 <= y0 and y1 <= 90
        assert r.window[1] - r.window[0] == 2 * gen.DAY_MS and (r.window[0] - t0) % gen.DAY_MS == 0
        assert r.window[1] <= t0 + gen.span_ms(spec["config"])
        assert r.ecql == (f"BBOX(geom, {int(x0)}, {int(y0)}, {int(x1)}, {int(y1)}) AND dtg "
                          f"DURING {gen.iso(r.window[0])}/{gen.iso(r.window[1])}")
        assert r.transforms in (None, ("GLOBALEVENTID", "dtg", "geom"))
