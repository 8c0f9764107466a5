"""The frozen reference and the comparison against cases worked by hand."""

import numpy as np
import pytest
import torch

from geobench import check, gen
from geobench.reference.brute import Rows

T0 = 1_700_000_000_000
CONFIG = {"spec": "name:String,dtg:Date,*geom:Point:srid=4326", "geom": "geom", "dtg": "dtg"}


def rows(dtype=torch.float64, timed=True):
    x = np.array([0.0, 1.0, 2.0, 2.0, -1.0, 0.5, 0.25, 10.0])
    y = np.array([0.0, 1.0, 2.0, 2.5, 0.0, 0.5, 0.75, 10.0])
    t = T0 + np.array([0, 10, 20, 30, 40, 50, 60, 70]) if timed else None
    return Rows(x, y, t, dtype=dtype)


def ids(tensor):
    return tensor.tolist()


def test_bbox_edges_are_closed_and_during_half_open():
    r = rows()
    assert ids(r.bbox_ids((0, 0, 2, 2))) == [0, 1, 2, 5, 6]
    assert ids(r.bbox_ids((0, 0, 2, 2), (T0 + 10, T0 + 20))) == [1]
    assert ids(r.bbox_ids((0, 0, 2, 2), (T0, T0 + 11))) == [0, 1]
    assert ids(r.bbox_ids((5, 5, 6, 6))) == []
    untimed = rows(timed=False)
    assert ids(untimed.bbox_ids((-1, 0, 0.5, 0.5))) == [0, 4, 5]


def test_digest_is_order_free_and_sees_one_id():
    a = check.digest(np.array([3, 1, 2]))
    assert a == check.digest(np.array([1, 2, 3])) == check.digest([2, 3, 1])
    assert a[0] == 3
    assert a != check.digest([1, 2]) and a != check.digest([1, 2, 4])
    assert a != check.digest([1, 2, 3, 3]) and check.digest([1, 1]) != check.digest([2, 2])
    assert check.digest(np.zeros(0, np.int64)) == (0, 0, 0)


def cols_of(n=6):
    rng = np.random.default_rng(1)
    return {"x": rng.uniform(-10, 10, n), "y": rng.uniform(-10, 10, n), "t": T0 + np.arange(n),
            "attrs": {"name": np.array([f"N{i}" for i in range(n)])}}


def features_of(cols, sel, names=("name", "dtg", "geom")):
    columns = {"name": cols["attrs"]["name"][sel], "dtg": cols["t"][sel],
               "geom": check.Points(cols["x"][sel], cols["y"][sel])}
    return check.Features(sel, {k: columns[k] for k in names})


def test_values_are_held_to_the_written_rows():
    cols = cols_of()
    req = gen.Request(0, 0, "bbox", box=(-10, -10, 10, 10))
    sel = np.array([4, 1, 2])
    assert not check.values_wrong(features_of(cols, sel), cols, CONFIG, req)
    bad = features_of(cols, sel)
    bad.columns["name"] = bad.columns["name"].copy()
    bad.columns["name"][1] = "N9"
    assert check.values_wrong(bad, cols, CONFIG, req)
    moved = features_of(cols, sel)
    moved.columns["geom"] = check.Points(moved.columns["geom"].x + 1e-12, moved.columns["geom"].y)
    assert check.values_wrong(moved, cols, CONFIG, req)
    # a projection returns just its attributes, in its order
    proj = gen.Request(0, 0, "bbox", box=(-10, -10, 10, 10), transforms=("name", "geom"))
    assert not check.values_wrong(features_of(cols, sel, ("name", "geom")), cols, CONFIG, proj)
    assert check.values_wrong(features_of(cols, sel), cols, CONFIG, proj)


def test_a_lower_precision_moves_a_row_across_an_edge():
    # 100.00000001 rounds to 100.0 in float32: inside a box whose edge is 100
    x = np.array([100.00000001, 50.0])
    y = np.array([10.0, 10.0])
    f64 = Rows(x, y, dtype=torch.float64)
    f32 = Rows(x, y, dtype=torch.float32)
    assert ids(f64.bbox_ids((0, 0, 100, 20))) == [1]
    assert ids(f32.bbox_ids((0, 0, 100, 20))) == [0, 1]
    req = gen.Request(0, 0, "bbox", box=(0, 0, 100, 20))
    cols = {"x": x, "y": y, "t": None, "attrs": {}}
    config = {"spec": "*geom:Point:srid=4326", "geom": "geom"}
    answers = check.control_answers(cols, config, [req], lambda r: True, "cpu")
    judged = check.judge(answers, f64, cols, config)
    assert judged["checks"]["wrong_answers"]["value"] == 1
    # its returned coordinates are held in float32 too
    assert judged["checks"]["wrong_values"]["value"] == 1 and not check.verdict(judged)


@pytest.mark.gpu
def test_reference_on_the_card_equals_the_cpu(cuda):
    rng = np.random.default_rng(1)
    x, y, _ = gen.gdelt_points(200_000, rng)
    t = T0 + rng.integers(0, 86_400_000, 200_000)
    a, b = Rows(x, y, t), Rows(x, y, t, device=cuda)
    assert torch.equal(a.bbox_ids((-20, -10, 30, 40), (T0, T0 + 3_600_000)),
                       b.bbox_ids((-20, -10, 30, 40), (T0, T0 + 3_600_000)).cpu())
