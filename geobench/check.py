"""How a run decides ``correct``: every answer the window's clients got is
held against the plain reference (``reference.brute``) on the same seeded
rows and the same request parameters.

Numbers compared, each with its limit:

- ``missing_answers``: requests whose answer never came (an error or a
  shed); limit 0.
- ``wrong_answers``: queries whose feature ids are not exactly the
  reference's f64 ids, every query of the window compared; limit 0. A
  client keeps each answer's ids as a ``digest`` (their count and two
  order-free 64-bit sums of a mixing hash): keeping every answer's ids
  through the window cost the store a quarter of its rate on the card.
- ``wrong_values``: of the sampled queries (``clients.sampler``), those
  whose features do not carry exactly the values their rows were written
  with, or not exactly the attributes the query asked for; limit 0.

The control puts the reference in the program's place one precision
lower than the configuration states: float32 positions and box bounds,
both for the rows it selects and for the coordinates it returns.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from geobench.reference.brute import Rows

LIMITS = {"missing_answers": 0, "wrong_answers": 0, "wrong_values": 0}
CONTROL_DTYPE = torch.float32


@dataclass
class Points:
    x: np.ndarray
    y: np.ndarray


@dataclass
class Features:
    """What the check reads of an answer's features: ids and columns by
    attribute name, the geometry with ``x`` and ``y``."""

    ids: np.ndarray
    columns: dict


def _mix64(v: np.ndarray) -> np.ndarray:
    """splitmix64's finaliser over uint64 values."""
    with np.errstate(over="ignore"):
        z = v + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def digest(ids) -> tuple:
    """(count, sum of mix64(id), sum of mix64(mix64(id))) mod 2**64: the
    same for the same multiset of ids in any order."""
    h = _mix64(np.asarray(ids, dtype=np.int64).view(np.uint64))
    with np.errstate(over="ignore"):
        return (len(h), int(h.sum(dtype=np.uint64)), int(_mix64(h).sum(dtype=np.uint64)))


def rows_of(cols: dict, device, dtype=torch.float64) -> Rows:
    return Rows(cols["x"], cols["y"], cols["t"], device=device, dtype=dtype)


def expected_columns(config: dict, req) -> list:
    if req.transforms is not None:
        return list(req.transforms)
    return [a.split(":")[0].lstrip("*") for a in config["spec"].split(",")]


def values_wrong(features, cols: dict, config: dict, req) -> bool:
    """Whether ``features`` differ from the written rows: the attributes
    the query asked for, each value exactly."""
    names = expected_columns(config, req)
    if list(features.columns) != names:
        return True
    ids = np.asarray(features.ids, dtype=np.int64)
    for name in names:
        got = features.columns[name]
        if name == config["geom"]:
            pairs = ((got.x, cols["x"]), (got.y, cols["y"]))
        elif name == config.get("dtg"):
            pairs = ((got, cols["t"]),)
        else:
            pairs = ((got, cols["attrs"][name]),)
        for have, written in pairs:
            have = np.asarray(have)
            if have.shape != ids.shape or not np.array_equal(have, written[ids]):
                return True
    return False


def judge(answers, rows: Rows, cols: dict, config: dict) -> dict:
    """Numbers compared over ``answers`` of (request, ids digest or None,
    error, features or None) against the f64 ``rows`` and the written ``cols``:
    {"checks": {name: {"value", "limit"}}, "compared": answers compared}."""
    missing = wrong = wrong_vals = compared = 0
    for req, ids, error, features in answers:
        if error is not None:
            missing += 1
            continue
        if ids is None:
            continue
        compared += 1
        wrong += ids != digest(rows.bbox_ids(req.box, req.window).cpu().numpy())
        if features is not None:
            wrong_vals += values_wrong(features, cols, config, req)
    values = {"missing_answers": missing, "wrong_answers": wrong, "wrong_values": wrong_vals}
    checks = {k: {"value": values[k], "limit": LIMITS[k]} for k in LIMITS}
    return {"checks": checks, "compared": compared}


def verdict(judged: dict) -> bool:
    return judged["compared"] > 0 and all(
        c["value"] <= c["limit"] for c in judged["checks"].values())


def control_answers(cols: dict, config: dict, requests, keep, device) -> list:
    """The control's answers to ``requests``: the reference one precision
    below the configuration's in the program's place, its sampled answers'
    features with the coordinates it holds."""
    low = rows_of(cols, device, CONTROL_DTYPE)
    out = []
    for req in requests:
        ids = low.bbox_ids(req.box, req.window).cpu().numpy()
        features = None
        if keep(req):
            columns = {}
            for name in expected_columns(config, req):
                if name == config["geom"]:
                    columns[name] = Points(*(cols[k][ids].astype(np.float32).astype(np.float64)
                                             for k in ("x", "y")))
                elif name == config.get("dtg"):
                    columns[name] = cols["t"][ids]
                else:
                    columns[name] = cols["attrs"][name][ids]
            features = Features(ids, columns)
        out.append((req, digest(ids), None, features))
    del low
    return out
