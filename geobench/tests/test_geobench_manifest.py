"""BENCHMARK.json against the benchmark's contract: its keys, names and
units, and every cell resolving to its configuration, traffic and metric
files."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        return json.load(f)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(manifest):
    assert set(manifest) == KEYS
    assert 1 <= len(manifest["paths"]) <= 16 and all(PATH.match(p) for p in manifest["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in manifest["paths"])
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    for w in cmd[1:]:
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w == p or w.startswith(p + "/") for p in manifest["paths"])
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's time
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(manifest):
    groups = ("configs", "workloads", "end_to_end", "per_layer")
    for g in groups:
        names = [e["name"] for e in manifest[g]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for g in ("end_to_end", "per_layer"):
        for m in manifest[g]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in manifest["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_configs_and_cells_resolve(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    used = set()
    pairs = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"]) and c["source"].startswith("https://")
        assert c["file"] == f"geobench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert body["source"] == c["source"]
    assert 1 <= len(manifest["workloads"]) <= 24
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and line(w["why"])
        assert os.path.isfile(os.path.join(ROOT, "geobench", "traffic", f"{w['traffic']}.json"))
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == set(configs)
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= max(
        1, len(manifest["workloads"]) // 4)


def test_metrics(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert 1 <= len(e2e) <= 16 and 1 <= len(manifest["per_layer"]) <= 128

    def cells_of(m):
        return set(m.get("workloads", cells))

    for m in e2e.values():
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert cells_of(m) <= cells
    for cell in cells:
        reported = [n for n, m in e2e.items() if cell in cells_of(m)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in cells_of(m) for m in manifest["per_layer"])
    layers = {}
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and line(m["layer"])
        # every cell it is read in reports the metric it moves
        assert cells_of(m) <= cells_of(e2e[m["moves"]])
        assert os.path.isfile(os.path.join(ROOT, "geobench", "metrics", f"{m['name']}.py"))
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
