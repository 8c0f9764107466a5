"""The port's examples against the reference's, on the CPU.

Each reference example (examples/<name>.py) runs as tests/test_examples.py
runs it: loaded by path, JAX on the CPU with the 8 virtual devices of
tests/conftest.py. Its port (geomesa_tpu_torch/examples/<name>.py) runs
with ``device="cpu"``; the distributed example's mesh is 8 virtual
shards of the CPU. Both packages load their native helpers. Required:

- the same returned results: ids in order (every batch member's too),
  counts, and for the SQL rows every column;
- the same printed lines, every one of them (no line differs on the CPU;
  ``explain`` names no device);
- the port's ``record`` holds what the prints summarize, equal to the
  printed figures (the density grid's sum, the tile masses, the join's
  pair count and busiest cell).
"""

import contextlib
import importlib
import inspect
import io
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_native import ensure_jax_native

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ["quickstart", "batch_and_update", "distributed_mesh", "sql_and_joins",
            "streaming_hot_tier"]


def _run(fn) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    ensure_jax_native()


@pytest.fixture(scope="module")
def runs():
    """{(side, name): run}, each example run once per side and module."""
    return {}


def _reference(name, runs, monkeypatch):
    """(result, printed lines) of the reference's example."""
    if ("ref", name) not in runs:
        monkeypatch.syspath_prepend(str(ROOT))  # import geomesa_tpu from any cwd
        mod = runpy.run_path(str(ROOT / "examples" / f"{name}.py"))
        runs["ref", name] = _run(mod["main"])
    return runs["ref", name]


def _port(name, runs):
    """(result, printed lines, record) of the port's example on the CPU."""
    if ("port", name) not in runs:
        mod = importlib.import_module(f"geomesa_tpu_torch.examples.{name}")
        record = {}
        out, lines = _run(lambda: mod.main(device="cpu", record=record))
        runs["port", name] = (out, lines, record)
    return runs["port", name]


def _ids(fc):
    return np.asarray(fc.ids)


def _same_collection(a, b):
    assert len(a) == len(b)
    np.testing.assert_array_equal(_ids(a), _ids(b))


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_the_reference_lines(name, runs, monkeypatch):
    _, ref_lines = _reference(name, runs, monkeypatch)
    _, lines, _ = _port(name, runs)
    assert ref_lines, f"the reference's {name} printed nothing"
    assert lines == ref_lines


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_returns_the_reference_results(name, runs, monkeypatch):
    ref, _ = _reference(name, runs, monkeypatch)
    out, lines, record = _port(name, runs)
    if isinstance(ref, list):
        assert len(out) == len(ref)
        for a, b in zip(out, ref):
            _same_collection(a, b)
    else:
        _same_collection(out, ref)
    if name == "sql_and_joins":
        assert list(out.columns) == list(ref.columns)
        for col in ref.columns:
            np.testing.assert_array_equal(np.asarray(out.columns[col]),
                                          np.asarray(ref.columns[col]))
    _record_matches_prints(name, record, lines)


def _record_matches_prints(name, record, lines):
    if name == "quickstart":
        assert lines[1] == f"density grid sums to {record['grid'].sum():.0f}"
        assert lines[0].endswith(f"estimate was {record['estimate']}")
        assert lines[0].startswith(f"{len(record['ids'])} hits")
    elif name == "batch_and_update":
        assert lines[1] == f"tile masses: {[int(t.sum()) for t in record['tiles']]}"
        assert record["moved"] == len(record["relocated"]) and record["count"] == 100_000
    elif name == "distributed_mesh":
        assert lines[0].startswith(f"{len(record['ids'])} hits")
    elif name == "sql_and_joins":
        li, _ = record["pairs"]
        busiest = np.bincount(li, minlength=32).max()
        assert lines[1] == f"join: {len(li)} pairs; busiest cell holds {busiest} ships"
    else:
        assert lines[2] == (f"micro-batch flushed {record['flushed']}; merged hits: "
                            f"{len(record['merged_ids'])}")


def test_every_reference_example_has_its_port():
    ref = {p.stem for p in (ROOT / "examples").glob("*.py")}
    port = {p.stem for p in (ROOT / "geomesa_tpu_torch" / "examples").glob("*.py")} - {
        "__init__"}
    assert ref == set(EXAMPLES) == port


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card(name):
    main = importlib.import_module(f"geomesa_tpu_torch.examples.{name}").main
    assert inspect.signature(main).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"), \
                contextlib.redirect_stdout(io.StringIO()):
            main()
