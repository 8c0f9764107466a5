"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package
(top-level module names compared whole: geomesa_tpu_torch begins with
geomesa_tpu), and the reference loads nothing of the program."""

import ast
import glob
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "geomesa_tpu"}

RUN_SMALL = """
import glob, json, os, sys
sys.path.insert(0, {root!r})
from geobench import control, run
readers = [os.path.basename(p)[:-3] for p in glob.glob({root!r} + "/geobench/metrics/*.py")]
for cell in ("gdelt-z3.dashboard",):
    spec = run.load_spec(*cell.split(".", 1))
    spec["config"]["rows"] = 20000
    spec["config"]["ingest"]["chunk_rows"] = 8192
    spec["traffic"]["clients"] = 2
    out = run.run_cell(spec, 3, 0.5, True, "cpu")
    for name in readers:
        run.metric_reader(name)(out["ctx"])
    control.control_numbers(spec, 3, 16, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = top_level_modules(RUN_SMALL.format(root=ROOT))
    assert "geomesa_tpu_torch" in mods and "torch" in mods
    assert not mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, %r); import geobench.reference.brute, "
            "geobench.check; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % ROOT)
    mods = top_level_modules(code)
    assert not mods & (FORBIDDEN | {"geomesa_tpu_torch"})
    for path in glob.glob(os.path.join(ROOT, "geobench", "reference", "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            assert all(n.split(".")[0] in ("torch", "numpy", "__future__") for n in names), path


def test_no_benchmark_source_imports_jax():
    for path in glob.glob(os.path.join(ROOT, "geobench", "**", "*.py"), recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & FORBIDDEN, path
