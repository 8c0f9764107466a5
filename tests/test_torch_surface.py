"""The port's public surface against the JAX package's, on the CPU.

Code written against ``geomesa_tpu`` must run when only its imports are
switched to ``geomesa_tpu_torch``. For every module of the reference
(found with ``pkgutil.walk_packages``), the port module at the same
dotted path must hold every name of the reference module's held set:

- every public top-level ``def``, ``class`` and assignment of its source
  (read with ``ast``);
- in a package ``__init__``, every name it exports through ``__all__``
  or ``from ... import``; the port's ``__init__`` must export it too
  (in its own source, not by a submodule imported elsewhere);
- every public attribute (method, property, class attribute) of every
  public class the module defines, and of every public module-level
  instance of such a class (``curve.zorder.Z2``), found with ``dir()``.

Where both sides are callable, the port's signature must accept every
parameter name of the reference's (the port may add names such as
``device`` and ``clock``).

The reference's ``scripts/*.py`` map to ``geomesa_tpu_torch/scripts/``
and ``examples/*.py`` to ``geomesa_tpu_torch/examples/``. Those files
are read with ``ast`` and never imported: five of the scripts run their
work at import. What a script or an example offers its user is held:
its entry points (``main``, ``run``) and its command-line flags. The
rest of its top level (timers, helpers, sizes) is the run's own
machinery, written for its device.

:data:`DELIBERATE` lists the only names the port leaves out, each with
its reason. Every listed name must exist in the reference and be absent
from the port, and the port module that would hold it names it in its
docstring, so the list cannot go stale.
"""

import ast
import importlib
import importlib.util
import inspect
import pkgutil
from pathlib import Path

import pytest

import geomesa_tpu

ROOT = Path(__file__).resolve().parent.parent
REF = "geomesa_tpu"
PORT = "geomesa_tpu_torch"

#: the names the port leaves out on purpose: dotted name -> reason. A
#: class's absence covers its attributes; a module's covers the module.
DELIBERATE = {
    "geomesa_tpu.enable_compile_cache":
        "JAX's persistent compile cache; the port's counterpart is the "
        "kernel build directory (kernels/build.py)",
    "geomesa_tpu.conf.PALLAS_MODE":
        "a knob that picks a backend (Pallas or XLA); the port has no such "
        "switch: a CPU tensor takes the plain version, a CUDA one the kernel",
    "geomesa_tpu.scan.block_kernels.use_pallas":
        "reads PALLAS_MODE to pick a backend, which the port forbids",
    "geomesa_tpu.conf.DENSITY_VMEM_BUDGET":
        "the TPU's VMEM budget for the density grid; the card has no VMEM",
    "geomesa_tpu.scan.block_kernels.PALLAS_MAX_EDGES":
        "the reference's unrolled-Pallas edge limit; the port's cap is MAX_EDGES",
    "geomesa_tpu.scan.block_kernels.PALLAS_MAX_RINTS":
        "the reference's unrolled-Pallas raster limit; the port's cap is MAX_RINTS",
    "geomesa_tpu.parallel.mesh.shard_spec":
        "a JAX NamedSharding; a torch mesh is a list of devices",
    "geomesa_tpu.parallel.mesh.replicated_spec":
        "a JAX NamedSharding; a torch mesh is a list of devices",
    "geomesa_tpu.analysis.rules.kernels.KERNEL_SCOPES":
        "scopes of the jax.jit rules, which have no port",
    "geomesa_tpu.analysis.rules.kernels.COERCIONS":
        "read only inside jax.jit functions",
    "geomesa_tpu.analysis.rules.kernels.DYNAMIC_SHAPE_CALLS":
        "read only inside jax.jit functions",
    "geomesa_tpu.analysis.rules.kernels.KernelTracedCoercionRule":
        "looks only inside jax.jit functions, which the port has none of",
    "geomesa_tpu.analysis.rules.kernels.KernelDynamicShapeRule":
        "looks only inside jax.jit functions, which the port has none of",
    "geomesa_tpu.analysis.rules.KernelTracedCoercionRule":
        "the re-export of a jax.jit rule that has no port",
    "geomesa_tpu.analysis.rules.KernelDynamicShapeRule":
        "the re-export of a jax.jit rule that has no port",
    "geomesa_tpu.cache.field":
        "a leaked dataclasses.field import, not API",
    "scripts.bench_gate":
        "gates bench JSON files the port does not write yet; it comes "
        "with the port's benchmark",
}


def _ref_modules() -> list:
    names = [REF] + [m.name for m in pkgutil.walk_packages(geomesa_tpu.__path__, REF + ".")]
    names += [f"scripts.{p.stem}" for p in sorted((ROOT / "scripts").glob("*.py"))]
    names += [f"examples.{p.stem}" for p in sorted((ROOT / "examples").glob("*.py"))]
    return names


MODULES = _ref_modules()
#: the modules whose surface the port holds (a whole-module absence is not walked)
HELD_MODULES = [m for m in MODULES if m not in DELIBERATE]


def _port_name(ref_module: str) -> str:
    if ref_module == REF or ref_module.startswith(REF + "."):
        return PORT + ref_module[len(REF):]
    return f"{PORT}.{ref_module}"


def _is_file_module(ref_module: str) -> bool:
    return ref_module.startswith(("scripts.", "examples."))


def _source(ref_module: str) -> Path:
    if _is_file_module(ref_module):
        return ROOT / (ref_module.replace(".", "/") + ".py")
    return Path(importlib.import_module(ref_module).__file__)


#: a script's or an example's entry points
ENTRY_POINTS = ("main", "run")


def _flags(path: Path) -> set:
    """The option strings a file passes to ``add_argument``."""
    return {a.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "add_argument"
            for a in n.args if isinstance(a, ast.Constant) and isinstance(a.value, str)}


def _top_level(path: Path, is_init: bool, with_assignments: bool = True) -> dict:
    """{public name: reference parameter names or None} of a source file's
    top level (the parameters of a ``def``, read from the AST)."""
    tree = ast.parse(path.read_text())
    names = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            names[node.name] = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
        elif isinstance(node, ast.ClassDef):
            names[node.name] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)) and with_assignments:
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for e in ([t] if isinstance(t, ast.Name) else getattr(t, "elts", [])):
                    if isinstance(e, ast.Name):
                        names[e.id] = None
        elif isinstance(node, ast.ImportFrom) and is_init:
            for alias in node.names:
                names[alias.asname or alias.name] = None
    if with_assignments:
        for node in tree.body:
            if (isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets)
                    and isinstance(node.value, (ast.List, ast.Tuple))):
                names.update({ast.literal_eval(e): None for e in node.value.elts})
    return {n: p for n, p in names.items() if not n.startswith("_")}


def _held(ref_module: str) -> dict:
    """{dotted name within the module: reference parameter names or None}."""
    path = _source(ref_module)
    if _is_file_module(ref_module):
        tops = _top_level(path, False, with_assignments=False)
        held = {n: p for n, p in tops.items() if n in ENTRY_POINTS}
        held.update({f: None for f in _flags(path) if f.startswith("-")})
        return held
    mod = importlib.import_module(ref_module)
    held = _top_level(path, path.name == "__init__.py")
    for name in list(held):
        obj = getattr(mod, name, None)
        if inspect.isclass(obj) and obj.__module__ == ref_module:
            owner = obj
        elif (obj is not None and not inspect.isclass(obj) and not inspect.ismodule(obj)
              and type(obj).__module__ == ref_module):
            owner = type(obj)
        else:
            continue
        for attr in dir(owner):
            if not attr.startswith("_"):
                held[f"{name}.{attr}"] = None
    return held


def _deliberate(ref_module: str, dotted: str) -> bool:
    parts = f"{ref_module}.{dotted}".split(".")
    return any(".".join(parts[:i]) in DELIBERATE for i in range(1, len(parts) + 1))


def _resolve(obj, dotted: str):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


_MISSING = object()


def _lookup(obj, dotted: str):
    try:
        return _resolve(obj, dotted)
    except AttributeError:
        return _MISSING


def _params(obj):
    try:
        return inspect.signature(obj).parameters
    except (TypeError, ValueError):
        return None


def _named(params) -> list:
    return [n for n, p in params.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _accepts_all(port_params, ref_names) -> list:
    """Reference parameter names the port's signature does not accept."""
    if any(p.kind == p.VAR_KEYWORD for p in port_params.values()):
        return []
    return [n for n in ref_names if n not in port_params]


@pytest.mark.parametrize("ref_module", HELD_MODULES)
def test_port_module_holds_the_reference_surface(ref_module):
    port_name = _port_name(ref_module)
    port = importlib.import_module(port_name)
    held = _held(ref_module)
    ref = None if _is_file_module(ref_module) else importlib.import_module(ref_module)
    port_path = Path(port.__file__)
    own = (_top_level(port_path, True) if port_path.name == "__init__.py" else None)
    flags = _flags(port_path) if _is_file_module(ref_module) else set()

    missing, narrower = [], []
    for dotted, ref_args in sorted(held.items()):
        if _deliberate(ref_module, dotted):
            continue
        if dotted.startswith("-"):
            if dotted not in flags:
                missing.append(f"the flag {dotted}")
            continue
        if own is not None and "." not in dotted and dotted not in own:
            missing.append(f"{dotted} (not exported by the port's __init__)")
            continue
        p_obj = _lookup(port, dotted)
        if p_obj is _MISSING:
            missing.append(dotted)
            continue
        if ref is not None:
            r_obj = _lookup(ref, dotted)
            if r_obj is _MISSING or not (callable(r_obj) and callable(p_obj)):
                continue
            r_params = _params(r_obj)
            ref_args = None if r_params is None else _named(r_params)
        if ref_args is None or not callable(p_obj):
            continue
        p_params = _params(p_obj)
        if p_params is None:
            continue
        lost = _accepts_all(p_params, ref_args)
        if lost:
            narrower.append(f"{dotted}({', '.join(lost)})")
    assert not missing, f"{port_name} lacks the reference's {missing}"
    assert not narrower, f"{port_name} does not accept the reference's parameters {narrower}"


def _split(dotted: str) -> tuple:
    """(reference module, name within it) of a DELIBERATE key: the longest
    module prefix."""
    for ref_module in sorted(MODULES, key=len, reverse=True):
        if dotted == ref_module:
            return ref_module, ""
        if dotted.startswith(ref_module + "."):
            return ref_module, dotted[len(ref_module) + 1:]
    raise AssertionError(f"{dotted} names no module of the reference")


def _port_module_or_parent(port_name: str):
    while True:
        try:
            return importlib.import_module(port_name)
        except ModuleNotFoundError:
            port_name = port_name.rsplit(".", 1)[0]


@pytest.mark.parametrize("dotted", sorted(DELIBERATE))
def test_deliberate_absence_exists_in_the_reference_and_not_in_the_port(dotted):
    ref_module, name = _split(dotted)
    assert DELIBERATE[dotted].strip()
    if name:
        assert name in _held(ref_module), f"{dotted} is not in the reference's surface"
        port = importlib.import_module(_port_name(ref_module))
        assert _lookup(port, name) is _MISSING, f"{dotted} is in the port: drop it from the list"
        leaf = name
    else:
        assert _source(ref_module).exists(), f"{dotted} is not in the reference"
        port_name = _port_name(ref_module)
        assert importlib.util.find_spec(port_name) is None, f"{port_name} exists in the port"
        port = _port_module_or_parent(port_name)
        leaf = ref_module.rsplit(".", 1)[-1]
    doc = port.__doc__ or ""
    assert leaf in doc, f"{port.__name__}'s docstring does not name its absence {leaf}"


def test_the_walk_covers_the_reference():
    # every module of the package, every script and example file
    files = {p for p in (ROOT / REF).rglob("*.py")}
    walked = {_source(m) for m in MODULES if not _is_file_module(m)}
    assert files == walked
    assert {p.stem for p in (ROOT / "examples").glob("*.py")} == {
        m.split(".", 1)[1] for m in MODULES if m.startswith("examples.")}
