"""The port's rules: what it imports, where it runs, what it refuses.

- ``geomesa_tpu_torch`` and all its submodules import neither jax nor
  anything of ``geomesa_tpu`` (checked in a fresh interpreter, since this
  test process has jax loaded by tests/conftest.py);
- ``DataStore()`` defaults to the card and raises where there is none;
- the kernel wrappers route by the device of their tensors and never fall
  back: a device without a kernel raises. Every leg is ported: the
  point-in-polygon, raster and extent legs take the plain version on the
  CPU and raise for a device without a kernel;
- every kernel, the system's five and the chip-side probes' three, has
  its CUDA source in the checkout and builds for sm_90a without fast
  math;
- the native host helpers (``geomesa_tpu_torch/native``) are the port's
  own copy: the same C++ code as the JAX package's, built with
  ``-ffp-contract=off``, by a loader that reads no environment variable;
- every knob of ``geomesa_tpu_torch.conf`` is a knob of the JAX package
  under the same name, with the same default and the same parsing: the
  port adds no knob of its own;
- the streaming tier's modules (``streaming`` and its five modules,
  ``utils.spatial_index``, ``io.varint``, ``ingest.sort``) import neither
  jax nor anything of ``geomesa_tpu``, each on its own in a fresh
  interpreter, and ``LambdaStore.recover`` loads onto the card unless
  told otherwise (it raises where there is none);
- the persistence slice's modules (``fault``, ``lockwitness``,
  ``storage.metadata``, ``storage.adapter``, ``storage.persist``) import
  neither jax nor anything of ``geomesa_tpu``, each on its own in a fresh
  interpreter, and ``lockwitness.witness`` hands back the lock it was
  given while the witness is disarmed; so do the statistics, visibility,
  view and cache modules (``stats.store``, ``obs.accuracy``,
  ``security``, ``views``, ``cache`` and its four modules).
"""

import importlib.util
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import DataStore
from geomesa_tpu_torch.scan import aggregations as tagg
from geomesa_tpu_torch.scan import block_kernels as tbk

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import geomesa_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "geomesa_tpu" or m.startswith("geomesa_tpu."))
print(len(names), bad)
"""


def test_package_imports_no_jax_and_nothing_of_geomesa_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 40  # every submodule was imported
    assert bad.strip() == "[]", bad
    # the submodules of the many-query and polygon slices are among them
    for name in ("serving.scheduler", "stats.stat_spec", "stats.sketches", "utils.hashing",
                 "filter.raster", "scan.probe_kernels", "scripts.probe_pallas",
                 "scripts.probe_agg", "native", "index.attribute", "utils.lexicode",
                 "metrics", "audit", "obs.trace", "planning.errors", "planning.hints",
                 "planning.guards", "io.converters", "sql.functions", "fault",
                 "lockwitness", "storage.metadata", "storage.adapter", "storage.persist",
                 "stats.store", "obs.accuracy", "security", "views", "cache",
                 "cache.fingerprint", "cache.generations", "cache.result", "cache.tiles",
                 "serving.tenancy", "obs.slo", "obs.ops", "streaming", "streaming.wal",
                 "streaming.cache", "streaming.flush", "streaming.store", "streaming.stream",
                 "utils.spatial_index", "io.varint", "ingest", "ingest.sort"):
        assert importlib.util.find_spec(f"geomesa_tpu_torch.{name}") is not None


def test_datastore_defaults_to_cuda_and_raises_without_it(monkeypatch):
    assert inspect.signature(DataStore).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataStore()
    assert DataStore(device="cpu").device == torch.device("cpu")


def _cols(device, names=("x", "y")):
    return tuple(
        torch.zeros((2, 32, 128), dtype=torch.float32, device=device) for _ in names
    )


BIDS = np.zeros(32, np.int32)
BOXES = tbk.pack_boxes(np.array([[0.0, 0.0, 1.0, 1.0]], np.float32), None)
WINS = tbk.pack_windows(None, None)
KW = dict(col_names=("x", "y"), has_boxes=True, has_windows=False)
EXT = ("gxmin", "gymin", "gxmax", "gymax")
EXT_KW = dict(KW, col_names=EXT, extent=True)
GB = np.array([-1, -1, 1, 1], np.float32)


def _extent_leg(device):
    """The extent leg over all-zero extents (every row a point bbox at the
    origin, inside BOXES): the plain versions on the CPU, the same planes,
    pops, grid and bounds as the plain functions, and no fallback on a
    device without a kernel."""
    cols = _cols(device, EXT)
    if device == "meta":
        with pytest.raises(ValueError, match="no scan kernel"):
            tbk.block_scan(cols, BIDS, BOXES, WINS, **EXT_KW)
        with pytest.raises(ValueError, match="no bounds kernel"):
            tagg.block_bounds(cols, BIDS - 1, BOXES, WINS, **EXT_KW)
        with pytest.raises(ValueError, match="no density kernel"):
            tagg.block_density(cols, BIDS - 1, BOXES, WINS, GB, width=4, height=4, **EXT_KW)
        return
    named = dict(zip(EXT, cols))
    plain = dict(has_boxes=True, has_windows=False, extent=True)
    w, i = tbk.block_scan(cols, BIDS, BOXES, WINS, **EXT_KW)
    pw, pi = tbk.block_scan_plain(named, torch.from_numpy(BIDS), torch.from_numpy(BOXES),
                                  torch.from_numpy(WINS), **plain)
    assert i is None and pi is None  # an extent box scan writes no inner plane
    assert torch.equal(w, pw) and (w == -1).all()  # every row's bit set
    args = (named, torch.from_numpy(BIDS - 1), torch.from_numpy(BOXES), torch.from_numpy(WINS))
    assert torch.equal(tagg.block_bounds(cols, BIDS - 1, BOXES, WINS, **EXT_KW),
                       tagg.bounds_plain(*args, **plain))
    grid = tagg.block_density(cols, BIDS - 1, BOXES, WINS, GB, width=4, height=4, **EXT_KW)
    assert torch.equal(grid, tagg.density_plain(*args, torch.from_numpy(GB), width=4, height=4,
                                                **plain))
    assert grid.sum() == 0  # pad slots (bid -1) count nothing


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("leg", [
    dict(edges=np.zeros((16, 128), np.float32), n_edges=16),
    dict(rast=np.zeros((17, 128), np.float32), n_rints=16),
    dict(extent=True),
])
def test_ported_legs_take_plain_on_cpu_and_raise_without_a_kernel(device, leg):
    """Each polygon and extent leg of the scan and the aggregations: the
    plain version on the CPU, a raise on a device without a kernel."""
    if "extent" in leg:
        _extent_leg(device)
        return
    # a ported polygon leg: the plain version on the CPU (zero blocks
    # select nothing), and no fallback on a device without a kernel
    if device == "meta":
        with pytest.raises(ValueError, match="no scan kernel"):
            tbk.block_scan(_cols(device), BIDS, BOXES, WINS, **KW, **leg)
        return
    w, i = tbk.block_scan(_cols(device), BIDS, BOXES, WINS, **KW, **leg)
    pw, pi = tbk.block_scan_plain(
        dict(zip(KW["col_names"], _cols(device))), torch.from_numpy(BIDS),
        torch.from_numpy(BOXES), torch.from_numpy(WINS), has_boxes=True, has_windows=False,
        edges=torch.from_numpy(leg["edges"]) if "edges" in leg else None,
        rast=torch.from_numpy(leg["rast"]) if "rast" in leg else None,
    )
    assert torch.equal(w, pw) and torch.equal(i, pi) and not w.any()


QIDS = np.zeros(32, np.int32)
STACK_BOXES = np.stack([BOXES] * 8)
STACK_WINS = np.stack([WINS] * 8)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("leg", [
    dict(edges=np.zeros((8, 16, 128), np.float32), n_edges=16, spip=np.zeros(32, np.int32)),
    dict(rasts=np.zeros((8, 17, 128), np.float32), n_rints=16, spip=np.zeros(32, np.int32)),
    dict(spip=np.zeros(32, np.int32)),
    dict(extent=True),
])
def test_ported_fused_legs_take_plain_on_cpu_and_raise_without_a_kernel(device, leg):
    """Each leg of the fused scan (the edge and raster stacks, a selector
    without one, the extent leg) and the count over the extent leg: the
    plain version on the CPU, a raise on a device without a kernel."""
    if "extent" in leg:
        # the fused extent leg and the popcount over it: plain on the CPU
        cols = _cols(device, EXT)
        if device == "meta":
            with pytest.raises(ValueError, match="no fused scan kernel"):
                tbk.block_scan_multi(cols, BIDS, QIDS, STACK_BOXES, STACK_WINS, **EXT_KW)
            with pytest.raises(ValueError, match="no count kernel"):
                tagg.block_pops(cols, BIDS, BOXES, WINS, **EXT_KW)
            return
        named = dict(zip(EXT, cols))
        w, i = tbk.block_scan_multi(cols, BIDS, QIDS, STACK_BOXES, STACK_WINS, **EXT_KW)
        pw, pi = tbk.block_scan_multi_plain(
            named, torch.from_numpy(BIDS), torch.from_numpy(QIDS), torch.from_numpy(STACK_BOXES),
            torch.from_numpy(STACK_WINS), has_boxes=True, has_windows=False, extent=True,
        )
        assert i is None and pi is None and torch.equal(w, pw) and (w == -1).all()
        pops = tagg.block_pops(cols, BIDS, BOXES, WINS, **EXT_KW)
        assert (pops == 32 * 128).all()
        return
    # the ported stacks (or a selector without one, which the JAX
    # package ignores): the plain version on the CPU, no fallback
    # elsewhere
    if device == "meta":
        with pytest.raises(ValueError, match="no fused scan kernel"):
            tbk.block_scan_multi(_cols(device), BIDS, QIDS, STACK_BOXES, STACK_WINS,
                                 **KW, **leg)
        return
    w, i = tbk.block_scan_multi(_cols(device), BIDS, QIDS, STACK_BOXES, STACK_WINS,
                                **KW, **leg)
    pw, pi = tbk.block_scan_multi_plain(
        dict(zip(KW["col_names"], _cols(device))), torch.from_numpy(BIDS),
        torch.from_numpy(QIDS), torch.from_numpy(STACK_BOXES), torch.from_numpy(STACK_WINS),
        has_boxes=True, has_windows=False,
        edges=torch.from_numpy(leg["edges"]) if "edges" in leg else None,
        rasts=torch.from_numpy(leg["rasts"]) if "rasts" in leg else None,
        spip=torch.from_numpy(leg["spip"]),
    )
    assert torch.equal(w, pw) and torch.equal(i, pi)


def test_device_without_kernel_raises_instead_of_falling_back():
    """A tensor off the CPU goes to a kernel or the call raises: the
    wrappers never hand a non-CPU tensor to the plain version."""
    with pytest.raises(ValueError, match="no scan kernel"):
        tbk.block_scan(_cols("meta"), BIDS, BOXES, WINS, **KW)
    with pytest.raises(ValueError, match="no bounds kernel"):
        tagg.block_bounds(_cols("meta"), BIDS - 1, BOXES, WINS, **KW)
    with pytest.raises(ValueError, match="no fused scan kernel"):
        tbk.block_scan_multi(_cols("meta"), BIDS, QIDS, STACK_BOXES, STACK_WINS, **KW)
    with pytest.raises(ValueError, match="no count kernel"):
        tagg.block_pops(_cols("meta"), BIDS, BOXES, WINS, **KW)
    with pytest.raises(ValueError, match="no density kernel"):
        tagg.block_density(
            _cols("meta"), BIDS - 1, BOXES, WINS, np.array([0, 0, 1, 1], np.float32),
            width=4, height=4, **KW,
        )


def test_cpu_wrappers_take_the_plain_versions_and_launch_nothing():
    from geomesa_tpu_torch.kernels import KERNELS

    before = [k.launches for k in KERNELS]
    w, i = tbk.block_scan(_cols("cpu"), BIDS, BOXES, WINS, **KW)
    assert w.shape == (32, 1, 128) and w.device.type == "cpu"
    tagg.block_bounds(_cols("cpu"), BIDS - 1, BOXES, WINS, **KW)
    w, i = tbk.block_scan_multi(_cols("cpu"), BIDS, QIDS, STACK_BOXES, STACK_WINS, **KW)
    assert w.shape == (32, 1, 128) and w.device.type == "cpu"
    assert tagg.block_pops(_cols("cpu"), BIDS, BOXES, WINS, **KW).shape == (32,)
    assert [k.launches for k in KERNELS] == before
    assert len(KERNELS) == 5


def test_kernel_sources_and_build_flags(monkeypatch):
    """Every kernel, the probes' too, has its CUDA source in the checkout
    naming the Pallas kernel it replaces; a first launch builds its own
    group only (the probes stay out of KERNELS, which the system's paths
    launch, and out of their build); the build targets sm_90a without
    fast math."""
    from geomesa_tpu_torch.kernels import KERNELS, PROBE_KERNELS, build
    from geomesa_tpu_torch.kernels.build import NVCC_FLAGS

    assert len(PROBE_KERNELS) == 3 and not set(PROBE_KERNELS) & set(KERNELS)
    built = []

    def record(kernels=KERNELS, verbose=False):
        built.append(kernels)
        raise RuntimeError("no build here")

    monkeypatch.setattr(build, "build_all", record)
    for k in (build.BLOCK_SCAN, build.PROBE_DENSITY):
        with pytest.raises(RuntimeError, match="no build here"):
            k.launch()
    assert built == [KERNELS, PROBE_KERNELS]
    for k in (*KERNELS, *PROBE_KERNELS):
        src = k.source.read_text()
        assert f'extern "C" int {k.symbol}(' in src
        assert "Replaces the Pallas kernel" in src
        assert "Bound on the H100" in src
    for k in PROBE_KERNELS:
        assert "scripts/probe_" in k.source.read_text()
    # P2 density counts hits with atomics on an int32 grid, not one-hot
    # products on the tensor cores; both TPU bodies launch it
    density = build.PROBE_DENSITY.source.read_text()
    assert "mma.sync" not in density and "__match_any_sync" in density
    assert set(build.PROBE_DENSITY.leg_launches) == {"reshape", "fori"}
    assert "arch=compute_90a,code=sm_90a" in NVCC_FLAGS
    assert "--fmad=false" in NVCC_FLAGS and "--use_fast_math" not in NVCC_FLAGS


def test_kernel_ab_builds_each_old_source_against_its_own_headers(monkeypatch, tmp_path):
    """The A/B tool compiles every old kernel, the probes' too, with ``-I``
    naming the old tree's headers, never this checkout's csrc, into a
    library of its own beside the current build (an old source against the
    new masks.cuh would time a hybrid)."""
    from geomesa_tpu_torch.kernels import build
    from geomesa_tpu_torch.scripts import kernel_ab

    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    names = set()
    for k in kernel_ab.AB_KERNELS:
        cmd = kernel_ab.old_build_command(k, tmp_path)
        assert cmd[0] == "nvcc" and all(f in cmd for f in build.NVCC_FLAGS)
        includes = [cmd[i + 1] for i, a in enumerate(cmd) if a == "-I"]
        assert includes == [str(tmp_path)]
        assert not any(str(build.CSRC_DIR) in a for a in cmd)
        assert cmd[-1] == str(tmp_path / f"{k.name}.cu")
        out = cmd[cmd.index("-o") + 1]
        assert out == str(kernel_ab.old_library(k)) and out != str(k.library)
        names.add(k.name)
    assert names == {"block_scan", "block_scan_multi", "block_pops", "density", "bounds",
                     "probe_scan", "probe_bounds", "probe_density"}
    assert not (build.PKG_DIR / "scripts" / "density_ab.py").exists()


def test_kernel_ab_knows_the_one_hot_density_by_its_chunk_argument(tmp_path):
    """The A/B tool binds an old P2 density that takes a chunk (the one-hot
    design) with that entry's arguments, and this checkout's as it is."""
    from geomesa_tpu_torch.kernels import build
    from geomesa_tpu_torch.scripts import kernel_ab

    assert not kernel_ab.one_hot_density(build.CSRC_DIR)
    (tmp_path / "probe_density.cu").write_text(
        'extern "C" int gm_probe_density(const float* x, const float* y, const int* params,\n'
        "    int m, int sub, int chunk, int height, int width, float* grid, void* stream);\n")
    assert kernel_ab.one_hot_density(tmp_path)
    assert len(kernel_ab.ONE_HOT_DENSITY_ARGTYPES) == len(build.PROBE_DENSITY.argtypes)
    assert set(kernel_ab.ONE_HOT_CHUNKS) == set(build.PROBE_DENSITY.leg_launches)


def test_scan_columns_must_start_on_16_bytes():
    """The scans' 16-byte column loads need every column on a 16-byte
    boundary: a view at a 4-byte offset is refused, a tensor of its own
    passes."""
    whole = torch.zeros(2 * 32 * 128 + 1, dtype=torch.float32)
    view = whole[1:].reshape(2, 32, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tbk.check_aligned({"x": view})
    tbk.check_aligned({"x": torch.zeros((2, 32, 128), dtype=torch.float32)})


def _code_lines(path) -> list:
    """The C++ lines of ``path`` without comments and blank lines."""
    out = []
    for line in open(path).read().splitlines():
        code = line.split("//", 1)[0].rstrip()
        if code.strip():
            out.append(code)
    return out


def test_native_helpers_are_the_port_s_own_copy():
    """The port's C++ is the JAX package's line for line (comments aside),
    built with -ffp-contract=off (point-in-polygon stays bit-exact with
    numpy) and OpenMP where g++ has it; the loader reads no environment
    variable and falls back on nothing."""
    from geomesa_tpu_torch import native

    src = os.path.join(ROOT, "geomesa_tpu_torch", "native", "geomesa_native.cpp")
    ref = os.path.join(ROOT, "geomesa_tpu", "native", "geomesa_native.cpp")
    assert _code_lines(src) == _code_lines(ref)
    assert "-ffp-contract=off" in native.GXX_FLAGS and "-O3" in native.GXX_FLAGS
    loader = inspect.getsource(native)
    assert "environ" not in loader and "getenv" not in loader
    assert native.LIB_PATH.parent == native.BUILD_DIR
    assert native.BUILD_DIR == __import__("pathlib").Path(ROOT, "geomesa_tpu_torch", "build")


def _knobs(conf_module) -> dict:
    return {
        v.name: v for v in vars(conf_module).values()
        if type(v).__name__ == "SystemProperty"
    }


def test_every_port_knob_is_a_jax_knob_with_its_default():
    from geomesa_tpu import conf as jconf
    from geomesa_tpu_torch import conf as tconf

    port, ref = _knobs(tconf), _knobs(jconf)
    assert len(port) >= 19
    for name, knob in port.items():
        assert name in ref, f"the port adds a knob the JAX package lacks: {name}"
        assert knob.default == ref[name].default, name
        for raw in ("1", "0", "2.5", "true", "off", "auto"):
            try:
                want = ref[name].parser(raw)
            except (TypeError, ValueError):
                with pytest.raises((TypeError, ValueError)):
                    knob.parser(raw)
                continue
            assert knob.parser(raw) == want, (name, raw)
    # this slice's knobs are among them
    for name in ("geomesa.query.timeout", "geomesa.guard.temporal.max.duration",
                 "geomesa.obs.trace.sample", "geomesa.obs.trace.buffer",
                 "geomesa.obs.slow.ms", "geomesa.obs.slow.max",
                 "geomesa.tpu.lock.witness", "geomesa.tpu.lock.witness.artifact",
                 "geomesa.plan.estimate.enabled", "geomesa.plan.estimate.stale.p90",
                 "geomesa.plan.estimate.min.count", "geomesa.plan.estimate.auto.analyze",
                 "geomesa.cache.result.max.bytes", "geomesa.cache.ttl",
                 "geomesa.cache.ttl.jitter", "geomesa.cache.min.cost",
                 "geomesa.cache.tile.bits", "geomesa.cache.tile.max.entries",
                 "geomesa.cache.tile.max.per.query", "geomesa.tenant.queue.max",
                 "geomesa.tenant.default.weight", "geomesa.tenant.slo.p99.ms",
                 "geomesa.obs.slo.window.s", "geomesa.obs.slo.slices",
                 "geomesa.obs.slo.query.p99.ms", "geomesa.obs.slo.fold.p99.ms",
                 "geomesa.obs.slo.wal.p99.ms", "geomesa.obs.slo.standing.p99.ms",
                 "geomesa.obs.slo.replica.staleness.p99.ms", "geomesa.obs.slo.tiles.p99.ms",
                 "geomesa.obs.ops.host", "geomesa.obs.ops.sample.ms",
                 "geomesa.obs.ops.history", "geomesa.ingest.merge.min.bins",
                 "geomesa.stream.workers", "geomesa.stream.chunk.rows",
                 "geomesa.stream.queue.depth", "geomesa.stream.fold.rows",
                 "geomesa.stream.fold.yield.ms", "geomesa.stream.fold.prestage",
                 "geomesa.stream.wal.sync", "geomesa.stream.wal.sync.interval.ms",
                 "geomesa.stream.wal.segment.bytes", "geomesa.stream.wal.replay.batch.rows",
                 "geomesa.stream.incremental", "geomesa.standing.grid.level",
                 "geomesa.standing.classify.cells", "geomesa.standing.fused.min.points",
                 "geomesa.standing.raster.cells", "geomesa.standing.fused.gate",
                 "geomesa.standing.queue.max", "geomesa.standing.window.panes",
                 "geomesa.replica.ship.chunk.bytes", "geomesa.replica.ship.interval.ms",
                 "geomesa.replica.staleness.max.ms", "geomesa.replica.giveup.s"):
        assert name in port, name


_IMPORT_ONE = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "geomesa_tpu" or m.startswith("geomesa_tpu."))
print(bad)
"""


@pytest.mark.parametrize("module", ["fault", "lockwitness", "storage.metadata",
                                    "storage.adapter", "storage.persist"])
def test_persistence_modules_import_no_jax_and_nothing_of_geomesa_tpu(module):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ONE, f"geomesa_tpu_torch.{module}"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    src = open(os.path.join(ROOT, "geomesa_tpu_torch", *module.split(".")) + ".py").read()
    assert "import jax" not in src and "from geomesa_tpu." not in src
    assert "from geomesa_tpu import" not in src


@pytest.mark.parametrize("module", ["stats.store", "obs.accuracy", "security", "views", "cache",
                                    "cache.fingerprint", "cache.generations", "cache.result",
                                    "cache.tiles"])
def test_stats_security_and_cache_modules_import_no_jax(module):
    """The statistics, visibility, view and cache modules, each on its own
    in a fresh interpreter: neither jax nor anything of geomesa_tpu."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ONE, f"geomesa_tpu_torch.{module}"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    path = os.path.join(ROOT, "geomesa_tpu_torch", *module.split("."))
    src = open(path + ".py" if os.path.exists(path + ".py") else
               os.path.join(path, "__init__.py")).read()
    assert "import jax" not in src and "from geomesa_tpu." not in src
    assert "from geomesa_tpu import" not in src


@pytest.mark.parametrize("module", ["serving.scheduler", "serving.tenancy", "obs.slo",
                                    "obs.ops", "obs"])
def test_serving_tier_and_ops_modules_import_no_jax(module):
    """The serving tier, the SLO tracker and the ops plane, each on its own
    in a fresh interpreter: neither jax nor anything of geomesa_tpu (the
    ops plane's HTTP server is the standard library's)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ONE, f"geomesa_tpu_torch.{module}"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    path = os.path.join(ROOT, "geomesa_tpu_torch", *module.split("."))
    src = open(path + ".py" if os.path.exists(path + ".py") else
               os.path.join(path, "__init__.py")).read()
    assert "import jax" not in src and "from geomesa_tpu." not in src
    assert "from geomesa_tpu import" not in src


@pytest.mark.parametrize("ctor", ["Lock", "RLock", "Condition"])
def test_disarmed_witness_returns_the_lock_it_was_given(ctor, monkeypatch):
    import threading

    from geomesa_tpu_torch import lockwitness

    monkeypatch.setattr(lockwitness, "ENABLED", False)
    lock = getattr(threading, ctor)()
    assert lockwitness.witness(lock, "X._lock") is lock
    # the port's stores and registries then hold plain locks
    from geomesa_tpu_torch.metrics import MetricsRegistry

    assert type(MetricsRegistry()._lock) is type(threading.Lock())
    ds = DataStore(device="cpu")
    assert type(ds._write_lock) is type(threading.RLock())


@pytest.mark.parametrize("module", ["streaming", "streaming.wal", "streaming.cache",
                                    "streaming.flush", "streaming.store", "streaming.stream",
                                    "utils.spatial_index", "io.varint", "ingest.sort",
                                    "streaming.standing", "streaming.replica",
                                    "tuning.primitives", "process.knn"])
def test_streaming_modules_import_no_jax(module):
    """The streaming tier's modules, each on its own in a fresh
    interpreter: neither jax nor anything of geomesa_tpu."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ONE, f"geomesa_tpu_torch.{module}"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    path = os.path.join(ROOT, "geomesa_tpu_torch", *module.split("."))
    src = open(path + ".py" if os.path.exists(path + ".py") else
               os.path.join(path, "__init__.py")).read()
    assert "import jax" not in src and "from geomesa_tpu." not in src
    assert "from geomesa_tpu import" not in src


def test_recover_loads_onto_the_card_by_default(monkeypatch, tmp_path):
    """``LambdaStore.recover`` has no CPU fallback: without ``device=`` it
    loads the cold store onto the card, and raises where there is none."""
    from geomesa_tpu_torch import FeatureType
    from geomesa_tpu_torch.storage import persist
    from geomesa_tpu_torch.streaming import LambdaStore

    ds = DataStore(device="cpu")
    ds.create_schema(FeatureType.from_spec("t", "dtg:Date,*geom:Point:srid=4326"))
    persist.save(ds, str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LambdaStore.recover(str(tmp_path))
    lam = LambdaStore.recover(str(tmp_path), device="cpu")
    assert lam.cold.device == torch.device("cpu")
    lam.close()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_standing_matcher_takes_plain_on_cpu_and_raises_without_a_kernel(device):
    """The fused matcher's columns live on the engine's device: a CPU
    batch takes K2's plain version and launches nothing, a batch on a
    device without a kernel raises (no fallback to the plain version or
    the host ray cast)."""
    from geomesa_tpu_torch import FeatureType, geometry
    from geomesa_tpu_torch.kernels import KERNELS
    from geomesa_tpu_torch.streaming.standing import (
        StandingConfig, StandingQueryEngine, Subscription, _BatchColumns,
    )

    eng = StandingQueryEngine(FeatureType.from_spec("t", "*geom:Point:srid=4326"),
                              StandingConfig(fused_min_points=1, fused_gate=False),
                              device="cpu")
    a = np.linspace(0, 2 * np.pi, 41)[:-1]
    eng.register(Subscription("star", "geofence", geom=geometry.Polygon(
        [(np.cos(t) * (1 + (k % 2)), np.sin(t) * (1 + (k % 2))) for k, t in enumerate(a)])))
    x = np.linspace(-1.5, 1.5, 300)
    cols = _BatchColumns(x, x[::-1].copy(), device)
    assert {c.device.type for c in cols.cols3()} == {device}
    before = [k.launches for k in KERNELS]
    if device == "meta":
        with pytest.raises(ValueError, match="no fused scan kernel"):
            eng.matcher.match(cols, [0])
        return
    out, host = eng.matcher.match(cols, [0])
    assert host == [] and len(out[0][0]) > 0
    assert [k.launches for k in KERNELS] == before
