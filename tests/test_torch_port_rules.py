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
  ``security``, ``views``, ``cache`` and its four modules);
- the bulk loader's and the I/O tier's modules (``ingest`` and its
  pipeline and splits, ``io`` and its readers, writers and converters,
  ``utils.bin_format``) import neither jax nor anything of
  ``geomesa_tpu``, each on its own in a fresh interpreter, and
  ``geomesa_tpu_torch.io`` imports without pyarrow;
- the analytics tier's modules (``utils.geohash``, ``process`` and its
  seven modules, ``tiles`` and its three, ``sql`` and its three) import
  neither jax nor anything of ``geomesa_tpu``, each on its own in a
  fresh interpreter; ``knn_many``, ``spatial_join_indexed`` and
  ``TilePyramid`` scan through K1 or K2's plain versions on a CPU store
  and launch nothing, and raise on a store whose columns lie on a device
  without a kernel;
- the data plane, the S2 curve and indexes, the tuning tier and the CLI
  (``serving.http``, ``curve.s2``, ``index.s2``, ``tuning`` and its four
  modules, ``cli``) import neither jax nor anything of ``geomesa_tpu``,
  each on its own in a fresh interpreter; ``serve(port=)`` mounts the
  data plane on a DataStore, a LambdaStore and a ReplicaStore; the CLI
  loads onto the card unless it is given ``--device cpu``, and raises
  where there is no card;
- the static analysis (``analysis`` and its thirteen modules) and its
  runner (``scripts.check``) import neither jax, nor torch, nor anything
  of ``geomesa_tpu``, each on its own in a fresh interpreter; the port's
  rule ids are the JAX package's less exactly its two jit rules, and
  ``python -m geomesa_tpu_torch.scripts.check`` exits 0 on the tree, 1
  on a staged bad fixture and 2 on an unknown rule id;
- the measurement drivers of ``geomesa_tpu_torch/scripts/`` (the ports
  of the reference's ``scripts/``: ``validate_1b``, ``run_pod_scale``,
  the link, floor and pull probes, ``probe_density_many``, the three XZ2
  probes, ``profile_join``) and their ``hostmem`` helpers import neither
  jax, nor anything of ``geomesa_tpu``, nor the reference's ``bench``,
  each on its own in a fresh interpreter; none holds an absolute path
  but /proc's; each driver has ``main(argv=None)`` and ``run``, a
  docstring naming its ``python -m`` command, and a ``device`` that
  defaults to ``cuda``.
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
                 "utils.spatial_index", "io.varint", "ingest", "ingest.sort",
                 "ingest.pipeline", "ingest.splits", "io.exporters", "io.arrow",
                 "utils.bin_format", "utils.geohash", "process", "process.knn",
                 "process.proximity", "process.tube", "process.route", "process.unique",
                 "process.join", "process.transforms", "tiles", "tiles.tiling",
                 "tiles.png", "tiles.pyramid", "sql", "sql.functions", "sql.join",
                 "sql.query"):
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
                 "geomesa.replica.staleness.max.ms", "geomesa.replica.giveup.s",
                 "geomesa.join.adaptive", "geomesa.join.sample",
                 "geomesa.join.broad.fraction", "geomesa.join.in.selectivity",
                 "geomesa.tiles.leaf.zoom", "geomesa.tiles.px",
                 "geomesa.tiles.cache.max.bytes", "geomesa.tiles.ttl",
                 "geomesa.tiles.max.age.s", "geomesa.serve.host", "geomesa.serve.page.rows",
                 "geomesa.serve.max.body.bytes", "geomesa.serve.retry.after.ms",
                 "geomesa.tuning.enabled", "geomesa.tuning.interval",
                 "geomesa.tuning.decisions", "geomesa.tuning.plan.max.adjust",
                 "geomesa.tuning.plan.deadband", "geomesa.tuning.plan.min.count",
                 "geomesa.tuning.burn.objective", "geomesa.tuning.burn.threshold",
                 "geomesa.tuning.burn.release", "geomesa.scan.fused.slots"):
        assert name in port, name


def test_registry_holds_every_knob_and_describe_lists_it():
    """``conf.REGISTRY`` maps every declared knob's name to it (the tuning
    manager looks knobs up there), and ``describe()`` prints one line per
    knob as the JAX package's does (the CLI's env command)."""
    from geomesa_tpu import conf as jconf
    from geomesa_tpu_torch import conf as tconf

    port = _knobs(tconf)
    assert tconf.REGISTRY == port
    assert set(port) <= set(jconf.REGISTRY)
    lines = tconf.describe().splitlines()
    assert len(lines) == len(port)
    ref = dict(ln.split(" = ", 1) for ln in jconf.describe().splitlines())
    for ln in lines:
        # the value and the environment key (the docs are the port's own)
        name, rest = ln.split(" = ", 1)
        assert rest.split("] ")[0] == ref[name].split("] ")[0], name


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


INGEST_IO_MODULES = ["ingest", "ingest.pipeline", "ingest.splits", "io", "io.converters",
                     "io.validators", "io.ingest", "io.exporters", "io.geojson", "io.twkb",
                     "io.avro", "io.shapefile", "io.osm", "io.arrow", "io.parquet", "io.orc",
                     "utils.bin_format"]


@pytest.fixture(scope="module")
def ingest_io_imports():
    """Each ingest and I/O module imported on its own in a fresh
    interpreter, the interpreters started together: module -> (return
    code, stdout, stderr)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    procs = {
        m: subprocess.Popen([sys.executable, "-c", _IMPORT_ONE, f"geomesa_tpu_torch.{m}"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
        for m in INGEST_IO_MODULES
    }
    out = {}
    for m, p in procs.items():
        stdout, stderr = p.communicate(timeout=180)
        out[m] = (p.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("module", INGEST_IO_MODULES)
def test_ingest_and_io_modules_import_no_jax(ingest_io_imports, module):
    """The bulk loader's, the readers' and the writers' modules, each on
    its own in a fresh interpreter: neither jax nor anything of
    geomesa_tpu."""
    rc, stdout, stderr = ingest_io_imports[module]
    assert rc == 0, stderr
    assert stdout.strip() == "[]", stdout
    path = os.path.join(ROOT, "geomesa_tpu_torch", *module.split("."))
    src = open(path + ".py" if os.path.exists(path + ".py") else
               os.path.join(path, "__init__.py")).read()
    assert "import jax" not in src and "from geomesa_tpu." not in src
    assert "from geomesa_tpu import" not in src


_IMPORT_IO_WITHOUT_PYARROW = """
import sys
sys.modules["pyarrow"] = None  # an import of pyarrow now raises ImportError
import geomesa_tpu_torch.io as io_pkg
from geomesa_tpu_torch.io import arrow, exporters, orc, parquet
from geomesa_tpu_torch import FeatureCollection, FeatureType
sft = FeatureType.from_spec("t", "name:String,*geom:Point:srid=4326")
fc = FeatureCollection.from_columns(sft, ["a"], {"name": ["x"], "geom": ([1.0], [2.0])})
print(exporters.export(fc, "csv").splitlines()[1])
try:
    exporters.export(fc, "parquet")
except ImportError:
    print("parquet needs pyarrow")
"""


def test_io_imports_without_pyarrow():
    """``import geomesa_tpu_torch.io`` (and its Arrow, Parquet and ORC
    modules) needs no pyarrow: those modules import it in the functions
    that write or read."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _IMPORT_IO_WITHOUT_PYARROW], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["a,x,POINT (1 2)", "parquet needs pyarrow"]


ANALYTICS_MODULES = ["utils.geohash", "process", "process.knn", "process.proximity",
                     "process.tube", "process.route", "process.unique", "process.join",
                     "process.transforms", "tiles", "tiles.tiling", "tiles.png",
                     "tiles.pyramid", "sql", "sql.functions", "sql.join", "sql.query"]


@pytest.fixture(scope="module")
def analytics_imports():
    """Each analytics module imported on its own in a fresh interpreter,
    the interpreters started together: module -> (rc, stdout, stderr)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    procs = {
        m: subprocess.Popen([sys.executable, "-c", _IMPORT_ONE, f"geomesa_tpu_torch.{m}"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
        for m in ANALYTICS_MODULES
    }
    out = {}
    for m, p in procs.items():
        stdout, stderr = p.communicate(timeout=180)
        out[m] = (p.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("module", ANALYTICS_MODULES)
def test_analytics_modules_import_no_jax(analytics_imports, module):
    """kNN, the processes, the tile pyramid and the SQL tier, each on its
    own in a fresh interpreter: neither jax nor anything of geomesa_tpu."""
    rc, stdout, stderr = analytics_imports[module]
    assert rc == 0, stderr
    assert stdout.strip() == "[]", stdout
    path = os.path.join(ROOT, "geomesa_tpu_torch", *module.split("."))
    src = open(path + ".py" if os.path.exists(path + ".py") else
               os.path.join(path, "__init__.py")).read()
    assert "import jax" not in src and "from geomesa_tpu." not in src
    assert "from geomesa_tpu import" not in src


def _analytics_store():
    from geomesa_tpu_torch import FeatureCollection, FeatureType
    from geomesa_tpu_torch.cache import CacheConfig

    sft = FeatureType.from_spec("p", "*geom:Point:srid=4326")
    sft.user_data["geomesa.indices.enabled"] = "z2"
    ds = DataStore(device="cpu", tile=1024, cache=CacheConfig(max_bytes=1 << 20))
    ds.create_schema(sft)
    rng = np.random.default_rng(3)
    n = 6000
    ds.write("p", FeatureCollection.from_columns(
        sft, np.arange(n), {"geom": (rng.uniform(-20, 20, n), rng.uniform(-20, 20, n))}),
        check_ids=False)
    ds.compact("p")
    return ds


def _analytics_call(ds, what):
    from geomesa_tpu_torch import FeatureCollection, FeatureType, geometry
    from geomesa_tpu_torch.process import knn_many, knn_search
    from geomesa_tpu_torch.sql import spatial_join_indexed
    from geomesa_tpu_torch.tiles import TilePyramid, TilesConfig

    if what == "knn_many":
        return [len(fc) for fc in knn_many(ds, "p", [(0.0, 0.0), (5.0, 5.0)], k=4)]
    if what == "knn_search":
        return len(knn_search(ds, "p", 1.0, 1.0, k=4))
    if what == "join":
        a = np.linspace(0, 2 * np.pi, 41)[:-1]
        star = geometry.Polygon([(2 * np.cos(t) * (1 + k % 2), 2 * np.sin(t) * (1 + k % 2))
                                 for k, t in enumerate(a)])
        left = FeatureCollection.from_columns(
            FeatureType.from_spec("adm", "*geom:Polygon:srid=4326"), ["s"],
            {"geom": geometry.PackedGeometryColumn.from_geometries([star])})
        return len(spatial_join_indexed(ds, "p", left, "contains")[0])
    return TilePyramid(ds, TilesConfig(leaf_zoom=1, px=8)).fetch("p", 1, 1, 0).count


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("what", ["knn_many", "knn_search", "join", "pyramid"])
def test_analytics_take_plain_on_cpu_and_raise_without_a_kernel(device, what):
    """kNN, the indexed join and the pyramid's leaf scans reach K1 or K2
    through the store's tables: on a CPU store the plain versions run and
    nothing launches; with the table's columns on a device without a
    kernel they raise (no fallback to the plain version)."""
    from geomesa_tpu_torch.kernels import KERNELS

    ds = _analytics_store()
    if device == "meta":
        for table in ds._tables.values():
            table.cols3 = {k: v.to("meta") for k, v in table.cols3.items()}
            table.device = torch.device("meta")
        with pytest.raises(ValueError, match="kernel"):
            _analytics_call(ds, what)
        return
    before = [k.launches for k in KERNELS]
    assert _analytics_call(ds, what)
    assert [k.launches for k in KERNELS] == before


SLICE_MODULES = ["serving.http", "serving", "curve.s2", "index.s2", "curve", "index", "tuning",
                 "tuning.controllers", "tuning.reweight", "tuning.burnshed", "tuning.manager",
                 "cli"]


@pytest.fixture(scope="module")
def slice_imports():
    """Each of the slice's modules imported on its own in a fresh
    interpreter, the interpreters started together: module -> (rc,
    stdout, stderr)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    procs = {
        m: subprocess.Popen([sys.executable, "-c", _IMPORT_ONE, f"geomesa_tpu_torch.{m}"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
        for m in SLICE_MODULES
    }
    out = {}
    for m, p in procs.items():
        stdout, stderr = p.communicate(timeout=180)
        out[m] = (p.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_data_plane_s2_tuning_and_cli_modules_import_no_jax(slice_imports, module):
    rc, stdout, stderr = slice_imports[module]
    assert rc == 0, stderr
    assert stdout.strip() == "[]", stdout
    path = os.path.join(ROOT, "geomesa_tpu_torch", *module.split("."))
    src = open(path + ".py" if os.path.exists(path + ".py") else
               os.path.join(path, "__init__.py")).read()
    assert "import jax" not in src and "from geomesa_tpu." not in src
    assert "from geomesa_tpu import" not in src


@pytest.mark.parametrize("kind", ["datastore", "lambda", "replica"])
def test_serve_port_mounts_the_data_plane_on_every_store(kind, tmp_path):
    """``serve(port=)`` on a DataStore, a LambdaStore and a ReplicaStore
    returns a started DataServer (it raised ``NotImplementedError`` before
    the data plane was ported); close() ends its thread."""
    from geomesa_tpu_torch import FeatureCollection, FeatureType
    from geomesa_tpu_torch.serving import DataClient, DataServer
    from geomesa_tpu_torch.storage import persist
    from geomesa_tpu_torch.streaming import LambdaStore, PipeTransport, ReplicaStore, StreamConfig

    sft = FeatureType.from_spec("t", "name:String,dtg:Date,*geom:Point:srid=4326")
    ds = DataStore(device="cpu")
    ds.create_schema(sft)
    ds.write("t", FeatureCollection.from_columns(
        sft, ["a", "b"], {"name": np.array(["x", "y"]), "dtg": np.zeros(2, np.int64),
                          "geom": (np.array([1.0, 2.0]), np.array([1.0, 2.0]))}))
    store = ds
    if kind != "datastore":
        root = str(tmp_path / "s")
        persist.save(ds, root)
        store = LambdaStore(ds, "t", config=StreamConfig(chunk_rows=64, fold_rows=4096),
                            wal_dir=f"{root}/_wal")
        if kind == "replica":
            store.close()
            store = ReplicaStore(root, str(tmp_path / "f" / "_wal"), PipeTransport.pair()[1],
                                 type_name="t", device="cpu")
    srv = store.serve(port=0)
    try:
        assert isinstance(srv, DataServer) and store.serve(port=0) is srv
        assert srv.host == "127.0.0.1" and srv._thread.name == "geomesa-serve"
        assert len(DataClient(srv.url).query("t")["features"]) == 2
    finally:
        store.close()
        ds.close()
    assert srv.closed and not srv._thread


def test_cli_loads_onto_the_card_unless_told_otherwise(tmp_path, monkeypatch, capsys):
    from geomesa_tpu_torch import FeatureType, cli
    from geomesa_tpu_torch.storage import persist

    ds = DataStore(device="cpu")
    ds.create_schema(FeatureType.from_spec("t", "*geom:Point:srid=4326"))
    root = str(tmp_path / "cat")
    persist.save(ds, root)
    parser = cli.build_parser()
    for argv in (["count", "-c", root, "-f", "t"], ["serve", "-c", root], ["env"],
                 ["create-schema", "-c", root, "-f", "u", "-s", "*geom:Point:srid=4326"]):
        assert parser.parse_args(argv).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["count", "-c", root, "-f", "t"], ["tune", "-c", root],
                 ["create-schema", "-c", str(tmp_path / "new"), "-f", "u", "-s",
                  "*geom:Point:srid=4326"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    assert cli.main(["count", "-c", root, "-f", "t", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == "0"
    src = inspect.getsource(cli)
    assert "environ" not in src and "getenv" not in src


MESH_POD_MODULES = ["parallel", "parallel.mesh", "parallel.dtable", "pod", "pod.hostgroup",
                    "pod.table", "pod.store", "scripts.probe_multiprocess"]


@pytest.fixture(scope="module")
def mesh_pod_imports():
    """Each module of the multi-device tier imported on its own in a fresh
    interpreter, the interpreters started together: module -> (rc,
    stdout, stderr)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    procs = {
        m: subprocess.Popen([sys.executable, "-c", _IMPORT_ONE, f"geomesa_tpu_torch.{m}"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
        for m in MESH_POD_MODULES
    }
    out = {}
    for m, p in procs.items():
        stdout, stderr = p.communicate(timeout=180)
        out[m] = (p.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("module", MESH_POD_MODULES)
def test_mesh_and_pod_modules_import_no_jax(mesh_pod_imports, module):
    rc, stdout, stderr = mesh_pod_imports[module]
    assert rc == 0, stderr
    assert stdout.strip() == "[]", stdout
    path = os.path.join(ROOT, "geomesa_tpu_torch", *module.split("."))
    src = open(path + ".py" if os.path.exists(path + ".py") else
               os.path.join(path, "__init__.py")).read()
    assert "import jax" not in src and "from geomesa_tpu." not in src
    assert "from geomesa_tpu import" not in src


def test_mesh_shards_take_plain_on_cpu_and_launch_nothing():
    """A CPU mesh store's shards take the kernels' plain versions: a
    query, a fused batch, a count estimate, a grid and bounds launch no
    kernel."""
    from geomesa_tpu_torch import FeatureCollection, FeatureType
    from geomesa_tpu_torch.kernels import KERNELS
    from geomesa_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(3)
    n = 20_000
    sft = FeatureType.from_spec("t", "dtg:Date,*geom:Point:srid=4326")
    ds = DataStore(device="cpu", mesh=make_mesh(devices=["cpu"] * 4))
    ds.create_schema(sft)
    ds.write("t", FeatureCollection.from_columns(sft, np.arange(n), {
        "dtg": rng.integers(0, 10 * 86_400_000, n) + 1_704_067_200_000,
        "geom": (rng.uniform(-50, 50, n), rng.uniform(-50, 50, n))}))
    before = [k.launches for k in KERNELS]
    q = "bbox(geom, -20, -20, 20, 20) AND dtg DURING 2024-01-02T00:00:00Z/2024-01-06T00:00:00Z"
    assert len(ds.query("t", q)) and all(len(r) for r in ds.query_many("t", [q] * 10))
    assert ds.stats_query("t", "Count()", q, estimate=True)[0].count > 0
    assert ds.density("t", q, envelope=(-50, -50, 50, 50), width=8, height=8).sum() > 0
    assert ds.bounds("t", q, estimate=True) is not None
    assert [k.launches for k in KERNELS] == before


ANALYSIS_MODULES = ["analysis", "analysis.core", "analysis.registries", "analysis.lockmodel",
                    "analysis.rules", "analysis.rules.concurrency", "analysis.rules.controllers",
                    "analysis.rules.faults", "analysis.rules.fused", "analysis.rules.kernels",
                    "analysis.rules.knobs", "analysis.rules.locks", "analysis.rules.metrics",
                    "analysis.rules.scripts", "scripts.check"]

_IMPORT_STDLIB_ONLY = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "torch", "numpy", "geomesa_tpu"))
print(bad)
"""


@pytest.fixture(scope="module")
def analysis_imports():
    """Each analysis module and the check script imported on its own in a
    fresh interpreter, the interpreters started together: module -> (rc,
    stdout, stderr)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    procs = {
        m: subprocess.Popen([sys.executable, "-c", _IMPORT_STDLIB_ONLY, f"geomesa_tpu_torch.{m}"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
        for m in ANALYSIS_MODULES
    }
    out = {}
    for m, p in procs.items():
        stdout, stderr = p.communicate(timeout=180)
        out[m] = (p.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("module", ANALYSIS_MODULES)
def test_analysis_modules_import_the_standard_library_only(analysis_imports, module):
    """The analysis and its runner need neither torch nor numpy (they read
    the tree as text and AST), and nothing of jax or geomesa_tpu."""
    rc, stdout, stderr = analysis_imports[module]
    assert rc == 0, stderr
    assert stdout.strip() == "[]", stdout
    path = os.path.join(ROOT, "geomesa_tpu_torch", *module.split("."))
    src = open(path + ".py" if os.path.exists(path + ".py") else
               os.path.join(path, "__init__.py")).read()
    assert "import jax" not in src and "import torch" not in src and "import numpy" not in src
    assert "from geomesa_tpu." not in src and "from geomesa_tpu import" not in src


def test_rule_ids_are_the_jax_package_s_less_its_two_jit_rules():
    from geomesa_tpu import analysis as jax_analysis
    from geomesa_tpu_torch import analysis

    ref = [r.id for r in jax_analysis.ALL_RULES]
    ids = [r.id for r in analysis.ALL_RULES]
    assert set(ref) - set(ids) == {"kernel-traced-coercion", "kernel-dynamic-shape"}
    assert set(ids) <= set(ref) and len(ids) == len(ref) - 2


def _check(*args, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, "-m", "geomesa_tpu_torch.scripts.check", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_check_exits_zero_on_the_tree_one_on_a_bad_fixture_two_on_an_unknown_rule(tmp_path):
    import json

    proc = _check("--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["clean"] is True and payload["findings"] == [] and payload["schema_version"] == 1
    # a staged bad fixture: the knob fixture under a mini tree's package
    pkg = tmp_path / "geomesa_tpu_torch"
    pkg.mkdir()
    with open(os.path.join(ROOT, "tests", "fixtures", "analysis", "knob_bad.py")) as fh:
        (pkg / "knob_bad.py").write_text(fh.read())
    proc = _check("--root", str(tmp_path), "--json", "--rules", "knob-undeclared")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert {f["rule"] for f in json.loads(proc.stdout)["findings"]} == {"knob-undeclared"}
    assert _check("--rules", "no-such-rule").returncode == 2
    assert _check("--rules", "kernel-dynamic-shape").returncode == 2  # no counterpart
    assert _check("--root", str(tmp_path / "missing")).returncode == 2
    assert _check("--baseline", str(tmp_path / "missing.txt")).returncode == 2


# the measurement drivers of geomesa_tpu_torch/scripts/ (the ports of the
# reference's scripts/) and their host-memory helper module
SCRIPT_DRIVERS = ["validate_1b", "run_pod_scale", "probe_link", "probe_floor",
                  "probe_async_pull", "probe_density_many", "probe_xz2_50m",
                  "probe_xz2_pipeline", "probe_xz2_stage", "profile_join"]
SCRIPT_MODULES = [*SCRIPT_DRIVERS, "hostmem"]

_IMPORT_SCRIPT = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "geomesa_tpu", "bench"))
print(bad)
"""


@pytest.fixture(scope="module")
def script_imports():
    """Each driver module imported on its own in a fresh interpreter, the
    interpreters started together: module -> (rc, stdout, stderr)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    procs = {
        m: subprocess.Popen([sys.executable, "-c", _IMPORT_SCRIPT,
                             f"geomesa_tpu_torch.scripts.{m}"], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for m in SCRIPT_MODULES
    }
    out = {}
    for m, p in procs.items():
        stdout, stderr = p.communicate(timeout=180)
        out[m] = (p.returncode, stdout, stderr)
    return out


def _script_tree(module):
    import ast

    path = os.path.join(ROOT, "geomesa_tpu_torch", "scripts", f"{module}.py")
    with open(path) as fh:
        return ast.parse(fh.read())


@pytest.mark.parametrize("module", SCRIPT_MODULES)
def test_script_drivers_import_neither_jax_nor_the_reference_nor_bench(script_imports, module):
    rc, stdout, stderr = script_imports[module]
    assert rc == 0, stderr
    assert stdout.strip() == "[]", stdout
    import ast

    for node in ast.walk(_script_tree(module)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "geomesa_tpu", "bench"), name


@pytest.mark.parametrize("module", SCRIPT_MODULES)
def test_script_drivers_hold_no_absolute_path(module):
    """No path of a machine (the reference's drivers insert their
    checkout's absolute path into ``sys.path``): the drivers run as
    ``python -m``; the only absolute path a string may hold is the
    kernel's /proc."""
    import ast
    import re

    tree = _script_tree(module)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for path in re.findall(r"(?<![\w.])/[A-Za-z_][\w.-]*/\S*", node.value):
                assert path.startswith("/proc/"), path
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            assert ast.unparse(node.func) != "sys.path.insert", ast.unparse(node)


@pytest.mark.parametrize("module", SCRIPT_DRIVERS)
def test_script_drivers_have_main_and_run(module):
    mod = importlib.import_module(f"geomesa_tpu_torch.scripts.{module}")
    assert callable(mod.run) and callable(mod.main)
    assert inspect.signature(mod.main).parameters["argv"].default is None
    assert mod.__doc__ and "python -m geomesa_tpu_torch.scripts." + module in mod.__doc__
    run_params = inspect.signature(mod.run).parameters
    if "device" in run_params:
        assert run_params["device"].default == "cuda"
