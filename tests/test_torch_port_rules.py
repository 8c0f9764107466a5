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
  math.
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
                 "scripts.probe_agg"):
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
    assert "mma.sync" in build.PROBE_DENSITY.source.read_text()
    assert set(build.PROBE_DENSITY.leg_launches) == {"reshape", "fori"}
    assert "arch=compute_90a,code=sm_90a" in NVCC_FLAGS
    assert "--fmad=false" in NVCC_FLAGS and "--use_fast_math" not in NVCC_FLAGS
