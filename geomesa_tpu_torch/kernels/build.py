"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library under ``geomesa_tpu_torch/build/`` with a plain C entry
point, loaded through ``ctypes`` at first use. A kernel's first launch
compiles the stale sources of its group in parallel, one ``nvcc`` per
source: the system's five (``KERNELS``) or the chip-side probes' three
(``PROBE_KERNELS``), so a probe source can neither slow nor fail a
system path. Nothing builds or loads at import
time: a machine without a CUDA toolkit imports this module and never
calls it (CPU tensors take the plain PyTorch versions).
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int


class CudaKernel:
    """One hand-written kernel: its source, its C entry point, a plain
    count of launches and one count per optional leg (``legs``; a launch
    names its leg, or None), bumped only where the wrapper launches it."""

    def __init__(self, name: str, symbol: str, argtypes: list, legs: tuple = ()):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.leg_launches = dict.fromkeys(legs, 0)
        self._fn = None

    def reset_counts(self) -> None:
        self.launches = 0
        self.leg_launches = dict.fromkeys(self.leg_launches, 0)

    @property
    def source(self) -> Path:
        return CSRC_DIR / f"{self.name}.cu"

    @property
    def library(self) -> Path:
        return BUILD_DIR / f"lib{self.name}.so"

    def stale(self) -> bool:
        if not self.library.exists():
            return True
        built = self.library.stat().st_mtime
        deps = [self.source, *CSRC_DIR.glob("*.cuh")]
        return any(d.stat().st_mtime > built for d in deps)

    def launch(self, *args, leg: "str | None" = None) -> None:
        """Call the C entry point (which launches on the stream passed
        last) and raise on its nonzero cudaGetLastError(); count the launch
        and, when ``leg`` names one, that leg's launch."""
        if self._fn is None:
            build_all(PROBE_KERNELS if self in PROBE_KERNELS else KERNELS)
            fn = getattr(ctypes.CDLL(str(self.library)), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: launch failed with CUDA error {rc}")
        self.launches += 1
        if leg is not None:
            self.leg_launches[leg] += 1


# the legs a launch counts besides its kernel (block_kernels.leg_name):
# the point-in-polygon and raster legs of the scans, and the extent leg
# (bbox-intersects over the extent columns, the bbox centre as the
# aggregations' point) of all five kernels
POLYGON_LEGS = ("pip", "raster", "pip+raster")
EXTENT_LEG = "extent"
# the column pointers every entry point takes first: x, y, gxmin, gymin,
# gxmax, gymax, t0, t1 (null where a launch does not read the column)
_COLS = [_P] * 8

BLOCK_SCAN = CudaKernel(
    "block_scan", "gm_block_scan", [*_COLS, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    legs=(*POLYGON_LEGS, EXTENT_LEG),
)
DENSITY = CudaKernel(
    "density", "gm_density", [*_COLS, _P, _I, _I, _I, _I, _I, _P, _P], legs=(EXTENT_LEG,)
)
BOUNDS = CudaKernel(
    "bounds", "gm_bounds", [*_COLS, _P, _I, _I, _I, _P, _P], legs=(EXTENT_LEG,)
)
BLOCK_SCAN_MULTI = CudaKernel(
    "block_scan_multi", "gm_block_scan_multi",
    [*_COLS, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    legs=(*POLYGON_LEGS, EXTENT_LEG),
)
BLOCK_POPS = CudaKernel(
    "block_pops", "gm_block_pops", [*_COLS, _P, _I, _I, _I, _P, _P], legs=(EXTENT_LEG,)
)
KERNELS = (BLOCK_SCAN, DENSITY, BOUNDS, BLOCK_SCAN_MULTI, BLOCK_POPS)

# the chip-side probes' kernels (scan/probe_kernels.py, driven by
# geomesa_tpu_torch/scripts/): no path of the system launches them, so they
# stay out of KERNELS and build as a group of their own. The density
# probe's launch names its chunk variant: "reshape" (32 sublanes a chunk)
# or "fori" (one sublane).
PROBE_SCAN = CudaKernel("probe_scan", "gm_probe_scan", [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P])
PROBE_BOUNDS = CudaKernel("probe_bounds", "gm_probe_bounds", [_P, _P, _P, _I, _I, _P, _P])
PROBE_DENSITY = CudaKernel(
    "probe_density", "gm_probe_density", [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    legs=("reshape", "fori"),
)
PROBE_KERNELS = (PROBE_SCAN, PROBE_BOUNDS, PROBE_DENSITY)

_build_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where a CUDA toolkit is installed")


def build_all(kernels: tuple = KERNELS, verbose: bool = False) -> float:
    """Compile every stale source of ``kernels`` (the system's by
    default), all ``nvcc`` processes started together. Returns the wall
    seconds spent (0.0 when nothing was stale). ``verbose`` adds
    ``-Xptxas -v`` and prints the compiler's report."""
    with _build_lock:
        todo = [k for k in kernels if k.stale()]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        extra = ("-Xptxas", "-v") if verbose else ()
        t0 = time.perf_counter()
        procs = [
            (k, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC_DIR),
                 "-o", str(k.library), str(k.source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
            for k in todo
        ]
        failed = []
        for k, p in procs:
            out, _ = p.communicate()
            if verbose and out:
                print(out)
            if p.returncode != 0:
                failed.append(f"{k.source.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return time.perf_counter() - t0
