"""K3 beside an earlier K3 on the card: the density kernel as built
(csrc/density.cu) and the ``gm_density`` of another density.cu (``--old``,
for example the parent commit's, from ``git archive``) built beside it.

Shapes, those of ``chip_smoke.py``'s kernel phase: 6,104 blocks of 128 x
128 rows (the 100M-row main table), M = 4096 candidate blocks, a 256 x 256
grid; the tbin, toff, x, y columns ("uniform"), the same with half of the
rows in 64 gaussian clusters of sigma 0.5 degrees ("clustered", hot
pixels), and the extent columns with the window ("extent") and, as on the
XZ2 path, with the box alone ("extent-box"). Each kernel is held against
the plain version (``density_plain``) bit for bit before it is timed;
times are CUDA-event medians (``timing.event_ms``) of the launch alone,
taken new, old, old, new. Also reports whether the toolkit has Nsight
Compute (``ncu``). Run on a CUDA card, from the root of a checkout:

    python -m geomesa_tpu_torch.scripts.density_ab --old PATH [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from geomesa_tpu_torch.kernels import DENSITY, build
from geomesa_tpu_torch.scan import aggregations as agg
from geomesa_tpu_torch.scan import block_kernels as bk
from geomesa_tpu_torch.timing import event_ms, max_abs_err

N_BLOCKS = 6104  # the 100M-row main table's blocks of 16,384 rows
SUB = 128
M = 4096
WIDTH = HEIGHT = 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
ENVELOPE = np.array([-100, -60, 120, 70], np.float32)
BOXES = np.array([[-60, -30, 40, 50], [100, -80, 170, -10]], np.float32)
WINDOWS = np.array([[2801, 2805, 0, 604_799], [2810, 2810, 1000, 90_000]])
POINT = ("tbin", "toff", "x", "y")
EXTENT = ("gxmax", "gxmin", "gymax", "gymin")


def load_source(source: Path):
    """Build a density source beside the current kernels and bind its
    ``gm_density`` (the current entry point's arguments)."""
    lib = build.BUILD_DIR / "libdensity_old.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o", str(lib),
         str(source)],
        check=True, capture_output=True, text=True,
    )
    fn = ctypes.CDLL(str(lib)).gm_density
    fn.argtypes = DENSITY.argtypes
    fn.restype = ctypes.c_int
    return fn


def run_shape(name, cols, names, extent, old, has_windows=True) -> dict:
    """Both kernels on one shape: equal to the plain version, then timed."""
    device = cols[names[0]].device
    bids, _ = bk.pad_bids(np.arange(M), N_BLOCKS)
    boxes = bk.pack_boxes(BOXES, None)
    wins = bk.pack_windows(WINDOWS, None)
    sel = {k: cols[k] for k in names}
    ref = agg.density_plain(
        sel, torch.from_numpy(bids).to(device), torch.from_numpy(boxes).to(device),
        torch.from_numpy(wins).to(device), torch.from_numpy(ENVELOPE).to(device),
        has_boxes=True, has_windows=has_windows, width=WIDTH, height=HEIGHT, extent=extent)
    ptrs, flags, sub, _ = bk.kernel_columns(sel, True, has_windows, need_xy=True, extent=extent)
    params = bk.upload_params(bk.stage_params(bids, boxes, wins, ENVELOPE), device)
    grid = torch.zeros((HEIGHT, WIDTH), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream().cuda_stream

    def new():
        DENSITY.launch(*ptrs, params.data_ptr(), M, sub, flags, WIDTH, HEIGHT,
                       grid.data_ptr(), stream)

    def old_launch():
        rc = old(*ptrs, params.data_ptr(), M, sub, flags, WIDTH, HEIGHT, grid.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"old gm_density: CUDA error {rc}")

    rows = M * SUB * bk.LANES
    rec = {"shape": name, "grid": f"{WIDTH}x{HEIGHT}", "rows": rows, "hits": int(ref.sum()),
           "max_pixel": int(ref.max())}
    launches = {"new": new, "old": old_launch}
    for v, launch in launches.items():
        grid.zero_()
        launch()
        torch.cuda.synchronize()
        err = max_abs_err(grid.to(torch.float32), ref)
        if err != 0.0:
            raise RuntimeError(f"density {v} {name}: max abs err {err}")
        rec[f"{v}_max_abs_err"] = err
    for v in ("new", "old", "old", "new"):
        rec.setdefault(f"{v}_ms", []).append(event_ms(launches[v]))
    n_bytes = rows * 4 * len(names) + WIDTH * HEIGHT * 4 + bids.nbytes
    rec["bound_ms"] = n_bytes / HBM_BYTES_PER_S * 1e3
    return rec


def ncu_path() -> "str | None":
    found = shutil.which("ncu")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/ncu")
    return str(default) if default.exists() else None


def run(old: Path) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("density_ab measures a CUDA card; there is none")
    import chip_smoke  # the kernel phase's columns, from the checkout's root

    device = torch.device("cuda", 0)
    build.build_all()
    old_fn = load_source(old)
    cols = chip_smoke.synthetic_columns(torch, N_BLOCKS, SUB, device)
    recs = [run_shape("uniform", cols, POINT, False, old_fn)]
    cols["x"], cols["y"] = chip_smoke.cluster_xy(torch, cols["x"], cols["y"])
    recs.append(run_shape("clustered", cols, POINT, False, old_fn))
    del cols
    ext = chip_smoke.extent_columns(torch, N_BLOCKS, SUB, device)
    recs.append(run_shape("extent", ext, EXTENT + ("tbin", "toff"), True, old_fn))
    recs.append(run_shape("extent-box", ext, EXTENT, True, old_fn, has_windows=False))
    return {"phase": "density_ab", "device": torch.cuda.get_device_name(0),
            "ncu": ncu_path(), "records": recs}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="an earlier density.cu to time beside this one")
    ap.add_argument("--out", type=Path, help="also write the JSON record here")
    args = ap.parse_args()
    text = json.dumps(run(args.old))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text, flush=True)


if __name__ == "__main__":
    main()
