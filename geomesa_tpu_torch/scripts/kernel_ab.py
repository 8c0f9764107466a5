"""The scan-path kernels beside an earlier tree's on the card: K1
(block_scan), K2 (block_scan_multi) and K3 (density), K1p (block_pops)
and K4 (bounds), which share their predicate header (masks.cuh), and the
chip-side probes' P1 (probe_scan), P2 bounds (probe_bounds) and P2
density (probe_density), each built from this checkout and from another
tree's sources (``--old DIR``: that tree's ``geomesa_tpu_torch/csrc``,
for example the parent commit's from ``git archive``). Every old source
builds against its own tree's headers (``-I DIR``), never this
checkout's. An old P2 density with a chunk argument (the one-hot design,
before the live-slot staging) runs through an adapter that passes the
variant's chunk, with fewer timed runs: it takes some 10 ms a launch.

Shapes, on the kernel phase's columns of ``chip_smoke.py`` (6,104 blocks
of 128 x 128 rows: the 100M-row main table; SUB = 128):

- K1 at M = 4096: box + window on (tbin, toff, x, y), the same on the
  packed tw, the box alone, the window alone, the validity leg on x; the
  extent leg with the window and with the box alone (the XZ2 path's);
  PIP at E 16, 64, 256, the raster at R 16, 64, 256 and both legs at
  R 16 + E 64, each with the window; then box + window at M = 32 and 256,
  the main path's small buckets;
- K2 at M = 2048 with 48 queries of 1-8 box and window slots, slots
  interleaved by query: box + window, the extent chunk (box alone), and
  48 polygon queries' PIP, raster and both stacks (E bucket 64, R bucket
  16); box + window again at M = 32;
- K1p and K4 at M = 4096, box + window and the extent leg (box alone);
- K3 at M = 4096 on a 256 x 256 grid: uniform, clustered (half of the
  rows in 64 gaussian clusters of sigma 0.5 degrees), the extent columns
  with the window and with the box alone;
- the probes on P1's table (64 Mi rows of x, y, tbin, toff;
  ``probe_pallas.make_columns``): P1 at M = 128 and 1024, P2 bounds and
  both density variants at M = 256 and 1024 (P2's box and envelope on
  the same x and y), each on the probe's params and on the 8-slot split
  (``probe_pallas.split_params``, ``probe_agg.split_boxes``).

Each shape holds both builds against the plain version bit for bit before
timing them; times are CUDA-event medians of the launch alone
(``timing.event_ms``), taken new, old, old, new, beside the shape's bound
(``chip_smoke.bound``), and each build's time a launch over launches
queued back to back (``timing.queued_ms``: 20 a run, 4 for the one-hot
density), where the host's submission hides behind the launches ahead.
Also reported: the registers, local memory and static count of global
and shared loads and stores of every kernel function of both builds
(``cuobjdump``), whether the two builds compiled to the same code, the
card's name and power limit, and whether the toolkit has Nsight Compute. Run on a CUDA card from the
root of a checkout (it imports ``chip_smoke`` for the columns);
``--only system`` or ``--only probes`` takes one group:

    python -m geomesa_tpu_torch.scripts.kernel_ab --old DIR [--only GROUP] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from geomesa_tpu_torch.kernels import build
from geomesa_tpu_torch.scan import aggregations as agg
from geomesa_tpu_torch.scan import block_kernels as bk
from geomesa_tpu_torch.timing import event_ms, queued_ms

# the kernels an A/B builds twice, by group
GROUPS = {
    "system": (build.BLOCK_SCAN, build.BLOCK_SCAN_MULTI, build.BLOCK_POPS, build.DENSITY,
               build.BOUNDS),
    "probes": build.PROBE_KERNELS,
}
AB_KERNELS = (*GROUPS["system"], *GROUPS["probes"])
# the one-hot P2 density's C entry (x, y, params, m, sub, chunk, height,
# width, grid, stream), and its chunk by variant
_P, _I = build._P, build._I
ONE_HOT_DENSITY_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
ONE_HOT_CHUNKS = {"reshape": 32, "fori": 1}
ONE_HOT_RUNS = 5
SUB = 128
M = 4096
M2 = 2048  # the fused chunk's slots at 100M rows
N_Q = 48
WIDTH = HEIGHT = 256
GRID = np.array([-100, -60, 120, 70], np.float32)
POINT = ("tbin", "toff", "x", "y")
EXT = ("gxmax", "gxmin", "gymax", "gymin")
SENTINEL = 0x5A5A5A5A  # fills the outputs before a checked launch


def old_library(kernel) -> Path:
    return build.BUILD_DIR / f"lib{kernel.name}_old.so"


def old_build_command(kernel, old_dir: Path) -> list:
    """nvcc for ``kernel``'s source in ``old_dir``, against that directory's
    headers only, into a library beside the current build."""
    old_dir = Path(old_dir)
    return [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(old_dir),
            "-o", str(old_library(kernel)), str(old_dir / f"{kernel.name}.cu")]


def one_hot_density(old_dir: Path) -> bool:
    """Whether ``old_dir``'s P2 density is the one-hot design, whose C entry
    takes a chunk and no scratch grid."""
    text = (Path(old_dir) / f"{build.PROBE_DENSITY.name}.cu").read_text()
    return "int chunk" in text


def build_old(old_dir: Path, kernels) -> dict:
    """Build ``kernels`` from ``old_dir`` at once; their C entry points by
    kernel name (an old one-hot P2 density bound with its own arguments)."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = [(k, subprocess.Popen(old_build_command(k, old_dir), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)) for k in kernels]
    failed = []
    for k, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            failed.append(f"{k.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed on the old sources:\n" + "\n".join(failed))
    fns = {}
    for k in kernels:
        argtypes = k.argtypes
        if k is build.PROBE_DENSITY and one_hot_density(old_dir):
            argtypes = ONE_HOT_DENSITY_ARGTYPES
        fns[k.name] = build.bind(old_library(k), k.symbol, argtypes)
    return fns


def tool(name: str) -> "str | None":
    found = shutil.which(name)
    if found:
        return found
    default = Path("/usr/local/cuda/bin") / name
    return str(default) if default.exists() else None


_SASS_OPS = ("LDG", "LDS", "LD", "STG", "STS", "ST", "SHFL")
_SETP = ("FSETP", "ISETP")


def _opcode(text: str) -> str:
    """The base opcode of a SASS instruction, past its predicate."""
    return re.sub(r"^@!?U?P[T0-9]+\s+", "", text).split()[0].split(".")[0]


def inner_loops(code: list) -> list:
    """The innermost loops of one function's SASS [(address, text)]: the
    spans of backward branches holding no other, each with its
    instructions and its shared loads, global loads and compares."""
    spans = []
    for addr, text in code:
        target = re.search(r"BRA\s.*0x([0-9a-f]+)", text)
        if target and int(target.group(1), 16) < addr:
            spans.append((int(target.group(1), 16), addr))
    out = []
    for lo, hi in spans:
        if any(o != (lo, hi) and lo <= o[0] and o[1] <= hi for o in spans):
            continue
        ops = [_opcode(t) for a, t in code if lo <= a <= hi]
        out.append({"instructions": len(ops), "LDS": ops.count("LDS"),
                    "LDG": ops.count("LDG"), "setp": sum(ops.count(k) for k in _SETP)})
    return out


def code_stats(library: Path) -> "dict | None":
    """Per kernel function of a built library: registers, local and shared
    bytes (``cuobjdump -res-usage``), the static count of instructions and
    of each load, store and shuffle opcode, and its innermost loops
    (``cuobjdump -sass``)."""
    exe = tool("cuobjdump")
    if exe is None:
        return None
    stats: dict = {}
    res = subprocess.run([exe, "-res-usage", str(library)], capture_output=True, text=True)
    fn = None
    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            fn = m.group(1)
            continue
        if fn and "REG:" in line:
            usage = re.findall(r"(REG|LOCAL|SHARED):(\d+)", line)
            stats[fn] = {k.lower(): int(v) for k, v in usage}
            fn = None
    sass = subprocess.run([exe, "-sass", str(library)], capture_output=True, text=True)
    code: dict = {}
    fn = None
    for line in sass.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            code[fn] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if fn and m:
            code[fn].append((int(m.group(1), 16), m.group(2).strip()))
    for fn, ins in code.items():
        ops = [_opcode(t) for _, t in ins]
        stats.setdefault(fn, {}).update(
            instructions=len(ops), **{k: ops.count(k) for k in _SASS_OPS},
            inner_loops=inner_loops(ins))
    return stats


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unavailable"


class Pair:
    """One kernel's two builds behind its wrapper: ``use(variant)`` points
    the kernel's C entry point at the new or the old library, so both run
    through the same staging and launch. ``old_runs`` timed runs of the
    old build (None: the timer's default)."""

    def __init__(self, kernel, old_fn, old_runs=None):
        self.kernel = kernel
        self.fns = {"new": build.bind(kernel.library, kernel.symbol, kernel.argtypes),
                    "old": old_fn}
        self.old_runs = old_runs

    def use(self, variant: str) -> None:
        self.kernel._fn = self.fns[variant]


class OneHotDensityPair(Pair):
    """The P2 density pair against the one-hot design: the old entry gets
    the chunk of the variant being timed (``chunk``) in place of the
    scratch grid, and adds into a grid the check zeroes first."""

    def __init__(self, kernel, old_fn):
        super().__init__(kernel, old_fn, old_runs=ONE_HOT_RUNS)
        self.one_hot = old_fn
        self.chunk = ONE_HOT_CHUNKS["reshape"]

        def adapter(x, y, params, m, sub, height, width, counts, grid, stream):
            return self.one_hot(x, y, params, m, sub, self.chunk, height, width, grid, stream)

        self.fns["old"] = adapter


def ab(pair: Pair, launch, out: torch.Tensor, ref, equal, rec: dict) -> dict:
    """Both builds on one shape: each equal to the plain version ``ref``
    (``equal(out, ref)``), then timed new, old, old, new."""
    zeroed = pair.kernel in (build.DENSITY, build.PROBE_DENSITY)
    for v in ("new", "old"):
        pair.use(v)
        out.fill_(0 if zeroed else SENTINEL)
        launch()
        torch.cuda.synchronize()
        if not equal(out, ref):
            raise RuntimeError(f"{pair.kernel.name} {v} {rec['shape']}: differs from plain")
    times: dict = {"new": [], "old": []}
    slow = {"new": {}, "old": {"runs": pair.old_runs, "warmup": 1} if pair.old_runs else {}}
    for v in ("new", "old", "old", "new"):
        pair.use(v)
        times[v].append(event_ms(launch, **slow[v]))
    queued = {}
    for v in ("new", "old"):
        pair.use(v)
        queued[v] = queued_ms(launch, launches=4 if slow[v] else 20)
    pair.use("new")
    rec.update(kernel=pair.kernel.name, new_ms=times["new"], old_ms=times["old"],
               new_over_old=min(times["new"]) / min(times["old"]),
               new_queued_ms=queued["new"], old_queued_ms=queued["old"])
    rec["share_of_bound"] = rec["bound_ms"] / min(times["new"])
    return rec


def planes_equal(planes, ref) -> bool:
    pw, pi = ref
    return torch.equal(planes[0], pw) and (pi is None or torch.equal(planes[1], pi))


def dev(a, dtype, device):
    return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)


def k1_shapes(cs, pair: Pair, cols, ext, n_blocks, device) -> list:
    boxes, wins, wins_tw = cs.scan_params()
    rng = np.random.default_rng(cs.SEED + 50)
    bids, _ = bk.pad_bids(np.arange(M), n_blocks)
    recs = []

    def one(shape, sel, b, hb, hw, w=wins, extent=False, edges=None, rast=None, ops=None):
        planes, launch = bk.scan_launcher(sel, b, boxes, w, has_boxes=hb, has_windows=hw,
                                          extent=extent, edges=edges, rast=rast)
        ref = bk.block_scan_plain(
            sel, dev(b, torch.int32, device), dev(boxes, torch.float32, device),
            dev(w, torch.int32, device), has_boxes=hb, has_windows=hw, extent=extent,
            edges=None if edges is None else dev(edges, torch.float32, device),
            rast=None if rast is None else dev(rast, torch.float32, device))
        rows = len(b) * SUB * 128
        n_bytes = rows * 4 * len(sel) + len(planes) * rows // 8 + b.nbytes
        if ops is None:
            ops = rows * (cs.leg_ops(boxes, w, hb, hw, planes=len(planes)) + 2 * len(planes))
        recs.append(ab(pair, launch, planes, ref, planes_equal,
                       {"shape": shape, "m": len(b), **cs.bound(n_bytes, ops)}))
        del planes, ref

    for shape, names, hb, hw, w in (
        ("box+window", POINT, True, True, wins), ("box+window:tw", ("tw", "x", "y"), True, True,
                                                  wins_tw),
        ("box", ("x", "y"), True, False, wins), ("window", ("tbin", "toff"), False, True, wins),
        ("valid", ("x",), False, False, wins),
    ):
        one(shape, {k: cols[k] for k in names}, bids, hb, hw, w)
    one("extent box+window", {k: ext[k] for k in EXT + ("tbin", "toff")}, bids, True, True,
        extent=True)
    one("extent box", {k: ext[k] for k in EXT}, bids, True, False, extent=True)
    sel = {k: cols[k] for k in POINT}
    b_t = torch.as_tensor(bids.astype(np.int64), device=device)
    gx, gy = cols["x"][b_t], cols["y"][b_t]
    n_win = int(bk.slot_words(wins, wins)[2][1])
    for shape, edges, rast in cs.k1_polygon_cases(np.random.default_rng(cs.SEED + 9)):
        rows = M * SUB * 128
        ops = rows * (n_win * 16 + 2 + 4) + cs.polygon_ops(torch, gx, gy, edges, rast)
        one(shape, sel, bids, True, True, edges=edges, rast=rast, ops=ops)
    del gx, gy
    for m in (32, 256):
        b = np.sort(rng.choice(n_blocks, size=m, replace=False)).astype(np.int32)
        one(f"box+window M={m}", sel, b, True, True)
    return recs


def k2_shapes(cs, pair: Pair, cols, ext, n_blocks, device) -> list:
    recs = []
    rng = np.random.default_rng(cs.SEED + 51)

    def one(shape, sel, bids, qids, boxes, wins, hb, hw, extent=False, edges=None, rasts=None,
            spip=None, ops=None):
        planes, launch = bk.multi_launcher(sel, bids, qids, boxes, wins, has_boxes=hb,
                                           has_windows=hw, extent=extent, edges=edges,
                                           rasts=rasts, spip=spip)
        ref = bk.block_scan_multi_plain(
            sel, dev(bids, torch.int32, device), dev(qids, torch.int32, device),
            dev(boxes, torch.float32, device), dev(wins, torch.int32, device), has_boxes=hb,
            has_windows=hw, extent=extent,
            edges=None if edges is None else dev(edges, torch.float32, device),
            rasts=None if rasts is None else dev(rasts, torch.float32, device),
            spip=None if spip is None else dev(spip, torch.int32, device))
        rows = len(bids) * SUB * 128
        n_bytes = rows * 4 * len(sel) + len(planes) * rows // 8 + bids.nbytes * 2
        if ops is None:
            per_q = np.array([cs.leg_ops(boxes[q], wins[q], hb, hw, planes=len(planes))
                              + 2 * len(planes) for q in range(len(boxes))])
            ops = SUB * 128 * int(per_q[qids].sum())
        recs.append(ab(pair, launch, planes, ref, planes_equal,
                       {"shape": shape, "m": len(bids), "queries": N_Q,
                        **cs.bound(n_bytes, ops)}))

    boxes, wins, _ = cs.query_stacks(N_Q, cs.SEED + 7)
    sel = {k: cols[k] for k in POINT}
    for m in (M2, 32):
        bids = np.sort(rng.choice(n_blocks, size=m, replace=False)).astype(np.int32)
        qids = rng.permutation(np.arange(m) % N_Q).astype(np.int32)
        one(f"box+window M={m}", sel, bids, qids, boxes, wins, True, True)
    qboxes, qwins, _ = cs.query_stacks(N_Q, cs.SEED + 41)
    bids = np.sort(rng.choice(n_blocks, size=M2, replace=False)).astype(np.int32)
    qids = rng.permutation(np.arange(M2) % N_Q).astype(np.int32)
    one("extent box", {k: ext[k] for k in EXT}, bids, qids, qboxes, qwins, True, False,
        extent=True)
    # the polygon stacks: 48 polygon queries, pads spip 0
    prng = np.random.default_rng(cs.SEED + 9)
    qboxes, wins_q, _ = cs.query_stacks(N_Q, cs.SEED + 10)
    edges, rasts = cs.k2_polygon_stacks(prng, N_Q)
    n_real = M2 - M2 // 40
    bids, _ = bk.pad_bids(rng.integers(0, n_blocks, n_real), n_blocks, bucket=M2)
    qids = np.zeros(M2, np.int32)
    qids[:n_real] = rng.permutation(np.arange(n_real) % N_Q)
    spip = np.zeros(M2, np.int32)
    spip[:n_real] = 1
    b_t = torch.as_tensor(bids.astype(np.int64), device=device)
    gx, gy = cols["x"][b_t], cols["y"][b_t]
    for shape, es, rs in (("pip:E64", edges, None), ("raster:R16", None, rasts),
                          ("pip+raster:R16+E64", edges, rasts)):
        ops = 0
        for q in range(N_Q):
            rows_q = torch.from_numpy(np.flatnonzero(qids[:n_real] == q)).to(device)
            nw = int(bk.slot_words(qboxes[q], wins_q[q])[2][1])
            ops += len(rows_q) * SUB * 128 * (nw * 16 + 2 + 4) + cs.polygon_ops(
                torch, gx[rows_q], gy[rows_q], None if es is None else es[q],
                None if rs is None else rs[q])
        one(shape, sel, bids, qids, qboxes, wins_q, True, True, edges=es, rasts=rs, spip=spip,
            ops=ops)
    return recs


def agg_shapes(cs, pairs: dict, cols, ext, n_blocks, device) -> list:
    """K1p and K4 (box + window and the extent box leg), K3's four shapes."""
    boxes, wins, _ = cs.scan_params()
    bids, _ = bk.pad_bids(np.arange(M), n_blocks)
    tb = dev(bids, torch.int32, device)
    pb, pw = dev(boxes, torch.float32, device), dev(wins, torch.int32, device)
    rows = M * SUB * 128
    recs = []
    point = {k: cols[k] for k in POINT}
    extent_box = {k: ext[k] for k in EXT}
    cases = [("box+window", point, True, False), ("extent box", extent_box, False, True)]
    for shape, sel, hw, extent in cases:
        flags = dict(has_boxes=True, has_windows=hw, extent=extent)
        wide_ops = rows * cs.leg_ops(boxes, wins, True, hw, planes=1)
        col_bytes = rows * 4 * len(sel)
        out, launch = agg.pops_launcher(sel, bids, boxes, wins, **flags)
        ref = agg.block_pops_plain(sel, tb, pb, pw, **flags)
        recs.append(ab(pairs["block_pops"], launch, out, ref, torch.equal,
                       {"shape": shape, "m": M, **cs.bound(col_bytes + M * 4 + bids.nbytes,
                                                           wide_ops + rows * 2 + rows // 16)}))
        out, launch = agg.bounds_launcher(sel, bids, boxes, wins, **flags)
        ref = agg.bounds_plain(sel, tb, pb, pw, **flags)
        recs.append(ab(pairs["bounds"], launch, out, ref,
                       lambda a, b: np.array_equal(a.cpu().numpy(), b.cpu().numpy()),
                       {"shape": shape, "m": M,
                        **cs.bound(col_bytes + M * 32 + bids.nbytes, wide_ops)}))
    density = [("uniform", point, True, False), ("extent box+window",
                                                 {k: ext[k] for k in EXT + ("tbin", "toff")},
                                                 True, True),
               ("extent box", extent_box, False, True)]
    for shape, sel, hw, extent in density:
        recs.append(_density(cs, pairs["density"], shape, sel, bids, boxes, wins, hw, extent,
                             device))
    cx, cy = cs.cluster_xy(torch, cols["x"], cols["y"])
    clustered = {**point, "x": cx, "y": cy}
    recs.append(_density(cs, pairs["density"], "clustered", clustered, bids, boxes, wins, True,
                         False, device))
    return recs


def _density(cs, pair, shape, sel, bids, boxes, wins, hw, extent, device) -> dict:
    flags = dict(has_boxes=True, has_windows=hw, extent=extent)
    grid, launch = agg.density_launcher(sel, bids, boxes, wins, GRID, width=WIDTH,
                                        height=HEIGHT, **flags)
    ref = agg.density_plain(sel, dev(bids, torch.int32, device),
                            dev(boxes, torch.float32, device), dev(wins, torch.int32, device),
                            dev(GRID, torch.float32, device), width=WIDTH, height=HEIGHT,
                            **flags)
    rows = len(bids) * SUB * 128
    n_bytes = rows * 4 * len(sel) + WIDTH * HEIGHT * 4 + bids.nbytes
    ops = rows * (cs.leg_ops(boxes, wins, True, hw, planes=1) + 8) + int(ref.sum()) * 15
    return ab(pair, launch, grid, ref, lambda a, b: torch.equal(a.to(torch.float32), b),
              {"shape": shape, "m": len(bids), "grid": f"{WIDTH}x{HEIGHT}",
               "hits": int(ref.sum()), **cs.bound(n_bytes, ops)})


def probe_shapes(cs, pairs: dict, device) -> list:
    """P1 at M = 128 and 1024, P2 bounds and both density variants at M =
    256 and 1024, each on the probe's params and on the 8-slot split."""
    from geomesa_tpu_torch.scan import probe_kernels as pk
    from geomesa_tpu_torch.scripts import probe_agg as pa
    from geomesa_tpu_torch.scripts import probe_pallas as pp

    host = pp.make_columns()
    n_blocks = host[0].shape[0]
    cols = tuple(torch.from_numpy(a).to(device) for a in host)
    del host
    recs = []
    p1 = {"probe": pp.pack_params(*(np.array([pp.BOX], np.float32),) * 2,
                                  *(np.array([pp.WINDOW], np.int32),) * 2),
          "split": pp.split_params()}
    for m in pp.MS:
        bids, _ = pp.sample_bids(n_blocks, m)
        for params, (boxes, wins) in p1.items():
            planes, launch = pk.probe_scan_launcher(cols, bids, boxes, wins)
            ref = pk.probe_scan_plain(*cols, dev(bids, torch.int32, device),
                                      dev(boxes, torch.float32, device),
                                      dev(wins, torch.int32, device))
            recs.append(ab(pairs["probe_scan"], launch, planes, ref, planes_equal,
                           {"shape": f"P1 {params} M={m}", "m": m,
                            **cs.bound(*pp.cost(bids, boxes, wins))}))
            del planes, ref
    rng = np.random.default_rng(pa.SEED)
    gb = pa.grid_bounds()
    p2 = {"probe": bk.pack_boxes(np.array([pa.BOX]), None), "split": pa.split_boxes()}
    for m in pa.MS:
        bids = pa.sample_bids(rng, n_blocks, m)
        for params, boxes in p2.items():
            pargs = (*cols[:2], dev(bids, torch.int32, device), dev(boxes, torch.float32, device))
            ref = pk.probe_bounds_plain(*pargs)
            out, launch = pk.probe_bounds_launcher(cols[:2], bids, boxes)
            recs.append(ab(pairs["probe_bounds"], launch, out, ref, torch.equal,
                           {"shape": f"P2 bounds {params} M={m}", "m": m,
                            **cs.bound(*pa.bounds_cost(bids, boxes, int(ref[:, 0].sum())))}))
            ref = pk.probe_density_plain(*pargs, dev(gb[0, :4], torch.float32, device),
                                         pa.H, pa.W)
            pair = pairs["probe_density"]
            for v in pk.DENSITY_VARIANTS:
                if isinstance(pair, OneHotDensityPair):
                    pair.chunk = ONE_HOT_CHUNKS[v]
                grid, launch = pk.probe_density_launcher(cols[:2], bids, boxes, gb, variant=v,
                                                         height=pa.H, width=pa.W)
                recs.append(ab(pair, launch, grid, ref, torch.equal,
                               {"shape": f"P2 density:{v} {params} M={m}", "m": m,
                                "hits": int(ref.sum()),
                                **cs.bound(*pa.density_cost(bids, boxes, int(ref.sum())))}))
    del cols
    torch.cuda.empty_cache()
    return recs


def run(old_dir: Path, only: "str | None" = None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab measures a CUDA card; there is none")
    import chip_smoke as cs  # the kernel phase's columns, from the checkout's root

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kernels = GROUPS[only] if only else AB_KERNELS
    build.build_all(kernels)
    old = build_old(Path(old_dir), kernels)
    pairs = {k.name: Pair(k, old[k.name]) for k in kernels}
    if build.PROBE_DENSITY in kernels and one_hot_density(old_dir):
        pairs["probe_density"] = OneHotDensityPair(build.PROBE_DENSITY, old["probe_density"])
    recs = []
    if only in (None, "system"):
        n_blocks = -(-cs.N_MAIN // (SUB * 128))
        cols = cs.synthetic_columns(torch, n_blocks, SUB, device)
        ext = cs.extent_columns(torch, n_blocks, SUB, device)
        recs += k1_shapes(cs, pairs["block_scan"], cols, ext, n_blocks, device)
        recs += k2_shapes(cs, pairs["block_scan_multi"], cols, ext, n_blocks, device)
        recs += agg_shapes(cs, pairs, cols, ext, n_blocks, device)
        del cols, ext
        torch.cuda.empty_cache()
    if only in (None, "probes"):
        recs += probe_shapes(cs, pairs, device)
    code = {"new": {k.name: code_stats(k.library) for k in kernels},
            "old": {k.name: code_stats(old_library(k)) for k in kernels}}
    same = {k.name: code["new"][k.name] == code["old"][k.name] for k in kernels}
    return {"phase": "kernel_ab", "nvidia_smi": nvidia_smi(),
            "device": torch.cuda.get_device_name(0), "old": str(old_dir), "ncu": tool("ncu"),
            "records": recs, "code": code, "same_code": same}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="an earlier tree's geomesa_tpu_torch/csrc to time beside this one")
    ap.add_argument("--only", choices=sorted(GROUPS), help="time one group of kernels")
    ap.add_argument("--out", type=Path, help="also write the JSON record here")
    args = ap.parse_args()
    text = json.dumps(run(args.old, args.only))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text, flush=True)


if __name__ == "__main__":
    main()
