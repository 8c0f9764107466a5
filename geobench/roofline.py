"""The least time the card could take for a kernel launch.

A launch's bound is the larger of its bytes over the memory rate and its
operations over the peak rate, at the published peaks of one NVIDIA H100
SXM (NVIDIA's data sheet: 3.35 TB/s of HBM3; 67 TFLOP/s of float32
outside the tensor cores, the rate the kernels' int32 compares and bit
operations are counted at). ``bound``, ``leg_ops``, ``k1_scan_bytes`` and
``k1_scan_ops`` are copies of ``chip_smoke.py``'s; the slot count they
read is worked out here from the packed parameter blocks' pad pattern.

Bytes count each column byte a launch's real blocks need once, each
output byte once and the block ids; pad slots (the repeats that fill an
M bucket) are left out, so the share of the bound is the share of the
work these inputs need. Launches with polygon legs are not modelled:
their ray cast runs only for rows the raster leaves partial, which the
launch's arguments do not say.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
LANES = 128

# pad slots of the packed param blocks (lanes 0-7), which no row can match
PAD_BOX = np.array([np.inf, 0, -np.inf, 0, np.inf, 0, -np.inf, 0], np.float32)
PAD_WIN = np.array([1, 0, 0, 0, 1, 0, 0, 0], np.int32)


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes moved
    over the memory rate and the operations over the peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


def active_slots(slots: np.ndarray, pad: np.ndarray) -> int:
    """Slots before the trailing run of pad slots (the kernels loop over
    these only)."""
    real = ~np.all(np.asarray(slots)[:8, :8] == pad, axis=-1)
    return int(len(real) - np.argmax(real[::-1])) if real.any() else 0


def slot_counts(boxes, wins) -> tuple[int, int]:
    return (active_slots(np.asarray(boxes, np.float32), PAD_BOX),
            active_slots(np.asarray(wins, np.int32), PAD_WIN))


def leg_ops(boxes, wins, has_boxes, has_windows, planes) -> int:
    """Operations per row of the predicate legs over the query's active
    slots: per slot and plane 4 compares, 3 ANDs and an OR."""
    n_box, n_win = slot_counts(boxes, wins)
    return (n_box * has_boxes + n_win * has_windows) * 8 * planes + planes


def k1_scan_ops(boxes, wins, rows: int) -> int:
    """Operations of K1's box + window scan over ``rows``: per row both
    planes' legs, then a shift and an OR per plane to pack."""
    return rows * (leg_ops(boxes, wins, True, True, planes=2) + 4)


def k1_scan_bytes(bids, n_cols: int, sub: int) -> int:
    """Bytes of K1 over the slots ``bids``: each column read once, both
    planes written, the block ids."""
    rows = len(bids) * sub * LANES
    return rows * 4 * n_cols + 2 * rows // 8 + np.asarray(bids).nbytes


def real_blocks(bids) -> int:
    """Blocks before the trailing run of pad repeats of block 0."""
    nz = np.flatnonzero(np.asarray(bids))
    return int(nz[-1]) + 1 if len(nz) else 1


def scan_launch(bids, boxes, wins, *, n_cols, sub, has_boxes, has_windows, planes) -> tuple:
    """(bytes, ops) of one K1 launch over its real blocks."""
    m = real_blocks(bids)
    rows = m * sub * LANES
    ops = rows * (leg_ops(boxes, wins, has_boxes, has_windows, planes) + 2 * planes)
    return rows * 4 * n_cols + planes * rows // 8 + 4 * m, ops


def multi_launch(bids, qids, boxes, wins, *, n_cols, sub, has_boxes, has_windows,
                 planes) -> tuple:
    """(bytes, ops) of one K2 launch: slot i scans block bids[i] for query
    qids[i]; pads (block 0, query 0) trail the real slots."""
    bids, qids = np.asarray(bids), np.asarray(qids)
    busy = np.flatnonzero((bids != 0) | (qids != 0))
    n = int(busy[-1]) + 1 if len(busy) else 1
    per_row = np.array([
        leg_ops(boxes[q], wins[q], has_boxes, has_windows, planes) + 2 * planes
        for q in range(len(boxes))
    ])
    rows_per_slot = sub * LANES
    ops = int(per_row[qids[:n]].sum()) * rows_per_slot
    rows = n * rows_per_slot
    return rows * 4 * n_cols + planes * rows // 8 + 8 * n, ops
