"""The roofline arithmetic copied from chip_smoke.py equals the original on
the same inputs."""

import os
import sys

import numpy as np
import pytest

from geobench import roofline

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def params(n_box, n_win, rng):
    from geomesa_tpu_torch.scan import block_kernels as bk

    boxes = rng.uniform(-90, 90, (n_box, 4)).astype(np.float32)
    wins = rng.integers(0, 1000, (n_win, 4)).astype(np.int32)
    inner = boxes[: n_box - 1] if n_box > 1 else None
    return (bk.pack_boxes(boxes if n_box else None, inner),
            bk.pack_windows(wins if n_win else None, None))


def test_bound_is_chip_smokes(smoke):
    for b, o in ((1e9, 1e9), (3.35e9, 67e12 * 2e-3), (0, 5e12), (7e11, 0)):
        assert roofline.bound(b, o) == smoke.bound(b, o)
    assert (roofline.HBM_BYTES_PER_S, roofline.OPS_PER_S) == (smoke.HBM_BYTES_PER_S,
                                                               smoke.OPS_PER_S)


def test_leg_ops_and_k1_are_chip_smokes(smoke):
    rng = np.random.default_rng(0)
    for n_box in range(0, 9):
        for n_win in range(0, 9, 2):
            boxes, wins = params(n_box, n_win, rng)
            for hb in (True, False):
                for hw in (True, False):
                    for planes in (1, 2):
                        assert roofline.leg_ops(boxes, wins, hb, hw, planes) == \
                            smoke.leg_ops(boxes, wins, hb, hw, planes)
            assert roofline.k1_scan_ops(boxes, wins, 4096) == smoke.k1_scan_ops(boxes, wins, 4096)
    bids = np.arange(1, 513, dtype=np.int32)
    assert roofline.k1_scan_bytes(bids, 4, 128) == smoke.k1_scan_bytes(bids, 4, 128)


def test_scan_launch_counts_real_blocks_only(smoke):
    rng = np.random.default_rng(1)
    boxes, wins = params(1, 3, rng)
    real = np.arange(7, 7 + 300, dtype=np.int32)
    padded = np.concatenate([real, np.zeros(212, np.int32)])
    b, o = roofline.scan_launch(padded, boxes, wins, n_cols=4, sub=128, has_boxes=True,
                                has_windows=True, planes=2)
    assert b == smoke.k1_scan_bytes(real, 4, 128)
    assert o == smoke.k1_scan_ops(boxes, wins, 300 * 128 * 128)
    # a fused chunk: query 1's slots carry its own legs; the pads trail
    stack_b = np.stack([boxes, params(4, 1, rng)[0]])
    stack_w = np.stack([wins, params(1, 1, rng)[1]])
    bids = np.array([3, 4, 5, 9, 0, 0], np.int32)
    qids = np.array([0, 0, 1, 1, 0, 0], np.int32)
    b2, o2 = roofline.multi_launch(bids, qids, stack_b, stack_w, n_cols=4, sub=128,
                                   has_boxes=True, has_windows=True, planes=2)
    per = [roofline.leg_ops(stack_b[q], stack_w[q], True, True, 2) + 4 for q in (0, 1)]
    assert o2 == (2 * per[0] + 2 * per[1]) * 128 * 128
    assert b2 == 4 * 128 * 128 * 16 + 2 * 4 * 128 * 128 // 8 + 8 * 4
