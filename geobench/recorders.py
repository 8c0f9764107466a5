"""What a traced run records around the program, from outside it.

- ``SharedPhaseClock``: the program's ``timing.PhaseClock`` behind a lock,
  since the store's clock is entered from every client thread (planning)
  and from the scheduler's dispatcher (decode, refine); each host phase is
  also a profiler range (``phase.<name>``), so the device trace can say
  what the host was doing while the card sat idle.
- ``launch_recorder``: wraps the scan entry points that the table calls
  (``block_kernels.scan_planes`` / ``scan_planes_multi``) and notes each
  launch's bytes and operations (``roofline``), as
  ``chip_smoke.scan_m_recorder`` does.
- ``serving_marks``: the scheduler's counters and its ``queue_wait``
  histogram, read before and after the window.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

import numpy as np

from geobench import roofline

SERVING_COUNTERS = ("batches", "batched_queries")
QUEUE_WAIT = "geomesa.serving.queue_wait"


def shared_phase_clock():
    import torch
    from geomesa_tpu_torch.timing import PhaseClock

    class SharedPhaseClock(PhaseClock):
        def __init__(self):
            super().__init__()
            self._lock = threading.Lock()

        @contextmanager
        def host(self, name: str):
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(f"phase.{name}"):
                    yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.seconds[name] += dt

        def settle(self) -> dict:
            with self._lock:
                return super().settle()

    return SharedPhaseClock()


@contextmanager
def launch_recorder():
    """Yields the list of launches the table makes inside the block, each
    {"kernel", "bytes", "ops"} or {"kernel", "modelled": False}."""
    from geomesa_tpu_torch.scan import block_kernels as bk

    launches: list = []
    k1, k2 = bk.scan_planes, bk.scan_planes_multi

    def shape(cols3, kw):
        return len(kw["col_names"]), int(cols3[0].shape[1])

    def scan(cols3, bids, boxes, wins, **kw):
        planes = k1(cols3, bids, boxes, wins, **kw)
        if kw.get("edges") is not None or kw.get("rast") is not None:
            launches.append({"kernel": "block_scan", "modelled": False})
        else:
            n_cols, sub = shape(cols3, kw)
            b, o = roofline.scan_launch(bids, boxes, wins, n_cols=n_cols, sub=sub,
                                        has_boxes=kw["has_boxes"],
                                        has_windows=kw["has_windows"], planes=planes.shape[0])
            launches.append({"kernel": "block_scan", "bytes": b, "ops": o})
        return planes

    def multi(cols3, bids, qids, boxes, wins, **kw):
        planes = k2(cols3, bids, qids, boxes, wins, **kw)
        if kw.get("edges") is not None or kw.get("rasts") is not None:
            launches.append({"kernel": "block_scan_multi", "modelled": False})
        else:
            n_cols, sub = shape(cols3, kw)
            b, o = roofline.multi_launch(bids, qids, np.asarray(boxes), np.asarray(wins),
                                         n_cols=n_cols, sub=sub, has_boxes=kw["has_boxes"],
                                         has_windows=kw["has_windows"], planes=planes.shape[0])
            launches.append({"kernel": "block_scan_multi", "bytes": b, "ops": o})
        return planes

    bk.scan_planes, bk.scan_planes_multi = scan, multi
    try:
        yield launches
    finally:
        bk.scan_planes, bk.scan_planes_multi = k1, k2


def serving_marks(metrics) -> dict:
    """The scheduler's counters and a copy of the queue-wait histogram's
    buckets in the store's registry."""
    h = metrics.histograms.get(QUEUE_WAIT)
    return {
        "counters": {k: metrics.counter_value(f"geomesa.serving.{k}") for k in SERVING_COUNTERS},
        "queue_wait": list(h.counts) if h is not None else None,
    }


def serving_delta(before: dict, after: dict) -> dict:
    """Counters and the queue-wait histogram (the program's Histogram) of
    the window alone."""
    from geomesa_tpu_torch.metrics import Histogram

    counters = {k: after["counters"][k] - before["counters"][k] for k in SERVING_COUNTERS}
    hist = None
    if after["queue_wait"] is not None:
        b = before["queue_wait"] or [0] * len(after["queue_wait"])
        counts = [x - y for x, y in zip(after["queue_wait"], b)]
        hist = Histogram(counts=counts, count=sum(counts))
    return {"counters": counters, "queue_wait": hist}
