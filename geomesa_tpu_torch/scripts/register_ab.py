"""Bulk geofence registration, with and without the array passes.

Run from the root of a checkout (it imports that checkout's
``chip_smoke`` for the ``moving-standing-1M`` population: 1,000,000
tiny squares, 96 jagged stars and 16 rings from the path's own seed):

    python -m geomesa_tpu_torch.scripts.register_ab

``SubscriptionIndex.register_geofences`` covers a chunk's plain
quadrilaterals in whole-chunk array passes (``_cover_chunk``). The
``per_subscription`` side replaces that cover, on its own index, with
the per-subscription one: every geometry through
``_cover_geofence_ij`` and ``_is_axis_rect``, one at a time. Both run
in turns (array, per_subscription, per_subscription, array), each into
a fresh index, and the script fails unless the two registries are equal
element for element. Registration is host code: the times are those of
the card's host, and the script raises without a card so that they come
from that machine. Prints one JSON line.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time


def per_subscription_cover(index, sub_ids, geoms):
    """``_cover_chunk``'s result for one chunk, built one subscription at
    a time through the index's per-subscription cover."""
    import numpy as np

    from geomesa_tpu_torch.streaming.standing import Subscription, _is_axis_rect

    covers = [index._cover_geofence_ij(Subscription(i, "geofence", geom=g))
              for i, g in zip(sub_ids, geoms)]
    counts = np.fromiter((len(c[0]) for c in covers), np.int64, count=len(covers))
    ii = np.concatenate([c[0] for c in covers]).astype(np.uint64)
    jj = np.concatenate([c[1] for c in covers]).astype(np.uint64)
    fulls = np.concatenate([c[2] for c in covers])
    segs = [c[3] for c in covers]
    bboxes = [np.asarray(c[4], np.float64).reshape(1, 4) for c in covers]
    rects = [_is_axis_rect(c[3], c[4]) for c in covers]
    rasts = {k: c[5] for k, c in enumerate(covers) if c[5] is not None}
    return counts, ii, jj, fulls, segs, bboxes, rects, rasts


def register(mode: str, ids, geoms):
    """(seconds, index) of one bulk registration into a fresh index."""
    from geomesa_tpu_torch.metrics import MetricsRegistry
    from geomesa_tpu_torch.streaming.standing import StandingConfig, SubscriptionIndex

    index = SubscriptionIndex(StandingConfig.from_properties(), metrics=MetricsRegistry())
    if mode == "per_subscription":
        index._cover_chunk = lambda sub_ids, gs: per_subscription_cover(index, sub_ids, gs)
    t0 = time.perf_counter()
    index.register_geofences(ids, geoms)
    return time.perf_counter() - t0, index


def registry(index) -> tuple:
    kinds, eoff, segs, bbox, rect = index._ensure_arrays()
    return (index._ids, index._alive, kinds, eoff, segs, bbox, rect,
            sorted(index._rast), *index._csr)


def main() -> dict:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("register_ab needs a CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    ids, geoms = cs.geofence_population(cs.SEED + 140)[:2]
    gc.collect()
    gc.freeze()  # the population stays out of the collector's full passes
    out = {"subscriptions": len(ids), "array_s": [], "per_subscription_s": []}
    kept = {}
    for mode in ("array", "per_subscription", "per_subscription", "array"):
        seconds, index = register(mode, ids, geoms)
        out[f"{mode}_s"].append(seconds)
        if mode not in kept:
            kept[mode] = registry(index)
        del index
        gc.collect()
    a, p = kept["array"], kept["per_subscription"]
    equal = len(a) == len(p) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, p)
    )
    if not equal:
        raise AssertionError("register_ab: the two registries differ")
    out["equal"] = True
    out["speedup"] = min(out["per_subscription_s"]) / min(out["array_s"])
    return out


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
