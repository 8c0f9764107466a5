"""Probe device-to-host pulls of many small independent launches, on the card.

The port of the JAX package's scripts/probe_async_pull.py. It launches
40 small independent computations (``(x * 2 + 1).sum(-1)`` as int32
over a [128, 1024] f32 input each, the reference's jitted ``f``) and
times three ways to bring their outputs back:

- ``sync_ms``: launch and pull one by one (``.cpu()`` after each);
- ``dispatch_all_ms``: launch all 40, then pull each (``.cpu()``);
- ``async_ms``: launch all 40, start each output's copy into its own
  pinned buffer (``copy_(non_blocking=True)``, the counterpart of
  ``copy_to_host_async``), then one sync and read them all (the overlap
  the fused scan's pull relies on).

Every output is checked equal to numpy's on the same inputs (a mismatch
raises). Times are host wall clock of one pass each after two warm
calls, as the reference takes them; off the card nothing is timed
(``None``). Run on the card (seconds):

    python -m geomesa_tpu_torch.scripts.probe_async_pull [--device cuda]

It prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

N_LAUNCHES = 40
SHAPE = (128, 1024)


def f(x):
    return (x * 2 + 1).sum(dim=-1).to(torch.int32)


def run(device="cuda", n_launches: int = N_LAUNCHES) -> dict:
    """The three passes; returns the record."""
    from geomesa_tpu_torch.datastore import resolve_device

    device = resolve_device(device)
    cuda = device.type == "cuda"
    xs = [torch.ones(SHAPE, dtype=torch.float32, device=device) + i for i in range(n_launches)]
    want = [((np.ones(SHAPE, np.float32) + i) * 2 + 1).sum(axis=-1).astype(np.int32)
            for i in range(n_launches)]
    for x in xs[:2]:
        f(x).cpu()

    def timed(fn):
        s = time.perf_counter()
        outs = fn()
        return ((time.perf_counter() - s) * 1e3 if cuda else None), outs

    def sync_pulls():
        return [f(x).cpu() for x in xs]

    def dispatch_all():
        ys = [f(x) for x in xs]
        return [y.cpu() for y in ys]

    bufs = [torch.empty(SHAPE[0], dtype=torch.int32, pin_memory=cuda) for _ in xs]

    def async_pulls():
        ys = [f(x) for x in xs]
        for b, y in zip(bufs, ys):
            b.copy_(y, non_blocking=cuda)
        if cuda:
            torch.cuda.synchronize()
        return [b.clone() for b in bufs]

    rec: dict = {"driver": "probe_async_pull", "launches": n_launches,
                 "device": torch.cuda.get_device_name(device) if cuda else "cpu"}
    for key, fn in (("sync_ms", sync_pulls), ("dispatch_all_ms", dispatch_all),
                    ("async_ms", async_pulls)):
        ms, outs = timed(fn)
        assert all(np.array_equal(o.numpy(), w) for o, w in zip(outs, want)), key
        rec[key] = ms
    rec["reduced"] = []
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        rec = run(args.device)
    except AssertionError as e:
        print(f"probe_async_pull: FAIL {e}", file=sys.stderr)
        return 1
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
