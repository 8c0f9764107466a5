"""Probe the device-to-host pull floor and the ways around it, on the card.

The port of the JAX package's scripts/probe_floor.py, whose five output
paths become their torch counterparts (``g(x) = x[:size] * 2`` over a
1M-float device array throughout):

1. ``pull``: ``g(x).cpu()`` at 128, 4K, 64K and 1M floats (the
   reference's ``jax.device_get`` of a jitted output: the baseline);
2. ``asarray``: ``np.asarray(g(x).cpu())`` at 4K floats, the same path
   (a sanity row);
3. ``async_copy``: ``g(x).to("cpu", non_blocking=True)`` (a fresh pinned
   destination) and a CUDA event's sync, the counterpart of
   ``copy_to_host_async`` and a block;
4. ``pinned_out``: one pinned output buffer, reused: ``copy_`` of
   ``g(x)`` into it with ``non_blocking=True`` and an event sync, the
   counterpart of ``out_shardings`` with ``memory_kind="pinned_host"``;
5. ``overlap``: two queries in flight: query A's output copied into a
   pinned buffer on stream 1, query B dispatched on stream 2 before A's
   pull is waited for, then both pulled (``ms`` for both, ``ms_each``);
6. ``dispatch_only``: ``g(x)`` and a ``torch.cuda.synchronize``, no
   pull.

Each output is checked equal to numpy's ``x[:size] * 2`` (a mismatch
raises). Times are host wall-clock medians of 10 calls after one warm
call; off the card nothing is timed and pinned buffers are plain
(``None`` times). Run on the card (about a second):

    python -m geomesa_tpu_torch.scripts.probe_floor [--device cuda]

It prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

N = 1 << 20
SIZES = (128, 1 << 12, 1 << 16, 1 << 20)
SMALL = 1 << 12


def _timeit(device):
    def timeit(fn, n=10):
        out = fn()  # warm
        if device.type != "cuda":
            return None, out
        ts = []
        for _ in range(n):
            s = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - s)
        return statistics.median(ts) * 1e3, out
    return timeit


def run(device="cuda") -> dict:
    """The six measurements; returns the record."""
    from geomesa_tpu_torch.datastore import resolve_device

    device = resolve_device(device)
    cuda = device.type == "cuda"
    timeit = _timeit(device)
    xh = np.arange(N, dtype=np.float32)
    x = torch.from_numpy(xh).to(device)

    def want(size):
        return xh[:size] * 2

    def g(size):
        return x[:size] * 2

    def check(out, size, what):
        assert np.array_equal(np.asarray(out), want(size)), what

    rec: dict = {"driver": "probe_floor",
                 "device": torch.cuda.get_device_name(device) if cuda else "cpu", "pull": []}
    for size in SIZES:
        ms, out = timeit(lambda: g(size).cpu())
        check(out, size, f"pull {size}")
        rec["pull"].append({"floats": size, "kb": size * 4 / 1024, "ms": ms})

    ms, out = timeit(lambda: np.asarray(g(SMALL).cpu()))
    check(out, SMALL, "asarray")
    rec["asarray"] = {"kb": SMALL * 4 / 1024, "ms": ms}

    def async_copy():
        host = g(SMALL).to("cpu", non_blocking=cuda)
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()
        return host

    ms, out = timeit(async_copy)
    check(out, SMALL, "async_copy")
    rec["async_copy"] = {"kb": SMALL * 4 / 1024, "ms": ms}

    buf = torch.empty(SMALL, dtype=torch.float32, pin_memory=cuda)

    def pinned_out():
        buf.copy_(g(SMALL), non_blocking=cuda)
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()
        return buf

    ms, out = timeit(pinned_out)
    check(out, SMALL, "pinned_out")
    rec["pinned_out"] = {"kb": SMALL * 4 / 1024, "ms": ms}

    if cuda:
        s1, s2 = torch.cuda.Stream(device), torch.cuda.Stream(device)
        buf_a = torch.empty(SMALL, dtype=torch.float32, pin_memory=True)
        buf_b = torch.empty(SMALL, dtype=torch.float32, pin_memory=True)

    def overlap():
        if not cuda:
            return g(SMALL).cpu(), g(SMALL).cpu()
        s1.wait_stream(torch.cuda.current_stream(device))
        s2.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(s1):
            a = g(SMALL)
            buf_a.copy_(a, non_blocking=True)
            ev_a = torch.cuda.Event()
            ev_a.record(s1)
        with torch.cuda.stream(s2):  # query B's dispatch, in flight beside A's pull
            b = g(SMALL)
            buf_b.copy_(b, non_blocking=True)
            ev_b = torch.cuda.Event()
            ev_b.record(s2)
        ev_a.synchronize()
        ra = buf_a.clone()
        ev_b.synchronize()
        return ra, buf_b.clone()

    ms, (ra, rb) = timeit(overlap)
    check(ra, SMALL, "overlap A")
    check(rb, SMALL, "overlap B")
    rec["overlap"] = {"queries": 2, "ms": ms, "ms_each": None if ms is None else ms / 2}

    ms, _ = timeit(lambda: (g(SMALL), torch.cuda.synchronize() if cuda else None))
    rec["dispatch_only"] = {"ms": ms}
    rec["reduced"] = []
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        rec = run(args.device)
    except AssertionError as e:
        print(f"probe_floor: FAIL {e}", file=sys.stderr)
        return 1
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
