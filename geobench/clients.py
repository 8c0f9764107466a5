"""Closed-loop clients: each sends its next request once the last one
answered. A traffic file's ``client`` names the loop:

- ``submit``: a dashboard or API client through the store's serving tier,
  ``QueryScheduler.submit`` (with the request's projection as
  ``QueryHints.transforms``) then a wait on the future. Of every answer
  the digest of its feature ids is kept (``check.digest``), and the whole
  feature collection of the sampled requests (``sampler``), whose values
  the check reads.

A client stops sending at the window's end; what it sent before then is
answered and kept.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

RESULT_TIMEOUT_S = 120.0


@dataclass
class Record:
    req: object
    t0: float
    t1: float
    answer: object = None
    error: "str | None" = None
    features: object = None


def _submit_loop(ds, cfg, traffic, requests, stop, n, out, keep):
    from geomesa_tpu_torch.planning.hints import QueryHints

    from geobench.check import digest

    sched = ds.serve()
    for k, req in enumerate(requests):
        if n is not None and k >= n:
            return
        t0 = time.perf_counter()
        if stop is not None and t0 >= stop:
            return
        hints = None if req.transforms is None else QueryHints(transforms=list(req.transforms))
        try:
            fc = sched.submit(cfg["type_name"], req.ecql, hints=hints).result(RESULT_TIMEOUT_S)
            rec = Record(req, t0, time.perf_counter(), digest(fc.ids))
            if keep(req):
                rec.features = fc
            out.append(rec)
        except Exception as e:  # an answer that never came: counted, not raised
            out.append(Record(req, t0, time.perf_counter(), None, repr(e)))


LOOPS = {"submit": _submit_loop}


def sampler(traffic: dict, seed: int):
    """The requests whose whole answer is kept: every ``sample_every``-th
    of each client's stream, from an offset drawn from the seed (every
    request where the traffic gives no ``sample_every``)."""
    from geobench.gen import SAMPLE_TAG, rng_for

    every = int(traffic.get("sample_every", 1))
    offsets = {}

    def keep(req) -> bool:
        if req.client not in offsets:
            offsets[req.client] = int(rng_for(seed, SAMPLE_TAG, req.client).integers(0, every))
        return (req.seq + offsets[req.client]) % every == 0

    return keep


def run(ds, cfg, traffic, streams, keep, stop=None, n=None) -> list:
    """Run one closed loop per stream until ``stop`` (perf_counter
    seconds) or for ``n`` requests each; returns every record."""
    loop = LOOPS[traffic["client"]]
    outs = [[] for _ in streams]
    threads = [
        threading.Thread(target=loop, args=(ds, cfg, traffic, s, stop, n, o, keep),
                         name=f"geobench-client-{i}", daemon=True)
        for i, (s, o) in enumerate(zip(streams, outs))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(RESULT_TIMEOUT_S + (0 if stop is None else max(0.0, stop - time.perf_counter())))
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a client did not finish")
    return [r for o in outs for r in o]
