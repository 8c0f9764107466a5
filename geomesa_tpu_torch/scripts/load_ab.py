"""``persist.load`` of one saved store, by one tree or another, on one card.

Run from the root of a checkout (it imports that checkout's
``chip_smoke`` for the ``gdelt-z3-10M-persist`` store: 10M GDELT-shaped
rows with ``EventRootCode`` from the path's own seed):

    python -m geomesa_tpu_torch.scripts.load_ab save ROOT
    python -m geomesa_tpu_torch.scripts.load_ab load ROOT SIDE

``save`` builds the store on the card and writes it to ``ROOT``. ``load``
builds the kernels and the native helpers, then times
``persist.load(ROOT, device="cuda")`` to the last table on the card
(one ``torch.cuda.synchronize``) and answers the path's 16 measured
queries, printing their ids' digest so that the sides can be held equal.
A comparison loads one saved directory with two unpacked trees in turns
(parent, change, change, parent), each from its own root. Raises without
a card. Prints one JSON line.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time


def main(argv) -> dict:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("load_ab needs a CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from geomesa_tpu_torch import native
    from geomesa_tpu_torch.kernels import KERNELS, build_all
    from geomesa_tpu_torch.storage import persist

    mode, root = argv[0], argv[1]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build_all(KERNELS)
    native.library()
    if mode == "save":
        ds, _, ingest_s = cs.build_store(torch, dev, cs.N_PERSIST, with_root_code=True,
                                         seed=cs.SEED + 70)
        t0 = time.perf_counter()
        persist.save(ds, root)
        return {"mode": "save", "ingest_s": ingest_s, "save_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    ds = persist.load(root, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    h = hashlib.blake2b(digest_size=16)
    for q, _ in cs.query_set(cs.SEED + 71, cs.N_PERSIST_QUERIES):
        h.update(np.asarray(ds.query("gdelt", q).ids, np.int64).tobytes())
    return {"mode": "load", "side": argv[2], "tree": os.getcwd(), "load_s": load_s,
            "rows": ds.row_count("gdelt"), "ids_digest": h.hexdigest(),
            "nvidia_smi": cs.nvidia_smi()}


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])), flush=True)
