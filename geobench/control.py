"""The control of a cell's comparison: the plain reference put in the
program's place one precision below the configuration's (``check``), on
the rows and the requests a run of the cell makes, judged as a run is.
Its numbers must fail the limits that sound runs meet. The benchmark's
runs never call this.

    python3 geobench/control.py --workload <config>.<traffic> --seeds 11,12,13 --requests 100

``--requests``: requests per client, about what a run's window answers.
Prints one JSON line per seed: the control's numbers beside the limits.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from geobench import check, clients, gen  # noqa: E402
from geobench.run import load_spec  # noqa: E402


def control_numbers(spec: dict, seed: int, per_client: int, device: str) -> dict:
    cfg, traffic = spec["config"], spec["traffic"]
    cols = gen.make_columns(cfg, seed)
    keep = clients.sampler(traffic, seed)
    requests = []
    for c in range(int(traffic["clients"])):
        requests += list(itertools.islice(
            gen.stream(traffic, cfg, seed, c, cols["centres"]), per_client))
    answers = check.control_answers(cols, cfg, requests, keep, device)
    judged = check.judge(answers, check.rows_of(cols, device), cols, cfg)
    return {"seed": seed, "dtype": str(check.CONTROL_DTYPE),
            "correct": check.verdict(judged), **judged}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = load_spec(*args.workload.split(".", 1))
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload,
                          **control_numbers(spec, seed, args.requests, args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
