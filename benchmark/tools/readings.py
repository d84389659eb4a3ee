"""The readings a cell's limits are set from, many seeds in one process:
for each seed, the cell's set-up, a window of ``--seconds`` and the check
(``--control 0``), or the cell's control (``--control 1``: the reference in
the precision below the configuration's, or the program's own such path),
printing one JSON line of compared numbers a seed:

    python3 benchmark/tools/readings.py --workload cog.train --seeds 101-112 --seconds 2
    python3 benchmark/tools/readings.py --workload cog.train --seeds 201-203 --control 1
    python3 benchmark/tools/readings.py --workload cog.train --seeds 301-303 --fault half

Runs on the card, as run.py does; the benchmark's own runs never call it."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from core import guard, spec as specs  # noqa: E402


def seeds(text: str):
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="e.g. 101-112 or 5,9,2000000001")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None,
                   help="plant a fault of tools/faults.py under the program")
    args = p.parse_args(argv)
    spec = specs.load_spec()
    cell = specs.workload(spec, args.workload)
    guard.check_cards(cell["chips"])
    import torch

    from core.run import Run
    from tools.faults import planted

    for seed in seeds(args.seeds):
        t0 = time.time()
        run = Run(spec, cell, seed, torch.device("cuda", 0), False, bool(args.control),
                  log=lambda m: print(m, file=sys.stderr, flush=True))
        if args.fault:
            with planted(args.workload, args.fault):
                r = run.execute(args.seconds)
        else:
            r = run.execute(args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "fault": args.fault,
                          "correct": r["correct"], "failed": r["failed"],
                          "numbers": run.numbers,
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                          "seconds": time.time() - t0}), flush=True)
        del run, r
        gc.collect()
        torch.cuda.empty_cache()
    guard.check_no_jax()
    return 0


if __name__ == "__main__":
    sys.exit(main())
