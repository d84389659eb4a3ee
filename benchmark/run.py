"""Run one cell of the port's benchmark once, on the card it starts on:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It loads the cell's configuration and traffic by the names in
``BENCHMARK.json``, builds the system under test (``med_tpu_torch``) from
them, makes its inputs and weights from the seed on the device, warms up
every shape the traffic uses, measures for ``--seconds`` seconds, checks
what the timed path produced against the plain reference, and prints one
JSON line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
end-to-end ones, or with ``--trace 1`` the per-layer ones read from a
profiler trace of the window), ``device``, ``breakdown`` (traced) and
``checks``, each compared number beside its limit.

It exits non-zero, printing no result, without CUDA or the cards the cell
asks for, or when the process holds JAX, flax or the JAX package.
``--control 1`` replaces the program by the cell's control (the reference
in the precision below the configuration's, or the program's own such
path) to read the numbers a lower precision gives; the benchmark's own
runs never pass it."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_T0 = time.time()


def _process_start() -> float:
    """The wall time this process started (from /proc where it can be read:
    the interpreter's own start-up counts as set-up)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T0


_START = min(_process_start(), _T0)

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]   # the harness, then the checkout's program
os.environ.setdefault("USE_FLAX", "0")   # transformers, where present, loads no flax

from core import guard, spec as specs  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    spec = specs.load_spec()
    cell = specs.workload(spec, args.workload)
    guard.check_cards(cell["chips"])
    import torch

    from core.run import Run

    run = Run(spec, cell, args.seed, torch.device("cuda", 0), bool(args.trace),
              bool(args.control), start=_START, log=lambda m: print(m, file=sys.stderr,
                                                                   flush=True))
    result = run.execute(args.seconds)
    guard.check_no_jax()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
