"""The controls: each cell run with one guarantee of its configuration
broken on purpose, to show that its comparison comes out not correct.

    python3 -m perfbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

runs the cell once a seed in this process, on the card, with its driver's
``control()`` open, and prints each run's result line.  What a control
breaks is its driver's to say (see each driver's docstring); the
benchmark's own runs never open one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control_for(cell: str):
    """The cell's driver's ``control`` (a context manager factory)."""
    from . import spec

    return spec.driver(spec.workload(cell)["driver"]).control


def main(argv) -> int:
    from . import run

    ap = argparse.ArgumentParser(prog="python3 -m perfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    with control_for(args.workload)():
        for seed in args.seeds:
            t0 = time.perf_counter()
            res = run.run(["--workload", args.workload, "--seed", str(seed), "--seconds",
                           str(args.seconds), "--trace", "0"], t0)
            print(json.dumps({"seed": seed, "correct": res["correct"], "checks": res["checks"]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
