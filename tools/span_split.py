#!/usr/bin/env python3
"""One traced run of a benchmark cell, with the program's span totals beside
its result: how much of each span its parts cover.

    python3 tools/span_split.py --workload ivc_t100.chain --seed <n> [--seconds 30]

Run from the root of a checkout with a CUDA card.  The run is the one
``python3 -m perfbench --workload <cell> --seed <n> --seconds <s> --trace 1``
makes, in this process; its result line is printed first.  A second JSON
line gives, per step (per proof in a compress cell): every span's ms as the
harness's timers summed it, the kernel wrappers' host ms and launches by
wrapper as the window left them (``HOST_S``, ``LAUNCHES``; absent where the
program has no ``HOST_S``), and the share of its parent that each group of
parts covers:

    synth  the ``synth.*`` sections but ``synth.encode`` over ``synthesize/*``
    fold   the ``fold.*`` parts over ``fold/*``
    ipa    the ``*/ipa.*`` parts over ``*/two IPAs``

(None where the cell has no such span).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

GROUPS = {
    "synth": (lambda k: k.startswith("synth.") and not k.startswith("synth.encode/"),
              lambda k: k.startswith("synthesize/")),
    "fold": (lambda k: k.startswith("fold."), lambda k: k.startswith("fold/")),
    "ipa": (lambda k: "/ipa." in k, lambda k: k.endswith("/two IPAs")),
}


def coverage(spans: dict) -> dict:
    out = {}
    for group, (part, parent) in GROUPS.items():
        whole = sum(v for k, v in spans.items() if parent(k))
        out[group] = sum(v for k, v in spans.items() if part(k)) / whole if whole else None
    return out


def main(argv) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(prog="tools/span_split.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())

    from perfbench import run as R

    made, window = [], {}

    class Context(R.Context):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    device_info = R._device_info

    def after_window(*a):
        from vdf_tpu_torch.curves import kernels as CK
        from vdf_tpu_torch.fields import kernels as FK

        window["launches"] = {**FK.LAUNCHES, **CK.LAUNCHES}
        if hasattr(FK, "HOST_S") and hasattr(CK, "HOST_S"):
            window["host_s"] = {**FK.HOST_S, **CK.HOST_S}
        return device_info(*a)

    R.Context, R._device_info = Context, after_window
    try:
        result = R.run(["--workload", args.workload, "--seed", str(args.seed),
                        "--seconds", str(args.seconds), "--trace", "1"], t0)
    except SystemExit as exc:
        return exc.code if isinstance(exc.code, int) else 1
    print(json.dumps(result), flush=True)
    n = result["attempted"]
    spans = {name: v for s in made[0].spans for name, v in s.totals.items()}
    split = {"workload": args.workload, "seed": args.seed, "per": n,
             "spans_ms": {k: 1e3 * v / n for k, v in sorted(spans.items())},
             "coverage": coverage(spans),
             "launches": {k: v / n for k, v in window["launches"].items()}}
    if "host_s" in window:
        split["host_ms"] = {k: 1e3 * v / n for k, v in window["host_s"].items()}
    print(json.dumps(split), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
