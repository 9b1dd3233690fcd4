#!/usr/bin/env python3
"""Where the device plane's time goes on the card: the bench IVC's folds and
its compression, split by part.

    python3 tools/device_plane_split.py [--steps 8] [--check-steps 3] [--reps 3]

Run from the root of a checkout: this tree, or an older one into which this
file is copied (it uses only the public API, ``ivc_compress``'s timer
argument and ``chip_smoke.py``'s fold timers), so two trees compare in one
call.
At t = 32 with keys of 2^14 (the bench IVC): the statement (K1 on one lane
over t * steps rounds), ``ivc_public_params(32)``, ``RecursiveIVC`` and
steps - 1 prove steps, each between two synchronisations (folds/s: the
median of the steps after the first, with min and max; the ``PhaseTimer``
split a step); a chain of check_steps steps with each fold's parts between
synchronisations (``chip_smoke._fold_timers``: matvecs + cross term, witness
fold, ...); then ``reps`` times ``ivc_compress`` of the proof and
``ivc_verify_compressed`` (median s each), and one compress with a
synchronising ``PhaseTimer`` (the parts: closing fold, each side's outer
sumcheck, gamma-matvec, inner sumcheck and two IPAs).  Prints one JSON line
with the card's name and power limit; exits non-zero without a card or if a
proof does not verify.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _clock(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--check-steps", type=int, default=3)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("device_plane_split: no CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from vdf_tpu_torch import (
        Evaluation,
        RecursiveIVC,
        ivc_compress,
        ivc_public_params,
        ivc_verify,
        ivc_verify_compressed,
        pallas_vdf,
    )
    from vdf_tpu_torch.utils import TEST_SEED, XorShiftRng, field_random
    from vdf_tpu_torch.utils.profiling import PhaseTimer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    t, steps = 32, args.steps
    vdf = pallas_vdf()
    f = vdf.field
    x0 = field_random(XorShiftRng(TEST_SEED), f.params.modulus)
    start = [x0, 0, 1]
    z0_t, _ = Evaluation.eval(vdf, vdf.state_from_ints([x0], [0], [1]), t * steps)
    z0 = [f.decode(v)[0] for v in z0_t]
    pp, setup_s = _clock(lambda: ivc_public_params(t))
    for side in (pp.primary, pp.secondary):
        _ = side.dev_shape, side.ck.table, side.ck.with_h.table

    prover, _ = _clock(lambda: RecursiveIVC(pp, z0))
    step_s = []
    for k in range(steps - 1):
        if k == 1:  # the split covers the timed steps, after the first
            prover.timer = type(prover.timer)(prover.timer.sync)
        _, s = _clock(prover.prove_step)
        step_s.append(s)
    timed = step_s[1:]
    split = {name: secs / len(timed) for name, secs in prover.timer.totals.items()}
    proof = prover.proof()
    if not ivc_verify(pp, proof, steps, z0, start):
        raise SystemExit("device_plane_split: the IVC proof does not verify")

    parts: dict = {}
    with chip_smoke._fold_timers(parts):
        check = RecursiveIVC(pp, z0)
        for _ in range(args.check_steps - 1):
            check.prove_step()
    folds = 2 * (args.check_steps - 1)
    parts = {k: v / folds for k, v in parts.items()}

    compress_s, verify_s = [], []
    for _ in range(args.reps):
        cp, s = _clock(lambda: ivc_compress(pp, proof))
        compress_s.append(s)
        ok, s = _clock(lambda: ivc_verify_compressed(pp, cp, steps, z0, start))
        verify_s.append(s)
        if not ok:
            raise SystemExit("device_plane_split: the compressed proof does not verify")
    timer = PhaseTimer(sync=torch.cuda.synchronize)
    _, instrumented_s = _clock(lambda: ivc_compress(pp, proof, timer))

    print(json.dumps({
        "card": card, "tree": os.path.basename(os.getcwd()), "t": t, "steps": steps,
        "setup_s": setup_s,
        "folds_per_s_median": 1 / statistics.median(timed),
        "folds_per_s_min": 1 / max(timed), "folds_per_s_max": 1 / min(timed),
        "step_s": step_s, "phases_seconds_per_step": split,
        "fold_parts_s": parts, "fold_parts_folds": folds,
        "compress_s_median": statistics.median(compress_s), "compress_s": compress_s,
        "verify_compressed_s_median": statistics.median(verify_s),
        "verify_compressed_s": verify_s,
        "instrumented_compress_s": instrumented_s, "compress_parts_s": dict(timer.totals),
    }))


if __name__ == "__main__":
    main()
