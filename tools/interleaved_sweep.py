#!/usr/bin/env python3
"""Aggregate folds/s of prove_interleaved against the chains a call and
CPython's thread switch interval, on one GPU.

    python3 tools/interleaved_sweep.py

The bench IVC's params (t = 32, keys of 2^14, the device engine) and K
chains of STEPS steps from xorshift starts (their z0s from one K1 launch).
For each switch interval of SWITCH_S (``sys.setswitchinterval``; CPython's
default is 5 ms) and each K of CHAINS, ``prove_interleaved`` runs RUNS
times; a run's rate is K (STEPS - 1) / its wall seconds, base steps
included, as chip_smoke.py's phase 15 counts it.  Beside each run, the
host CPU seconds the process spent (``time.process_time``): under a GIL
that is held while waiting its share of the wall time stays near one core.
Prints the card's name and power limit, then one JSON line per (switch
interval, K): the runs' folds/s (median, min, max), the CPU share, and
the ratio to K = 1 at the same interval.  Every run's chains are checked
against the first run's proofs (the same bytes).  Exits non-zero without
a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

CHAINS = (1, 2, 4)
SWITCH_S = (5e-3, 1e-3, 2e-4)
STEPS = 8
T = 32
RUNS = 3


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("interleaved_sweep: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from vdf_tpu_torch import ivc_public_params, pallas_vdf, serialize_ivc_proof
    from vdf_tpu_torch.nova import prove_interleaved
    from vdf_tpu_torch.utils import XorShiftRng, field_random

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)

    vdf = pallas_vdf()
    p = vdf.field.params.modulus
    rng = XorShiftRng(bytes([7] * 16))
    k_max = max(CHAINS)
    s0 = vdf.state_from_ints([field_random(rng, p) for _ in range(k_max)], [0] * k_max,
                             [1] * k_max)
    z0s = [list(c) for c in zip(*vdf.state_to_ints(vdf.eval(s0, T * STEPS)))]
    pp = ivc_public_params(T)
    want = [serialize_ivc_proof(pp, pf) for pf in prove_interleaved(pp, z0s, STEPS)]

    default = sys.getswitchinterval()
    try:
        for switch in SWITCH_S:
            sys.setswitchinterval(switch)
            base = None
            for k in CHAINS:
                rates, shares = [], []
                for _ in range(RUNS):
                    torch.cuda.synchronize()
                    c0, t0 = time.process_time(), time.perf_counter()
                    proofs = prove_interleaved(pp, z0s[:k], STEPS)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    shares.append((time.process_time() - c0) / wall)
                    rates.append(k * (STEPS - 1) / wall)
                    if [serialize_ivc_proof(pp, pf) for pf in proofs] != want[:k]:
                        raise SystemExit(f"interleaved_sweep: K={k} gave other proofs")
                med = sorted(rates)[len(rates) // 2]
                base = med if k == 1 else base
                print(json.dumps({
                    "switch_ms": switch * 1e3, "chains": k, "folds_per_s_median": med,
                    "folds_per_s_min": min(rates), "folds_per_s_max": max(rates),
                    "cpu_share": sorted(shares)[len(shares) // 2],
                    "over_one_chain": med / base if base else None}), flush=True)
    finally:
        sys.setswitchinterval(default)


if __name__ == "__main__":
    main()
