#!/usr/bin/env python3
"""Time the MinRoot kernels K1 and K2 against the lane count on one GPU.

    python3 tools/minroot_lane_sweep.py

On Fq, for each lane count in SWEEP_LANES: K1 (minroot_eval) runs T
rounds on xorshift x with y = i = 0, as on chip_smoke.py's main path,
and K2 (minroot_inverse) runs T rounds on K1's output, which must give
the input back on every lane.  Each kernel is then timed RUNS times,
each time as the mean of REPS back-to-back launches between two CUDA
events, so the host's launch overhead hides behind the previous launch.
Prints the card's name and power limit, then one JSON line per lane
count: microseconds a round of each run, K1's iterations/s a lane (the
sequential rate, which the smallest lane counts show without any other
lane in the way) and its aggregate iterations/s.  Exits non-zero without
a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SWEEP_LANES = (1, 64, 1024, 8192, 32768, 57344, 131072)
T = 64
RUNS = 3
REPS = 5


def _mean_ms(fn, args) -> float:
    """Mean stream milliseconds of REPS back-to-back fn(*args) calls."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("minroot_lane_sweep: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from vdf_tpu_torch.fields import get_field
    from vdf_tpu_torch.fields.kernels import minroot_eval, minroot_inverse
    from vdf_tpu_torch.utils import TEST_SEED, XorShiftRng, field_random

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)

    device = torch.device("cuda", 0)
    f = get_field("Fq")
    rng = XorShiftRng(TEST_SEED)
    x = f.encode([field_random(rng, f.params.modulus) for _ in range(max(SWEEP_LANES))], device)
    zero = torch.zeros_like(x)

    for lanes in SWEEP_LANES:
        s = (x[:lanes], zero[:lanes], zero[:lanes])
        fwd = minroot_eval("Fq", *s, T)  # also the warm-up at this size
        back = minroot_inverse("Fq", *fwd, T)
        if not all(torch.equal(a, b) for a, b in zip(back, s)):
            raise SystemExit(f"inverse(eval(s)) != s at {lanes} lanes")
        k1_us = [_mean_ms(minroot_eval, ("Fq", *s, T)) * 1e3 / T for _ in range(RUNS)]
        k2_us = [_mean_ms(minroot_inverse, ("Fq", *fwd, T)) * 1e3 / T for _ in range(RUNS)]
        print(json.dumps({
            "lanes": lanes,
            "t": T,
            "k1_us_per_round": k1_us,
            "k2_us_per_round": k2_us,
            "k1_iters_per_s_per_lane": [1e6 / us for us in k1_us],
            "k1_iters_per_s": [lanes * 1e6 / us for us in k1_us],
        }), flush=True)


if __name__ == "__main__":
    main()
