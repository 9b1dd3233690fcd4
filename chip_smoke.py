#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # Fq, t = 2^16, 8,192 lanes

Phases (any failure exits non-zero; nothing is caught):

  1. build   compile csrc/*.cu for sm_90a with nvcc and load them;
  2. kernels K1 (minroot_eval) and K2 (minroot_inverse) against their plain
             PyTorch versions on the card, on Fp and Fq, 1,024 lanes of
             xorshift inputs at t = 4: bit-for-bit equal on every lane;
             then, on Fq at the main path's 8,192 lanes, each kernel's
             time beside its plain version's, and the two outputs
             bit-for-bit equal on every lane;
  3. main    pallas_vdf() -> Evaluation.eval(vdf, s0, t) -> proof.verify(s0)
             on CUDA tensors, a tampered proof that must fail, and a
             two-segment append that must verify; lanes 0, 1 and the last
             are checked against Python-int MinRoot;
  4. evidence the launch counters of both kernels moved during phase 3.

The last lines are a JSON object of per-kernel evidence, the card's name
and power limit, and the contract line
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Without a CUDA
device it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

LANES = 8192  # main-path lanes (BASELINE configs 1 and 4)
T = 1 << 16  # main-path rounds (BASELINE config 1)
CHECK_LANES = 1024  # kernel-vs-plain lanes
CHECK_T = 4  # kernel-vs-plain rounds (the plain K1 costs ~0.3 s a round)
T_APPEND = 1024  # rounds of the appended second segment


def _log(msg: str) -> None:
    print(msg, flush=True)


def _xorshift_ints(n: int, modulus: int, rng) -> list[int]:
    from vdf_tpu_torch.utils import field_random

    return [field_random(rng, modulus) for _ in range(n)]


def _cuda_ms(fn, args, reps: int):
    """Mean device milliseconds of fn(*args) over reps calls, after one
    warm-up, and the last call's result."""
    import torch

    out = fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def _max_abs_err(got, want) -> int:
    import torch

    diff = (got.to(torch.int64) & 0xFFFFFFFF) - (want.to(torch.int64) & 0xFFFFFFFF)
    return int(diff.abs().max().item())


def phase_build() -> None:
    from vdf_tpu_torch._build import load_kernels

    t0 = time.perf_counter()
    kernels = load_kernels()
    _log(f"build: nvcc {kernels.build_seconds:.3f} s, load {time.perf_counter() - t0:.3f} s "
         f"-> {kernels.path.name}")
    for line in kernels.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            _log(f"  ptxas: {line.strip()}")


def _require_equal(kname: str, field_name: str, got, want, err: dict) -> None:
    e = max(_max_abs_err(g, w) for g, w in zip(got, want))
    err[kname] = max(err[kname], e)
    if e:
        raise SystemExit(f"{kname} on {field_name} at {got[0].shape[0]} lanes disagrees "
                         f"with its plain version (max |limb diff| {e})")


def phase_kernels(device, lanes: int, t: int, timing_lanes: int) -> dict:
    """K1/K2 vs plain, bit for bit; returns per-kernel error and times."""
    import torch

    from vdf_tpu_torch.fields import FIELDS, get_field
    from vdf_tpu_torch.fields.kernels import (
        minroot_eval,
        minroot_eval_plain,
        minroot_inverse,
        minroot_inverse_plain,
    )
    from vdf_tpu_torch.utils import TEST_SEED, XorShiftRng

    rng = XorShiftRng(TEST_SEED)
    err = {"minroot_eval": 0, "minroot_inverse": 0}
    for name in ("Fp", "Fq"):
        f, p = get_field(name), FIELDS[name].modulus
        s = [f.encode(_xorshift_ints(lanes, p, rng), device) for _ in range(3)]
        fwd = minroot_eval(name, *s, t)
        fwd_plain = minroot_eval_plain(name, *s, t)
        back = minroot_inverse(name, *fwd, t)
        back_plain = minroot_inverse_plain(name, *fwd, t)
        torch.cuda.synchronize()
        _require_equal("minroot_eval", name, fwd, fwd_plain, err)
        _require_equal("minroot_inverse", name, back, back_plain, err)
        if not all(torch.equal(a, b) for a, b in zip(back, s)):
            raise SystemExit(f"inverse(eval(s)) != s on {name}")
        _log(f"kernels: {name} K1/K2 == plain on {lanes} lanes at t={t}, round trip ok")

    # At the main path's lane count (Fq): times, and kernel == plain bit for
    # bit on every lane.  Kernel and plain see the same tensors; K2 runs on
    # K1's output, and runs more rounds so a launch is not all overhead.
    f, p = get_field("Fq"), FIELDS["Fq"].modulus
    state = [f.encode(_xorshift_ints(timing_lanes, p, rng), device) for _ in range(3)]
    times = {}
    for kname, kern, plain, kt in (
        ("minroot_eval", minroot_eval, minroot_eval_plain, t),
        ("minroot_inverse", minroot_inverse, minroot_inverse_plain, 16 * t),
    ):
        ms, got = _cuda_ms(kern, ("Fq", *state, kt), reps=5)
        plain_ms, want = _cuda_ms(plain, ("Fq", *state, kt), reps=1)
        _require_equal(kname, "Fq", got, want, err)
        times[kname] = {"ms": ms, "plain_ms": plain_ms, "lanes": timing_lanes, "t": kt}
        _log(f"timing: {kname} Fq lanes={timing_lanes} t={kt}: kernel {ms:.4f} ms, "
             f"plain {plain_ms:.4f} ms; == plain on all {timing_lanes} lanes")
        state = got
    return {k: {"max_abs_err": err[k], **times[k]} for k in err}


def _oracle(p: int, e: int, s: tuple[int, int, int], t: int) -> tuple[int, int, int]:
    x, y, i = s
    for _ in range(t):
        x, y, i = pow((x + y) % p, e, p), (x + i) % p, (i + 1) % p
    return x, y, i


def phase_main(device, lanes: int, t: int, t_append: int) -> dict:
    import torch

    from vdf_tpu_torch import Evaluation, State, pallas_vdf
    from vdf_tpu_torch.fields.kernels import LAUNCHES, reset_launches
    from vdf_tpu_torch.utils import TEST_SEED, XorShiftRng

    vdf = pallas_vdf()
    f = vdf.field
    p, e = f.params.modulus, f.params.inv_alpha
    xs = _xorshift_ints(lanes, p, XorShiftRng(TEST_SEED))
    s0 = vdf.state_from_ints(xs, [0] * lanes, [0] * lanes, device=device)
    torch.cuda.synchronize()

    # Eval: wall time on the host clock, and the stream's time between two
    # CUDA events around the same call (eval does not synchronise).
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reset_launches()
    t0 = time.perf_counter()
    start.record()
    _, proof = Evaluation.eval(vdf, s0, t)
    end.record()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_event_s = start.elapsed_time(end) / 1e3

    t0 = time.perf_counter()
    ok = proof.verify(s0)  # bool() of a device tensor: synchronises
    verify_s = time.perf_counter() - t0
    if not ok:
        raise SystemExit("main: proof.verify(s0) is False")

    x_bad = proof.result.x.clone()
    x_bad[0, 0] ^= 1
    bad = Evaluation(State(x_bad, proof.result.y, proof.result.i), t, proof.field_name,
                     proof.mode)
    if bad.verify(s0):
        raise SystemExit("main: a proof with a flipped limb verified")

    _, seg2 = Evaluation.eval(vdf, proof.result, t_append)
    joined = proof.append(seg2)
    if joined is None or joined.t != t + t_append or not joined.verify(s0):
        raise SystemExit("main: two-segment append did not verify")
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    _log(f"main: launches during the main path {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise SystemExit(f"evidence: kernel {name} was not launched by the main path")

    got = vdf.state_to_ints(proof.result)
    for lane in (0, 1, lanes - 1):
        want = _oracle(p, e, (xs[lane], 0, 0), t)
        if tuple(v[lane] for v in got) != want:
            raise SystemExit(f"main: lane {lane} differs from Python-int MinRoot")
    _log(f"main: lanes 0, 1, {lanes - 1} match Python-int MinRoot at t={t}")

    iters = lanes * t
    out = {
        "lanes": lanes,
        "t": t,
        "eval_s": eval_s,
        "eval_event_s": eval_event_s,
        "verify_s": verify_s,
        "eval_iters_per_s": iters / eval_s,
        "eval_iters_per_s_per_lane": t / eval_s,
        "verify_iters_per_s": iters / verify_s,
        "launches": launches,
    }
    _log("main: " + json.dumps(out))
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; nothing was run")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import vdf_tpu_torch  # noqa: F401  (fails where the package is absent)

    device = torch.device("cuda", 0)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    phase_build()
    kernel_stats = phase_kernels(device, CHECK_LANES, CHECK_T, LANES)
    main_stats = phase_main(device, LANES, T, T_APPEND)

    replaces = {
        "minroot_eval": "vdf_tpu/fields/pallas_field.py:273",
        "minroot_inverse": "vdf_tpu/fields/pallas_field.py:382",
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": "vdf_tpu_torch/csrc/minroot_kernels.cuh",
            "replaces": replaces[name],
            "launches": main_stats["launches"][name],
            "max_abs_err": st["max_abs_err"],
            "ms": st["ms"],
            "plain_ms": st["plain_ms"],
            "timed_at": {"lanes": st["lanes"], "t": st["t"], "field": "Fq"},
        }
        for name, st in kernel_stats.items()
    ]
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
