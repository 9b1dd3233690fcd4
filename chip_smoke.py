#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py   # takes no options; needs one card

Main paths: MinRoot over Fq, t = 2^14 on 8,192 lanes; fixed-base commits at
n = 2^14; the variable-base MSM at n = 2^20; the single-curve Nova folding
engine at t = 1000 iterations a step, 2 steps.

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
  4. evidence the launch counters of both kernels moved during phase 3's
             eval -> verify (read before the tamper and append checks);
  5. commit kernels  K3 (canon_digits, canon_mont), K7 (shift_gens), K4
             (scan), K5 (colscan) and K6 (bucket) against their plain
             versions on the card, on Pallas and Vesta at n = 256 (K = 2
             rows): every output element bit-for-bit equal; then at the
             commit's main shape, n = 2^14, each kernel's time beside its
             plain version's, outputs again bit-for-bit equal;
  6. commit  for Pallas and Vesta: commitment_key(curve, 2^14) (host
             derivation and K7 table timed apart), commit of xorshift
             scalars == the native C++ Pippenger in affine (Pallas; on Vesta
             == the variable-base msm over the same generators), the K = 2
             batch == two single commits, zero -> identity, e_0 -> G_0,
             (q - 1) e_{n-1} -> -G_{n-1}, one changed scalar changes the
             commitment; commit_fixed's canonical output agrees; wall and
             CUDA-event ms of a commit at K = 1 and K = 2;
  7. evidence the launch counters of K3-K7 moved during phase 6's key ->
             table -> first commit on each curve (read before the checks);
  8. MSM kernels  K9 (horner) against its plain version on Pallas and Vesta
             at B = 1 and B = 5, and K3's window-row layout, K4, K5, K6 in
             the variable-base shape (22 batch rows, one a window) against
             theirs at n = 2^12: bit for bit; then on Pallas at n = 2^20
             each stage's time beside its plain version's on the same
             tensors (K4's and K5's one window row at a time, to bound
             their temporaries), outputs bit for bit equal, and the 22 window
             sums == the native Pippenger on the base points with each
             window's digits summed by residue;
  9. MSM     msm(curve, points, scalars) on Pallas at n = 2^20 (1,024
             hash-derived base points repeated, scalars from numpy's
             default_rng(7)) == the native Pippenger on the 1,024 base points
             with the scalars summed by residue; at n = 2^12 on both curves
             == the native Pippenger; n = 1, n = 23 and a vector with P, -P,
             the identity, a repeat and zero scalars; wall and CUDA-event ms;
 10. engine  public_params(1000) -> eval_and_make_circuits(vdf, 1000, 2, s0)
             -> NovaVDFProof.prove_recursively -> proof.verify, all on the
             card with no device argument: verify is True; wrong num_steps,
             zi, z0, one changed limb of W.w and one changed step instance x
             are rejected; msm over the key's generators == ck.commit for
             each step's witness and for W.e; U.comm_w == the native
             Pippenger on W.w; set-up, prove and verify s, and the prove
             step's split by part from a second, instrumented prove;
 11. evidence the launch counters of K1, K3-K7 and K9 moved during
             phase 9's one msm at n = 2^20 and phase 10's set-up -> eval ->
             prove -> verify (each read before the phase's other checks; K9
             runs on the msm path only).

The last lines are a JSON object of per-kernel evidence, the card's name
and power limit, and the contract line
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Without a CUDA
device it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

LANES = 8192  # main-path lanes (BASELINE configs 1 and 4)
T = 1 << 14  # main-path rounds (a quarter of BASELINE config 1's 2^16)
CHECK_LANES = 1024  # kernel-vs-plain lanes
CHECK_T = 4  # kernel-vs-plain rounds (the plain K1 costs ~0.3 s a round)
T_APPEND = 1024  # rounds of the appended second segment
COMMIT_N = 1 << 14  # commit length: the bench IVC's (t = 32) _commit_pad, both curves
COMMIT_CHECK_N = 256  # kernel-vs-plain commit length
COMMIT_CURVES = ("pallas", "vesta")
COMMIT_NATIVE_CURVE = "pallas"  # the curve whose 2^14 commit the native Pippenger checks
MSM_N = 1 << 20  # variable-base MSM length (BASELINE config 5)
MSM_CHECK_N = 1 << 12  # kernel-vs-plain and native-check MSM length
MSM_BASE = 1024  # distinct base points of the MSM inputs, repeated to n
ENGINE_T = 1000  # MinRoot iterations a Nova step (the reference sweep point)
ENGINE_STEPS = 2  # Nova steps

# The card's limits for each kernel's bound (the least time it could take):
# bytes over the memory rate, and 32-bit multiply-adds over the int32 instruction
# rate, SMS x INT32_LANES x the SM clock nvidia-smi reports as its maximum.
HBM_BYTES_PER_S = 3.35e12
SMS, INT32_LANES = 132, 64
# One Montgomery product (csrc/field.cuh, CIOS on 8 u32 limbs): 128 wide
# multiply-adds of 32 x 32 -> 64 bits, two int32 instructions each, and 8 low
# products; additions and carries are left out, so the bound is a lower one.
MADS_PER_PRODUCT = 2 * 128 + 8
PRODUCTS_ADD, PRODUCTS_DBL = 14, 9  # complete add, doubling (csrc/curve.cuh)

COMMIT_KERNELS = {  # launch counter -> (wrapper in curves/kernels.py, TPU kernel it replaces)
    "canon_digits": ("canon_digits", "vdf_tpu/curves/pallas_msm.py:130"),  # K3 mode 0
    "canon_mont": ("canon_mont", "vdf_tpu/curves/pallas_msm.py:130"),  # K3 mode 1
    "shift_gens": ("shift_gens", "vdf_tpu/curves/pallas_msm.py:259"),  # K7
    "scan": ("bucket_scan", "vdf_tpu/curves/pallas_msm.py:150"),  # K4
    "colscan": ("column_carries", "vdf_tpu/curves/pallas_msm.py:171"),  # K5
    "bucket": ("bucket_sums", "vdf_tpu/curves/pallas_msm.py:206"),  # K6
}


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


def _sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def _tensor_bytes(*items) -> int:
    import torch

    total = 0
    for a in items:
        if isinstance(a, torch.Tensor):
            total += a.numel() * a.element_size()
        elif isinstance(a, (tuple, list)):
            total += _tensor_bytes(*a)
    return total


def _minroot_products(field_name: str, forward: bool) -> int:
    """Montgomery products of one MinRoot round a lane: the w = 4 windowed
    5th root (14 for the table, 4 squarings a digit after the first, one
    product a nonzero digit), or x^5 (3)."""
    from vdf_tpu_torch.fields import FIELDS

    if not forward:
        return 3
    digits = FIELDS[field_name].inv_alpha_digits
    return 14 + 4 * (len(digits) - 1) + sum(1 for d in digits[1:] if d)


def _kernel_products(kname: str, args, out) -> int:
    """Montgomery products the kernel's function needs on these inputs
    (data-dependent kernels count what this data needs)."""
    from vdf_tpu_torch.curves import kernels as CK

    if kname in ("minroot_eval", "minroot_inverse"):
        field_name, x, _, _, t = args
        return x.shape[0] * t * _minroot_products(field_name, kname == "minroot_eval")
    if kname == "canon_digits":
        return args[1].shape[0] * args[1].shape[1]
    if kname == "canon_mont":
        return args[1].shape[0]
    if kname == "shift_gens":
        return args[1].shape[0] * (CK.WINDOWS - 1) * CK.WINDOW_BITS * PRODUCTS_DBL
    if kname == "scan":  # one add an item that continues a run inside its column
        keys, rows = args[2], args[3]
        d = (keys >> 32).reshape(keys.shape[0], -1, rows)
        return int((d[:, :, 1:] == d[:, :, :-1]).sum().item()) * PRODUCTS_ADD
    if kname == "colscan":  # one add a column after the first that holds no run's head
        return int((args[2][:, 1:] == 0).sum().item()) * PRODUCTS_ADD
    if kname == "bucket":  # carries, then the three radix-16 levels
        k = args[1].shape[0]
        adds = int((args[2] >= 0).sum().item()) + k * (256 * 29 + 16 * 44 + 60)
        return adds * PRODUCTS_ADD + k * 8 * PRODUCTS_DBL
    if kname == "horner":
        b = args[1].shape[0]
        return b * CK.WINDOWS * (CK.WINDOW_BITS * PRODUCTS_DBL + PRODUCTS_ADD)
    raise SystemExit(f"no operation count for kernel {kname}")


def _bound(kname: str, args, out, clock_hz: float) -> dict:
    """The least time the card could take for this call: each input read
    once and each output written once at the memory rate, or the function's
    multiply-adds at the int32 instruction rate, whichever is larger."""
    nbytes = _tensor_bytes(args, out)
    mads = _kernel_products(kname, args, out) * MADS_PER_PRODUCT
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = mads / (SMS * INT32_LANES * clock_hz) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "multiply_adds": mads, "library_ms": None}


def _max_abs_err(got, want) -> int:
    """Largest |difference| between two equal-shaped integer tensors; int32
    limbs compare as the u32 words they hold."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise SystemExit(f"shape/dtype mismatch: {tuple(got.shape)} {got.dtype} vs "
                         f"{tuple(want.shape)} {want.dtype}")
    g, w = got.to(torch.int64), want.to(torch.int64)
    if got.dtype == torch.int32:
        g, w = g & 0xFFFFFFFF, w & 0xFFFFFFFF
    return int((g - w).abs().max().item()) if g.numel() else 0


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


def phase_kernels(device, lanes: int, t: int, timing_lanes: int, clock_hz: float) -> dict:
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
        times[kname] = {"ms": ms, "plain_ms": plain_ms, "lanes": timing_lanes, "t": kt,
                        **_bound(kname, ("Fq", *state, kt), got, clock_hz)}
        _log(f"timing: {kname} Fq lanes={timing_lanes} t={kt}: kernel {ms:.4f} ms, "
             f"plain {plain_ms:.4f} ms, bound {times[kname]['bound_ms']:.6f} ms "
             f"({times[kname]['bound_by']}); == plain on all {timing_lanes} lanes")
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
    launches = dict(LAUNCHES)  # of eval -> verify alone, before the checks below

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
    _log(f"main: launches during the main path (one eval, one verify) {launches}")
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


def _commit_inputs(curve_name: str, n: int, k: int, device):
    """Inputs of the commit kernels at length n: the points of a small
    hash-derived set, repeated to n, as generators (n, 3, 8) and as
    canonical x-coordinate integers (K3 mode 1's input); k rows of
    xorshift scalars holding 0, 1, q - 1 and a run of n/4 equal values
    (runs that cross columns); their window-digit keys, and those sorted."""
    import numpy as np
    import torch

    from vdf_tpu_torch.curves import get_curve, hash_to_curve_ints, stack_point
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.curves.bucket_msm import layout
    from vdf_tpu_torch.utils import TEST_SEED, XorShiftRng

    c = get_curve(curve_name)
    base = hash_to_curve_ints(curve_name, min(n, COMMIT_CHECK_N), domain=b"vdf_tpu/t")
    aff = [base[i % len(base)] for i in range(n)]
    gens = stack_point(c.from_affine_ints(aff, device)).contiguous()
    xs = b"".join(x.to_bytes(32, "little") for x, _ in aff)
    ints = torch.from_numpy(np.frombuffer(xs, dtype="<u4").view(np.int32).copy())
    ints = ints.reshape(n, 8).to(device)
    q = c.scalar.params.modulus
    vals = _xorshift_ints(k * n, q, XorShiftRng(TEST_SEED))
    vals[:4] = [0, 1, q - 1, q - 1]
    vals[4 : 4 + n // 4] = [vals[4]] * (n // 4)
    s = c.scalar.encode(vals, device).reshape(k, n, 8)
    _, m_pad = layout(n)
    keys = CK.canon_digits(c.params.scalar_field, s, m_pad)
    return gens, ints, s, keys, torch.sort(keys, dim=-1).values


def _commit_stage_args(curve_name: str, gens, ints, s, sorted_keys) -> dict:
    """counter -> the arguments its wrapper and plain version both take.
    Each stage's inputs are the kernel outputs of the stage before it."""
    from vdf_tpu_torch.curves import CURVES
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.curves.bucket_msm import ROWS

    bf, sf = CURVES[curve_name].base_field, CURVES[curve_name].scalar_field
    table = CK.shift_gens(bf, gens)
    tails, tail_col, sums, flags = CK.bucket_scan(bf, table, sorted_keys, ROWS)
    carries = CK.column_carries(bf, sums, flags)
    return {
        "canon_digits": (sf, s, sorted_keys.shape[1]),
        "canon_mont": (bf, ints),
        "shift_gens": (bf, gens),
        "scan": (bf, table, sorted_keys, ROWS),
        "colscan": (bf, sums, flags),
        "bucket": (bf, tails, tail_col, carries),
    }


def _require_same(kname: str, where: str, got, want, err: dict) -> None:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    e = max(_max_abs_err(g, w) for g, w in zip(got, want))
    err[kname] = max(err.get(kname, 0), e)
    if e:
        raise SystemExit(f"{kname} {where} disagrees with its plain version (max |diff| {e})")


def phase_commit_kernels(device, check_n: int, n: int, clock_hz: float) -> dict:
    """K3-K7 vs plain, bit for bit, on both curves at check_n (K = 2
    rows), then at n (K = 1) with times; returns per-kernel error and the
    Pallas times at n."""
    import torch

    from vdf_tpu_torch.curves import kernels as CK

    err, times = {}, {}
    for curve_name in COMMIT_CURVES:
        gens, ints, s, _, sorted_keys = _commit_inputs(curve_name, check_n, 2, device)
        args = _commit_stage_args(curve_name, gens, ints, s, sorted_keys)
        for kname, (fn, _) in COMMIT_KERNELS.items():
            got = getattr(CK, fn)(*args[kname])
            want = getattr(CK, fn + "_plain")(*args[kname])
            torch.cuda.synchronize()
            _require_same(kname, f"on {curve_name} at n={check_n}", got, want, err)
        _log(f"commit kernels: {curve_name} K3-K7 == plain at n={check_n}, K=2, bit for bit")

    for curve_name in COMMIT_CURVES:
        gens, ints, s, keys, sorted_keys = _commit_inputs(curve_name, n, 1, device)
        sort_ms, _ = _cuda_ms(lambda k: torch.sort(k, dim=-1).values, (keys,), reps=5)
        _log(f"timing: torch.sort of {keys.shape[1]} keys on {curve_name}: {sort_ms:.4f} ms")
        args = _commit_stage_args(curve_name, gens, ints, s, sorted_keys)
        for kname, (fn, _) in COMMIT_KERNELS.items():
            ms, got = _cuda_ms(getattr(CK, fn), args[kname], reps=5)
            plain_ms, want = _cuda_ms(getattr(CK, fn + "_plain"), args[kname], reps=1)
            _require_same(kname, f"on {curve_name} at n={n}", got, want, err)
            bound = _bound(kname, args[kname], got, clock_hz)
            _log(f"timing: {kname} {curve_name} n={n}: kernel {ms:.4f} ms, plain "
                 f"{plain_ms:.4f} ms, bound {bound['bound_ms']:.6f} ms ({bound['bound_by']}); "
                 f"== plain, bit for bit")
            if curve_name == "pallas":
                times[kname] = {"ms": ms, "plain_ms": plain_ms, **bound}
    return {k: {"max_abs_err": err[k], **times[k]} for k in COMMIT_KERNELS}


def _affine(curve, pt):
    from vdf_tpu_torch.curves import Point

    return curve.to_affine_ints(Point(*(v[None] for v in pt)))[0]


def _commit_ms(fn, arg, reps: int = 5) -> tuple[float, float]:
    """(wall ms, CUDA-event ms) of fn(arg), means of reps calls after one
    warm-up; the host clock runs from the first call to a synchronize."""
    import torch

    fn(arg)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn(arg)
    end.record()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps, start.elapsed_time(end) / reps


def phase_commit(device, n: int) -> tuple[dict, dict]:
    """The commit main path on both curves; returns per-curve stats and
    the K3-K7 launch counts of the run."""
    import torch

    from vdf_tpu_torch.curves import commit_fixed, get_curve, msm, stack_point
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.native import msm_native_affine
    from vdf_tpu_torch.nova import DEFAULT_LABEL, commitment_key, derive_generators
    from vdf_tpu_torch.utils import TEST_SEED, XorShiftRng

    stats, cross = {}, []
    launches = dict.fromkeys(COMMIT_KERNELS, 0)
    for name in COMMIT_CURVES:
        c = get_curve(name)
        mod, q = c.field.params.modulus, c.scalar.params.modulus
        t0 = time.perf_counter()
        pts = derive_generators(name, n, DEFAULT_LABEL)
        derive_s = time.perf_counter() - t0
        CK.reset_launches()
        t0 = time.perf_counter()
        ck = commitment_key(name, n, device=device)  # K3 mode 1 on the derived ints
        torch.cuda.synchronize()
        key_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        table = ck.table  # K7
        torch.cuda.synchronize()
        table_s = time.perf_counter() - t0
        _log(f"commit: {name} key n={n}: derivation {derive_s:.3f} s (host), to the card "
             f"{key_s:.3f} s, K7 table {tuple(table.shape)} {table_s:.3f} s")

        rng = XorShiftRng(TEST_SEED)
        vals, vals2 = _xorshift_ints(n, q, rng), _xorshift_ints(n, q, rng)
        s, s2 = c.scalar.encode(vals, device), c.scalar.encode(vals2, device)
        pt = ck.commit(s)
        for kname in launches:  # of key -> table -> one commit alone, before the checks below
            launches[kname] += CK.LAUNCHES[kname]
        t0 = time.perf_counter()
        got = _affine(c, pt)
        decode_ms = (time.perf_counter() - t0) * 1e3
        native_s = None
        if name == COMMIT_NATIVE_CURVE:
            t0 = time.perf_counter()
            want = msm_native_affine(name, list(pts[:n]), vals)
            native_s = time.perf_counter() - t0
            if got is None or got != want:
                raise SystemExit(f"commit: {name} commit != native Pippenger in affine")
        else:
            cross.append((name, ck, s, got))

        batch = stack_point(ck.commit_batch(torch.stack([s, s2])))
        if not (torch.equal(batch[0], stack_point(pt))
                and torch.equal(batch[1], stack_point(ck.commit(s2)))):
            raise SystemExit(f"commit: {name} K = 2 batch != two single commits")
        zero = torch.zeros_like(s)
        if _affine(c, ck.commit(zero)) is not None:
            raise SystemExit(f"commit: {name} zero vector did not give the identity")
        e0 = zero.clone()
        e0[0] = c.scalar.encode(1, device)
        if _affine(c, ck.commit(e0)) != pts[0]:
            raise SystemExit(f"commit: {name} e_0 did not give G_0")
        last = zero.clone()
        last[n - 1] = c.scalar.encode(q - 1, device)
        x, y = pts[n - 1]
        if _affine(c, ck.commit(last)) != (x, (-y) % mod):
            raise SystemExit(f"commit: {name} (q - 1) e_(n-1) did not give -G_(n-1)")
        changed = s.clone()
        changed[n // 2] = c.scalar.encode(vals[n // 2] + 1, device)
        if _affine(c, ck.commit(changed)) == got:
            raise SystemExit(f"commit: {name} changing one scalar left the commitment as it was")
        _, canon = commit_fixed(name, s)
        cx, cy, cz = (int.from_bytes(r.to(torch.int64).bitwise_and(0xFFFFFFFF).cpu().numpy()
                                     .astype("<u4").tobytes(), "little") for r in canon)
        zi = pow(cz, -1, mod)
        if (cx * zi % mod, cy * zi % mod) != got:
            raise SystemExit(f"commit: {name} commit_fixed's canonical output disagrees")

        k1_wall, k1_event = _commit_ms(ck.commit, s)
        k2_wall, k2_event = _commit_ms(ck.commit_batch, torch.stack([s, s2]))
        stats[name] = {
            "n": n, "derive_s": derive_s, "key_to_card_s": key_s, "table_s": table_s,
            "commit_ms": k1_wall, "commit_event_ms": k1_event,
            "commit2_ms": k2_wall, "commit2_event_ms": k2_event,
            "decode_ms": decode_ms, "native_s": native_s,
        }
        _log(f"commit: {name} K=2 == singles; zero, e_0, (q-1) e_(n-1) and a changed scalar "
             f"ok; " + json.dumps(stats[name]))
    torch.cuda.synchronize()
    _log(f"commit: launches during the commit main path (key, table and one commit a curve) "
         f"{launches}")
    for kname, count in launches.items():
        if count <= 0:
            raise SystemExit(f"evidence: kernel {kname} was not launched by the commit main path")
    # The other curve's commit against the variable-base MSM over the same generators (the native Pippenger,
    # ~10 s at this length, checks one curve).
    for name, ck, s, got in cross:
        c = get_curve(name)
        if got is None or _affine(c, msm(c, ck.gens, s)) != got:
            raise SystemExit(f"commit: {name} commit != msm over the key's generators")
        _log(f"commit: {name} commit == msm over the same generators in affine")
    return stats, launches


def _msm_inputs(curve_name: str, n: int, device):
    """The MSM bench inputs (bench.py): MSM_BASE hash-derived base points
    repeated to n, and n scalars drawn from numpy's default_rng(7), reduced
    mod q.  Returns the base points' affine ints, the points (n, 3, 8) and
    the Montgomery scalars (n, 8) on the device, and the scalars as ints."""
    import numpy as np
    import torch

    from vdf_tpu_torch.curves import get_curve, hash_to_curve_ints, stack_point
    from vdf_tpu_torch.curves import kernels as CK

    c = get_curve(curve_name)
    base_aff = hash_to_curve_ints(curve_name, min(n, MSM_BASE), domain=b"vdf_tpu/bench")
    base = stack_point(c.from_affine_ints(base_aff, device))
    pts = base[torch.arange(n, device=device) % len(base_aff)].contiguous()
    q = c.scalar.params.modulus
    raw = np.random.default_rng(7).bytes(32 * n)
    ints = [int.from_bytes(raw[32 * k : 32 * k + 32], "little") % q for k in range(n)]
    limbs = torch.from_numpy(np.frombuffer(raw, dtype="<u4").view(np.int32).copy())
    # K3's domain mode reduces each 256-bit pattern mod q on the card.
    scalars = CK.canon_mont(c.params.scalar_field, limbs.reshape(n, 8).to(device))
    return base_aff, pts, scalars, ints


def _msm_stage_args(curve_name: str, pts, scalars) -> dict:
    """counter -> arguments of its wrapper in the variable-base shape (one
    batch row a window); each stage's inputs are the kernel outputs of the
    stage before it."""
    import torch

    from vdf_tpu_torch.curves import CURVES
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.curves.bucket_msm import ROWS
    from vdf_tpu_torch.curves.msm import msm_layout

    bf, sf = CURVES[curve_name].base_field, CURVES[curve_name].scalar_field
    _, m_pad = msm_layout(pts.shape[0])
    keys = CK.canon_digits(sf, scalars[None], m_pad, True)[0]
    sorted_keys = torch.sort(keys, dim=-1).values
    tails, tail_col, sums, flags = CK.bucket_scan(bf, pts, sorted_keys, ROWS)
    carries = CK.column_carries(bf, sums, flags)
    window_sums = CK.bucket_sums(bf, tails, tail_col, carries)
    return {
        "canon_digits": (sf, scalars[None], m_pad, True),
        "scan": (bf, pts, sorted_keys, ROWS),
        "colscan": (bf, sums, flags),
        "bucket": (bf, tails, tail_col, carries),
        "horner": (bf, window_sums[None].contiguous()),
    }, keys


# Arguments of a stage that its plain version at the main shape takes one
# window row (47,663 columns) at a time: that bounds the int64 digit
# temporaries of K4's and K5's plain versions, 2 KB a point for each field
# product in flight, which over all 22 rows at once is a million points a step.
MSM_PLAIN_ROW_ARGS = {"scan": (2,), "colscan": (1, 2)}


def _plain_by_rows(plain, a, row_args):
    """plain(*a); with ``row_args``, one leading row of those arguments at a
    time, the results joined again."""
    import torch

    if not row_args:
        return plain(*a)
    outs = [plain(*(v[w : w + 1] if j in row_args else v for j, v in enumerate(a)))
            for w in range(a[row_args[0]].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def phase_msm_kernels(device, check_n: int, n: int, clock_hz: float) -> dict:
    """K9 vs plain at B = 1 and B = 5, and K3 (window rows), K4, K5, K6 in
    the variable-base shape vs plain at check_n, on both curves, bit for
    bit; then on Pallas at n every stage's time, its plain version's on the
    same tensors with the outputs bit for bit equal, and the 22 window sums
    against the native Pippenger.  Returns K9's stats and the stage times
    at n."""
    import torch

    from vdf_tpu_torch.curves import CURVES, get_curve, hash_to_curve_ints, stack_point
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.native import msm_native_affine

    err = {}
    for curve_name in COMMIT_CURVES:
        bf = CURVES[curve_name].base_field
        gens = stack_point(get_curve(curve_name).from_affine_ints(
            hash_to_curve_ints(curve_name, 5, domain=b"vdf_tpu/t"), device)).contiguous()
        rows = CK.shift_gens(bf, gens).reshape(CK.WINDOWS, 5, 3, 8).transpose(0, 1).contiguous()
        rows[3, 7] = CK._identity_rows(bf, (), device)
        for b in (1, 5):
            sums = rows[:b].contiguous()
            got, want = CK.horner(bf, sums), CK.horner_plain(bf, sums)
            torch.cuda.synchronize()
            _require_same("horner", f"on {curve_name} at B={b}", got, want, err)
        _, pts, scalars, _ = _msm_inputs(curve_name, check_n, device)
        args, _ = _msm_stage_args(curve_name, pts, scalars)
        for kname, a in args.items():
            fn = COMMIT_KERNELS[kname][0] if kname in COMMIT_KERNELS else kname
            got, want = getattr(CK, fn)(*a), getattr(CK, fn + "_plain")(*a)
            torch.cuda.synchronize()
            _require_same(kname, f"on {curve_name} at n={check_n}, variable base", got, want, err)
        _log(f"msm kernels: {curve_name} K9 == plain at B=1 and 5; K3 (window rows), K4, K5, "
             f"K6, K9 == plain at n={check_n} (22 rows), bit for bit")

    base_aff, pts, scalars, _ = _msm_inputs("pallas", n, device)
    args, keys = _msm_stage_args("pallas", pts, scalars)
    stages = {}
    sort_ms, _ = _cuda_ms(lambda k: torch.sort(k, dim=-1).values, (keys,), reps=5)
    stages["sort"] = {"ms": sort_ms}
    _log(f"timing: torch.sort of {tuple(keys.shape)} int64 keys: {sort_ms:.4f} ms")
    for kname, a in args.items():
        fn = COMMIT_KERNELS[kname][0] if kname in COMMIT_KERNELS else kname
        ms, got = _cuda_ms(getattr(CK, fn), a, reps=5)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = _plain_by_rows(getattr(CK, fn + "_plain"), a, MSM_PLAIN_ROW_ARGS.get(kname, ()))
        end.record()
        torch.cuda.synchronize()
        _require_same(kname, f"on pallas at n={n}, variable base", got, want, err)
        stages[kname] = {"ms": ms, "plain_ms": start.elapsed_time(end),
                         **_bound(kname, a, got, clock_hz)}
        _log(f"timing: {kname} pallas variable base n={n}: kernel {ms:.4f} ms, plain "
             f"{stages[kname]['plain_ms']:.4f} ms, bound {stages[kname]['bound_ms']:.6f} ms "
             f"({stages[kname]['bound_by']}); == plain, bit for bit")
        del got, want

    # S_w = sum_i digit_w(s_i) P_i, and point i is base point i mod MSM_BASE:
    # each window sum equals the native Pippenger on the base points with the
    # window's digits (those of K3's keys, just held against its plain
    # version) summed by residue.
    c = get_curve("pallas")
    digit_sums = torch.zeros((CK.WINDOWS, len(base_aff)), dtype=torch.int64, device=device)
    digit_sums.scatter_add_(1, (keys & 0xFFFFFFFF) % len(base_aff), keys >> 32)
    for w, (s_w, coeffs) in enumerate(zip(args["horner"][1][0], digit_sums.tolist())):
        if _affine(c, s_w) != msm_native_affine("pallas", list(base_aff), coeffs):
            raise SystemExit(f"msm kernels: window sum {w} at n={n} != the native Pippenger on "
                             f"the base points with the window's summed digits")
    _log(f"msm kernels: all {CK.WINDOWS} window sums at n={n} == the native Pippenger on the "
         f"{len(base_aff)} base points with the summed digits")
    del args, keys
    torch.cuda.empty_cache()
    return {"horner": {"max_abs_err": err["horner"], **stages["horner"]}, "stages": stages}


def _collapsed(base_n: int, ints: list[int], q: int) -> list[int]:
    """Point k of the MSM inputs is base point k mod base_n, so the MSM
    equals the one over the base points with these summed scalars."""
    sums = [0] * base_n
    for k, v in enumerate(ints):
        sums[k % base_n] += v
    return [v % q for v in sums]


def phase_msm(device, n: int, check_n: int) -> tuple[dict, dict]:
    """The variable-base MSM main path; returns stats and launch counts."""
    import torch

    from vdf_tpu_torch import msm
    from vdf_tpu_torch.curves import Point, get_curve, get_int_curve, unstack_point
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.native import msm_native_affine

    for curve_name in ("vesta", "pallas"):  # Vesta for correctness at check_n
        c = get_curve(curve_name)
        base_aff, pts, scalars, ints = _msm_inputs(curve_name, check_n, device)
        got = _affine(c, msm(c, unstack_point(pts), scalars))
        aff = [base_aff[k % len(base_aff)] for k in range(check_n)]
        if got is None or got != msm_native_affine(curve_name, aff, ints):
            raise SystemExit(f"msm: {curve_name} n={check_n} != native Pippenger in affine")
        _log(f"msm: {curve_name} n={check_n} == native Pippenger in affine")

    c, ic = get_curve("pallas"), get_int_curve("pallas")
    q = c.scalar.params.modulus
    for small in (1, 23):
        if _affine(c, msm(c, unstack_point(pts[:small].contiguous()), scalars[:small])) != \
                msm_native_affine("pallas", aff[:small], ints[:small]):
            raise SystemExit(f"msm: n={small} != native Pippenger")
    # P, -P, the identity, a repeated point, zero scalars.
    a, b = (ic.from_affine(p) for p in base_aff[:2])
    edge = [a, ic.neg(a), (0, 1, 0), b, b, a]
    vals = [ints[0], ints[0], ints[1], ints[2], ints[3], 0]
    ep = Point(*(c.field.encode([p[k] for p in edge], device) for k in range(3)))
    want = ic.to_affine(ic.scalar_mul(b, (ints[2] + ints[3]) % q))
    if _affine(c, msm(c, ep, c.scalar.encode(vals, device))) != want:
        raise SystemExit("msm: the edge vector (P, -P, identity, repeats, zero) is wrong")
    _log("msm: n=1, n=23 and the edge vector agree with the native Pippenger / IntCurve")

    t0 = time.perf_counter()
    base_aff, pts, scalars, ints = _msm_inputs("pallas", n, device)
    points = unstack_point(pts)
    torch.cuda.synchronize()
    inputs_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    CK.reset_launches()
    total = msm(c, points, scalars)
    launches = dict(CK.LAUNCHES)  # of this one call alone
    got = _affine(c, total)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    want = msm_native_affine("pallas", list(base_aff), _collapsed(len(base_aff), ints, q))
    native_s = time.perf_counter() - t0
    if got is None or got != want:
        raise SystemExit(f"msm: n={n} != the native Pippenger on the {len(base_aff)} base "
                         f"points with the summed scalars")
    wall_ms, event_ms = _commit_ms(lambda s: msm(c, points, s), scalars, reps=3)
    stats = {"n": n, "msm_ms": wall_ms, "msm_event_ms": event_ms,
             "points_per_s": n / (wall_ms / 1e3), "inputs_s": inputs_s,
             "collapsed_native_s": native_s, "peak_bytes": peak}
    torch.cuda.synchronize()
    _log(f"msm: pallas n={n} == native Pippenger on the collapsed inputs; " + json.dumps(stats))
    _log(f"msm: launches during the MSM main path (one msm at n={n}) {launches}")
    for kname in ("canon_digits", "scan", "colscan", "bucket", "horner"):
        if launches[kname] <= 0:
            raise SystemExit(f"evidence: kernel {kname} was not launched by the MSM main path")
    del pts, scalars, points
    torch.cuda.empty_cache()
    return stats, launches


ENGINE_PARTS = ("witness", "commits", "matvecs", "transcript", "inversions", "point_scalings")


@contextlib.contextmanager
def _split_timers(acc: dict):
    """While inside, the engine's coarse parts (a few dozen calls a step,
    none nested in another) run between two synchronisations and add their
    host seconds to ``acc``: the witness pass, the commits, the cross term's
    matvecs, the Poseidon permutations, absorb_point's inversions and the
    point scalings by the challenge."""
    import torch

    from vdf_tpu_torch.curves import Curve
    from vdf_tpu_torch.fields import Field
    from vdf_tpu_torch.nova import CommitmentKey, DeviceShape, InverseMinRootCircuit
    from vdf_tpu_torch.poseidon import Poseidon

    targets = dict(zip(ENGINE_PARTS, (
        (InverseMinRootCircuit, "synthesize"), (CommitmentKey, "commit"),
        (DeviceShape, "cross_term"), (Poseidon, "permute_array"), (Field, "inv"),
        (Curve, "scalar_mul_bits"))))
    saved = []
    for part, (owner, name) in targets.items():
        fn = getattr(owner, name)

        def timed(*args, _fn=fn, _part=part, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            acc[_part] = acc.get(_part, 0.0) + time.perf_counter() - t0
            return out

        saved.append((owner, name, fn))
        setattr(owner, name, timed)
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def phase_engine(t: int, steps: int) -> tuple[dict, dict]:
    """The single-curve folding engine through its entry points, with no
    device argument anywhere; returns stats and the launch counts of K1/K2
    and of K3-K9 from the set-up to the end of verify (K9 stays at 0: the
    engine's commits are fixed-base, and K9 runs here only in the msm
    cross-check after the counts are read)."""
    import torch

    from vdf_tpu_torch import (
        NovaVDFProof,
        eval_and_make_circuits,
        msm,
        pallas_vdf,
        public_params,
    )
    from vdf_tpu_torch.curves import Point
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.fields import kernels as FK
    from vdf_tpu_torch.native import msm_native_affine
    from vdf_tpu_torch.nova import (
        InverseMinRootCircuit,
        R1CSInstance,
        RecursiveSNARK,
        RelaxedWitness,
        derive_generators,
    )
    from vdf_tpu_torch.utils import TEST_SEED, XorShiftRng, field_random

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    FK.reset_launches()
    CK.reset_launches()
    vdf = pallas_vdf()
    f = vdf.field
    p = f.params.modulus
    x = field_random(XorShiftRng(TEST_SEED), p)
    s0 = vdf.state_from_ints(x, 0, 1)
    if s0.x.device != torch.device("cuda", 0):
        raise SystemExit(f"engine: state_from_ints put the state on {s0.x.device}, not cuda:0")
    zi = list(s0)

    pp, shape_s = clock(lambda: public_params(t))
    shape = pp.dev_shape.shape
    nifs, key_s = clock(lambda: pp.nifs)
    ck, c = nifs.ck, nifs.curve
    _, table_s = clock(lambda: ck.table)
    (z0, circuits), eval_s = clock(lambda: eval_and_make_circuits(vdf, t, steps, s0))
    if tuple(f.decode(v) for v in z0) != _oracle(p, f.params.inv_alpha, (x, 0, 1), t * steps):
        raise SystemExit("engine: z0 differs from Python-int MinRoot")
    proof, prove_s = clock(lambda: NovaVDFProof.prove_recursively(pp, circuits, z0))
    ok, verify_s = clock(lambda: proof.verify(pp, steps, z0, zi))
    torch.cuda.synchronize()
    launches = {**FK.LAUNCHES, **CK.LAUNCHES}  # of set-up, eval, prove and verify alone
    if not ok:
        raise SystemExit("engine: proof.verify is False")
    # The split comes from a second, instrumented prove of the same circuits
    # (two synchronisations around each timed part); prove_s above is the
    # uninstrumented run's.
    split: dict = {}
    with _split_timers(split):
        again, split_prove_s = clock(lambda: NovaVDFProof.prove_recursively(pp, circuits, z0))
    if not (torch.equal(again.snark.W.w, proof.snark.W.w)
            and torch.equal(again.snark.W.e, proof.snark.W.e)):
        raise SystemExit("engine: the instrumented prove gave another folded witness")
    del again
    _log(f"engine: t={t}, {steps} steps: {shape.num_cons} constraints, key of {ck.n} "
         f"generators; proof verifies")

    snark = proof.snark

    def with_parts(**parts):
        fields = {"step_instances": snark.step_instances, "U": snark.U, "W": snark.W, **parts}
        return NovaVDFProof(RecursiveSNARK(**fields), proof.comm_ts)

    bad_in, bad_out = vdf.state_from_ints(123, 0, 1), vdf.state_from_ints(321, 0, 1)
    w_bad = snark.W.w.clone()
    w_bad[0, 0] ^= 1
    k = steps - 1
    x_bad = snark.step_instances[k].x.clone()
    x_bad[4] = f.add(x_bad[4], f.one())
    inst_bad = list(snark.step_instances)
    inst_bad[k] = R1CSInstance(inst_bad[k].comm_w, x_bad)
    rejected = {
        "wrong num_steps": proof.verify(pp, steps + 1, z0, zi),
        "wrong zi": proof.verify(pp, steps, z0, list(bad_in)),
        "wrong z0": proof.verify(pp, steps, list(bad_out), zi),
        "one changed limb of W.w": with_parts(
            W=RelaxedWitness(w_bad, snark.W.e)).verify(pp, steps, z0, zi),
        f"changed step_instances[{k}].x": with_parts(
            step_instances=inst_bad).verify(pp, steps, z0, zi),
    }
    for what, accepted in rejected.items():
        if accepted:
            raise SystemExit(f"engine: a proof with {what} verified")
    _log(f"engine: rejected {', '.join(rejected)}")

    # K9's path on the engine's own data: msm over the key's generators
    # equals the fixed-base commit, for each step's witness and for W.e.
    def gens_for(vec):
        return Point(*(v[: vec.shape[0]].contiguous() for v in ck.gens))

    for j, circ in enumerate(circuits):
        cs, _ = InverseMinRootCircuit(t).witness(f, list(circ.result))
        w = cs.witness()
        want = _affine(c, ck.commit(w))
        if want is None or _affine(c, msm(c, gens_for(w), w)) != want:
            raise SystemExit(f"engine: msm != ck.commit on step {j}'s witness")
        if _affine(c, snark.step_instances[j].comm_w) != want:
            raise SystemExit(f"engine: step {j}'s comm_w is not the commitment of its witness")
    if _affine(c, msm(c, gens_for(snark.W.e), snark.W.e)) != _affine(c, snark.U.comm_e):
        raise SystemExit("engine: msm on W.e != the folded comm_e")
    gens_aff = derive_generators(pp.curve_name, ck.n)
    (want, native_s) = clock(lambda: msm_native_affine(
        pp.curve_name, list(gens_aff[: shape.num_aux]), f.decode(snark.W.w)))
    if _affine(c, snark.U.comm_w) != want:
        raise SystemExit("engine: the folded comm_w != the native Pippenger on W.w")
    _log("engine: msm == ck.commit on each step's witness and on W.e; U.comm_w == native "
         "Pippenger on W.w")

    split = {k: v / steps for k, v in split.items()}
    split["other"] = split_prove_s / steps - sum(split.values())
    stats = {"t": t, "steps": steps, "constraints": shape.num_cons, "key_n": ck.n,
             "setup_s": shape_s + key_s + table_s, "shape_s": shape_s, "key_s": key_s,
             "table_s": table_s, "eval_s": eval_s, "prove_step_s": prove_s / steps,
             "instrumented_prove_step_s": split_prove_s / steps, "prove_step_split_s": split, "verify_s": verify_s, "native_s": native_s}
    _log("engine: " + json.dumps(stats))
    _log(f"engine: launches during the engine main path (set-up, eval, {steps} prove steps, "
         f"verify) {launches}")
    return stats, launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; nothing was run")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import vdf_tpu_torch  # noqa: F401  (fails where the package is absent)

    device = torch.device("cuda", 0)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    clock_hz = _sm_clock_hz()
    _log(f"bounds: {SMS} SMs x {INT32_LANES} int32 lanes x {clock_hz / 1e6:.0f} MHz "
         f"(nvidia-smi clocks.max.sm), {HBM_BYTES_PER_S / 1e12} TB/s")
    phase_build()
    kernel_stats = phase_kernels(device, CHECK_LANES, CHECK_T, LANES, clock_hz)
    main_stats = phase_main(device, LANES, T, T_APPEND)
    commit_kernel_stats = phase_commit_kernels(device, COMMIT_CHECK_N, COMMIT_N, clock_hz)
    _, commit_launches = phase_commit(device, COMMIT_N)
    msm_kernel_stats = phase_msm_kernels(device, MSM_CHECK_N, MSM_N, clock_hz)
    _, msm_launches = phase_msm(device, MSM_N, MSM_CHECK_N)
    _, engine_launches = phase_engine(ENGINE_T, ENGINE_STEPS)

    # Evidence: K1, K3-K7 and K9 were launched by the MSM and engine paths.
    moved = {k: msm_launches.get(k, 0) + engine_launches.get(k, 0) for k in engine_launches}
    for kname in ("minroot_eval", *COMMIT_KERNELS, "horner"):
        if moved[kname] <= 0:
            raise SystemExit(f"evidence: kernel {kname} was not launched by the MSM and "
                             f"engine main paths")
    _log(f"evidence: launches during the MSM and engine main paths {moved}")

    replaces = {
        "minroot_eval": "vdf_tpu/fields/pallas_field.py:273",
        "minroot_inverse": "vdf_tpu/fields/pallas_field.py:382",
    }

    def entry(name, source, replaced, launches, st, timed_at):
        # launches: in the main path that first drove the kernel; by_path
        # holds every path's own count.
        return {"name": name, "route": "cuda", "source": source, "replaces": replaced,
                "launches": next(n for n in launches.values() if n), "max_abs_err":
                st["max_abs_err"], "ms": st["ms"], "plain_ms": st["plain_ms"],
                "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
                "library_ms": st["library_ms"], "launches_by_path": launches,
                "timed_at": timed_at}

    msm_src = "vdf_tpu_torch/csrc/msm_kernels.cuh"
    kernels = [
        entry(name, "vdf_tpu_torch/csrc/minroot_kernels.cuh", replaces[name],
              {"minroot": main_stats["launches"][name], "engine": engine_launches[name]},
              st, {"lanes": st["lanes"], "t": st["t"], "field": "Fq"})
        for name, st in kernel_stats.items()
    ] + [
        entry(name, msm_src, COMMIT_KERNELS[name][1],
              {"commit": commit_launches[name], "msm": msm_launches[name],
               "engine": engine_launches[name]},
              st, {"n": COMMIT_N, "curve": "pallas", "batch": 1})
        for name, st in commit_kernel_stats.items()
    ] + [
        entry("horner", msm_src, "vdf_tpu/curves/pallas_msm.py:234",
              {"msm": msm_launches["horner"], "engine": engine_launches["horner"]},
              msm_kernel_stats["horner"], {"batch": 1, "curve": "pallas"}),
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
