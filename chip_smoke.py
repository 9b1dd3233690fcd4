#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py   # takes no options; needs one card

Main paths: MinRoot over Fq, t = 2^16 on 8,192 lanes; fixed-base commits at
n = 2^14; the variable-base MSM at n = 2^20; the single-curve Nova folding
engine at t = 1000 iterations a step, 2 steps; the two-curve Nova IVC at
t = 32 iterations a step, 8 steps, keys of 2^14 on Pallas and Vesta, and
its proof compressed (Spartan+IPA) and serialized.

Phases (any failure exits non-zero; nothing is caught):

  1. build   compile csrc/*.cu for sm_90a with nvcc and load them;
  2. kernels K1 (minroot_eval) and K2 (minroot_inverse) against their plain
             PyTorch versions on the card, on Fp and Fq, at 1,024 lanes of
             xorshift inputs (t = 4) and at the ragged lane counts 1, 33
             and 8,191 (t = 1): bit-for-bit equal on every lane; then, on
             Fq at the main path's 8,192 lanes, each kernel's time (K1 at
             t = 4, K2 at t = 64) beside its plain version's, the two
             outputs bit-for-bit equal on every lane; then each kernel's
             bound at the main shape (t = 2^16) with the multiplies a round
             it counts, beside one launch's time (K2's here; K1's launch at
             that shape is phase 3's eval, and its time is read there);
  3. main    pallas_vdf() -> Evaluation.eval(vdf, s0, t) -> proof.verify(s0)
             on CUDA tensors, a tampered proof that must fail, and a
             two-segment append that must verify; lanes 0, 1 and the last
             are checked against Python-int MinRoot;
  4. evidence the launch counters of both kernels moved during phase 3's
             eval -> verify (read before the tamper and append checks);
  5. commit kernels  K3 (canon_digits, canon_mont), K7 (shift_gens), K4
             (scan, in the form its wrapper picks and in each of its two
             forms), K5 (colscan) and K6 (bucket) against their plain
             versions on the card, on Pallas and Vesta at n = 256 (K = 2
             rows): every output element bit-for-bit equal; K7 in each of its
             two forms (a thread a generator, a group of 8 threads a
             generator) at n = 1, 127, 129, 4,096 and 2^14, the group form the
             same bits 20 launches over; K3 in each key width (int32 and
             int64) at n = 2^14, K = 1 and 2, also with padding after the
             items; K4 in each form on the int64 keys of the same data, the
             same bits as on the int32 keys; K5 and K6 again
             at the shapes that stress their structure (rows of one column,
             of a tile and one more, of a ragged last tile, of more tiles
             than one block scans at once, a head in every column and in
             none; a carry into no bucket and into every bucket, identity
             tails); then at the commit's main shape, n = 2^14, each
             kernel's time beside its plain version's, outputs again
             bit-for-bit equal, K4's and K7's time in each form (and the
             form each wrapper picks; K7 also at n = 4,096), each K4 form the
             same bits 20 launches over; torch.sort in each key width;
  6. commit  for Pallas and Vesta: commitment_key(curve, 2^14) (host
             derivation and K7 table timed apart), commit of xorshift
             scalars == the native C++ Pippenger in affine (Pallas; on Vesta
             == the variable-base msm over the same generators), the K = 2
             batch == two single commits, zero -> identity, e_0 -> G_0,
             (q - 1) e_{n-1} -> -G_{n-1}, one changed scalar changes the
             commitment; commit_fixed's canonical output agrees; wall and
             CUDA-event ms of a commit at K = 1 and K = 2, and the stages of
             one commit from events recorded between them;
  7. evidence the launch counters of K3-K7 moved during phase 6's key ->
             table -> first commit on each curve (read before the checks);
  8. MSM kernels  K9 (horner) against its plain version on Pallas and Vesta
             at B = 1 and B = 5, and K3's window-row layout, K4 (each form),
             K5, K6 in the variable-base shape (22 batch rows, one a window)
             against theirs at n = 2^12: bit for bit, K4 (each form), K5, K6
             and K9 the same bits 20 launches over; then on Pallas at n = 2^20
             K3 in each key width and K4 in each form on both widths against
             plain, torch.sort in each width, and
             each stage's time (K4's in each form, each the same bits 20
             launches over) beside its plain version's on the same
             tensors (K4's and K5's one window row at a time, to bound
             their temporaries), outputs bit for bit equal, and the 22 window
             sums == the native Pippenger on the base points with each
             window's digits summed by residue;
  9. MSM     msm(curve, points, scalars) on Pallas at n = 2^20 (1,024
             hash-derived base points repeated, scalars from numpy's
             default_rng(7)) == the native Pippenger on the 1,024 base points
             with the scalars summed by residue; at n = 2^12 on both curves
             == the native Pippenger; n = 1, n = 23 and a vector with P, -P,
             the identity, a repeat and zero scalars; wall and CUDA-event ms,
             and the stages of one msm from events recorded between them;
 10. engine  public_params(1000) -> eval_and_make_circuits(vdf, 1000, 2, s0)
             -> NovaVDFProof.prove_recursively -> proof.verify, all on the
             card with no device argument: verify is True; wrong num_steps,
             zi, z0, one changed limb of W.w and one changed step instance x
             are rejected; msm over the key's generators == ck.commit for
             each step's witness and for W.e; U.comm_w == the native
             Pippenger on W.w; set-up, prove and verify s, and the prove
             step's split by part from a second, instrumented prove;
             proof.compress(pp) -> CompressedVDFProof.verify True, with
             vW + 1 False, compress and verify s;
 11. evidence the launch counters of K1, K3-K7 and K9 moved during
             phase 9's one msm at n = 2^20 and phase 10's set-up -> eval ->
             prove -> verify (each read before the phase's other checks; K9
             runs on the msm path only);
 12. ivc     the statement and its proof, with no device argument anywhere:
             Evaluation.eval with K1 on one lane over t * 8 rounds from an
             xorshift start gives z0 (== Python-int MinRoot);
             ivc_public_params(32) (shapes, device matrices, keys from the
             host derivation phase 6 made, K7 tables: seconds printed apart);
             RecursiveIVC and 7 prove_steps, each timed between two
             synchronisations, proof(), ivc_verify True and z_N == the
             start; the witness handles are CUDA tensors; wrong num_steps,
             zn and z0, one changed limb of r_W_primary, one changed
             l_u_secondary.X and a swapped commitment are rejected; the
             native engine on the same (t, z0) gives, at 3 steps, the device
             engine's proof field by field (instances, z_i, every witness
             read back; that device run instrumented: each fold's parts
             between synchronisations); then folds/s of both engines (median
             of the 6 steps after the first, min and max), the device
             engine's split by phase a step and a fold's parts, beside the
             card's name and power limit; the launch
             counters of K1 and K3-K7 moved between the eval and the end of
             verify (read before the other checks);
 13. compress phase 12's device params and 8-step proof: each key with h
             appended (K7 on h), ivc_compress and ivc_verify_compressed True,
             each timed between two synchronisations; serialize_compressed
             -> bytes -> deserialize_compressed -> verify True and the same
             bytes again; the device engine's compress of the 3-step device
             proof byte-equal to the native engine's compress of the 3-step
             native proof, and as long as the 8-step one; wrong num_steps,
             a wrong zn, a changed sumcheck message, vW + 1 and a swapped
             IPA point rejected, a truncated blob refused; the launch
             counters of K3-K6 and K9 moved during h tables -> compress ->
             verify (read before the other checks); compress s, verify s,
             bytes and the split of an instrumented compress by part
             (ivc_compress's PhaseTimer spans: closing fold; a side's outer
             sumcheck, gamma-matvec, inner sumcheck, two IPAs) beside the
             card's name and power limit; then, on both curves at
             compression's shapes, bit for bit: the key-with-h table against
             K7's plain version over G ‖ h, a (2, 2^14 + 1) batch through
             K3-K6 against their plain versions (the commits also against
             commit_batch and the native Pippenger), and an msm over 29
             points through K3 (window rows), K4-K6 and K9 against their
             plain versions and the native Pippenger.

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
T = 1 << 16  # main-path rounds (BASELINE configs 1 and 4, uncut)
CHECK_LANES = 1024  # kernel-vs-plain lanes
CHECK_T = 4  # kernel-vs-plain rounds (the plain K1 costs ~0.3 s a round)
RAGGED_LANES = (1, 33, 8191)  # lane counts that fill no warp, one and a bit, all but one
RAGGED_T = 1  # kernel-vs-plain rounds at the ragged lane counts
T_APPEND = 1024  # rounds of the appended second segment
COMMIT_N = 1 << 14  # commit length: the bench IVC's (t = 32) _commit_pad, both curves
COMMIT_CHECK_N = 256  # kernel-vs-plain commit length
COMMIT_CURVES = ("pallas", "vesta")
COMMIT_NATIVE_CURVE = "pallas"  # the curve whose 2^14 commit the native Pippenger checks
MSM_N = 1 << 20  # variable-base MSM length (BASELINE config 5)
MSM_CHECK_N = 1 << 12  # kernel-vs-plain and native-check MSM length
MSM_BASE = 1024  # distinct base points of the MSM inputs, repeated to n
REPEATS = 20  # launches of K4-K6 and K9 on the same inputs that must agree bit for bit
ENGINE_T = 1000  # MinRoot iterations a Nova step (the reference sweep point)
ENGINE_STEPS = 2  # Nova steps
IVC_T = 32  # MinRoot iterations a step of the two-curve IVC (the bench IVC, bench.py:158)
IVC_STEPS = 8  # its steps (bench.py:158): base step + 7 prove steps
IVC_CHECK_STEPS = 3  # steps at which the device and native engines' proofs are compared

# The card's limits for each kernel's bound (the least time it could take):
# bytes over the memory rate, and 32-bit multiply-adds over the int32 instruction
# rate, SMS x INT32_LANES x the SM clock nvidia-smi reports as its maximum.
HBM_BYTES_PER_S = 3.35e12
SMS, INT32_LANES = 132, 64
# What a Montgomery product needs on 8 u32 limbs with the Pasta primes' shape
# (csrc/field.cuh): 64 wide multiply-adds of 32 x 32 -> 64 bits for a b (36
# for a squaring: the off-diagonal terms once, then the diagonal) and 24 for
# the reduction (three nonzero middle limbs of p a row), two int32
# dispatch slots each; additions and carries are left out, so the bound is a
# lower one.
MADS_PER_PRODUCT = 2 * (64 + 24)
MADS_PER_SQUARING = 2 * (36 + 24)
# (squarings, products) of a complete add and of a doubling (csrc/curve.cuh):
# 12 products an add, 2 squarings and 6 products a doubling; 3b a = 15 a is a
# small-constant multiply (a row of 8 multiplies and a subtraction), counted
# with the additions, which the bound leaves out.
PRODUCTS_ADD, PRODUCTS_DBL = (0, 12), (2, 6)

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


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


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


def _minroot_products(field_name: str, forward: bool) -> tuple[int, int]:
    """(squarings, products) of one MinRoot round a lane: the w = 4 windowed
    5th root (the table of 14 powers, 7 of them squarings; 4 squarings a
    digit after the first; one product a nonzero digit), or x^5 (2, 1)."""
    from vdf_tpu_torch.fields import FIELDS

    if not forward:
        return 2, 1
    digits = FIELDS[field_name].inv_alpha_digits
    return 7 + 4 * (len(digits) - 1), 7 + sum(1 for d in digits[1:] if d)


def _point_ops(adds: int, doublings: int) -> tuple[int, int]:
    return (adds * PRODUCTS_ADD[0] + doublings * PRODUCTS_DBL[0],
            adds * PRODUCTS_ADD[1] + doublings * PRODUCTS_DBL[1])


def _kernel_products(kname: str, args, out) -> tuple[int, int]:
    """(squarings, products) in Montgomery form that the kernel's function
    needs on these inputs (data-dependent kernels count what this data
    needs)."""
    from vdf_tpu_torch.curves import kernels as CK

    if kname in ("minroot_eval", "minroot_inverse"):
        field_name, x, _, _, t = args
        squarings, products = _minroot_products(field_name, kname == "minroot_eval")
        return squarings * x.shape[0] * t, products * x.shape[0] * t
    if kname == "canon_digits":
        return 0, args[1].shape[0] * args[1].shape[1]
    if kname == "canon_mont":
        return 0, args[1].shape[0]
    if kname == "shift_gens":
        return _point_ops(0, args[1].shape[0] * (CK.WINDOWS - 1) * CK.WINDOW_BITS)
    if kname == "scan":  # one add an item that continues a run inside its column
        keys, rows = args[2], args[3]
        d = CK.key_digit(keys).reshape(keys.shape[0], -1, rows)
        return _point_ops(int((d[:, :, 1:] == d[:, :, :-1]).sum().item()), 0)
    if kname == "colscan":  # one add a column after the first that holds no run's head
        return _point_ops(int((args[2][:, 1:] == 0).sum().item()), 0)
    if kname == "bucket":  # carries; 4,094 pair sums, 4,083 adds in the O_j trees; the Horner
        k = args[1].shape[0]
        adds = int((args[2] >= 0).sum().item()) + k * (4094 + 4083 + 11)
        return _point_ops(adds, k * 11)
    if kname == "horner":
        b = args[1].shape[0]
        return _point_ops(b * CK.WINDOWS, b * CK.WINDOWS * CK.WINDOW_BITS)
    raise SystemExit(f"no operation count for kernel {kname}")


def _bound(kname: str, args, out, clock_hz: float) -> dict:
    """The least time the card could take for this call: each input read
    once and each output written once at the memory rate, or the function's
    multiply-adds at the int32 instruction rate, whichever is larger."""
    nbytes = _tensor_bytes(args, out)
    squarings, products = _kernel_products(kname, args, out)
    mads = squarings * MADS_PER_SQUARING + products * MADS_PER_PRODUCT
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


def phase_kernels(device, lanes: int, t: int, timing_lanes: int, main_t: int,
                  clock_hz: float) -> dict:
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
        for n, rounds in ((lanes, t), *((n, RAGGED_T) for n in RAGGED_LANES)):
            s = [f.encode(_xorshift_ints(n, p, rng), device) for _ in range(3)]
            fwd = minroot_eval(name, *s, rounds)
            fwd_plain = minroot_eval_plain(name, *s, rounds)
            back = minroot_inverse(name, *fwd, rounds)
            back_plain = minroot_inverse_plain(name, *fwd, rounds)
            torch.cuda.synchronize()
            _require_equal("minroot_eval", name, fwd, fwd_plain, err)
            _require_equal("minroot_inverse", name, back, back_plain, err)
            if not all(torch.equal(a, b) for a, b in zip(back, s)):
                raise SystemExit(f"inverse(eval(s)) != s on {name} at {n} lanes")
            _log(f"kernels: {name} K1/K2 == plain on {n} lanes at t={rounds}, round trip ok")

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

    # The main shape: each kernel's bound there, and one launch of K2 (warm)
    # between two events.  K1's one launch at this shape is phase 3's eval,
    # timed there between two events: main() copies that time in.  No plain
    # version runs this many rounds.
    for kname in ("minroot_eval", "minroot_inverse"):
        ms = None
        if kname == "minroot_inverse":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            minroot_inverse("Fq", *state, main_t)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        bound = _bound(kname, ("Fq", *state, main_t), state, clock_hz)
        squarings, products = _minroot_products("Fq", kname == "minroot_eval")
        times[kname]["main_shape"] = {
            "lanes": timing_lanes, "t": main_t, "ms": ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "squarings_per_round": squarings, "products_per_round": products,
            "multiply_adds_per_round": squarings * MADS_PER_SQUARING
            + products * MADS_PER_PRODUCT,
        }
        _log(f"timing: {kname} Fq at the main shape: " + json.dumps(times[kname]["main_shape"]))
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


def _generators(curve_name: str, n: int, device):
    """n generators: the points of a small hash-derived set, repeated to n,
    as affine ints and as (n, 3, 8) on the device."""
    from vdf_tpu_torch.curves import get_curve, hash_to_curve_ints, stack_point

    base = hash_to_curve_ints(curve_name, min(n, COMMIT_CHECK_N), domain=b"vdf_tpu/t")
    aff = [base[i % len(base)] for i in range(n)]
    return aff, stack_point(get_curve(curve_name).from_affine_ints(aff, device)).contiguous()


def _commit_inputs(curve_name: str, n: int, k: int, device):
    """Inputs of the commit kernels at length n: the points of a small
    hash-derived set, repeated to n, as generators (n, 3, 8) and as
    canonical x-coordinate integers (K3 mode 1's input); k rows of
    xorshift scalars holding 0, 1, q - 1 and a run of n/4 equal values
    (runs that cross columns); their window-digit keys, and those sorted."""
    import numpy as np
    import torch

    from vdf_tpu_torch.curves import get_curve
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.curves.bucket_msm import layout
    from vdf_tpu_torch.utils import TEST_SEED, XorShiftRng

    c = get_curve(curve_name)
    aff, gens = _generators(curve_name, n, device)
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


def _scan_launch(a, form: str, res=None):
    """K4 in ``form`` (one of curves.kernels.SCAN_FORMS) on the arguments
    ``a`` of bucket_scan, through its C launcher: the wrapper launches only
    the form it picks (scan_form).  Writes into ``res`` (the four outputs as
    bucket_scan makes them), fresh ones by default, and returns them."""
    import torch

    from vdf_tpu_torch import _build
    from vdf_tpu_torch.curves import kernels as CK

    bf, table, keys, rows = a
    (batch, m_pad), dev = keys.shape, keys.device
    cols = m_pad // rows
    if res is None:
        res = (CK._identity_rows(bf, (batch, CK.NB), dev),
               torch.full((batch, CK.NB), -1, dtype=torch.int32, device=dev),
               torch.empty((batch, cols, 3, 8), dtype=torch.int32, device=dev),
               torch.empty((batch, cols), dtype=torch.int32, device=dev))
    if _build.load_kernels().lib.vdf_scan(
            _build.FIELD_INDEX[bf], table.data_ptr(), keys.data_ptr(),
            *(x.data_ptr() for x in res), m_pad, rows, cols, batch, CK.SCAN_FORMS.index(form),
            CK.key_bits_of(keys), torch.cuda.current_stream().cuda_stream):
        raise SystemExit(f"scan: the {form} form's launch failed")
    return res


def _scan_forms(a, want, where: str, err: dict, repeats: int = 0) -> None:
    """K4 in each of its forms on the arguments ``a`` == ``want`` (the plain
    version's result), bit for bit; with ``repeats``, each form gives the same
    bits that many launches over, into fresh outputs (a group's lanes race
    only on the card)."""
    import torch

    from vdf_tpu_torch.curves import kernels as CK

    for form in CK.SCAN_FORMS:
        got = _scan_launch(a, form)
        torch.cuda.synchronize()
        _require_same("scan", f"{where} ({form} form)", got, want, err)
        for _ in range(repeats):
            if not all(torch.equal(x, y) for x, y in zip(_scan_launch(a, form), got)):
                raise SystemExit(f"scan {where} ({form} form): two launches on the same inputs "
                                 f"gave different outputs")


def _scan_form_times(a, want, where: str, err: dict) -> dict:
    """Each K4 form's device ms on the arguments ``a`` (mean of 5 launches
    through the C launcher: at the commit's shape the wrapper's host time
    exceeds the kernel's), its output held against ``want``; logs the form
    the wrapper picks there."""
    from vdf_tpu_torch.curves import kernels as CK

    _, _, keys, rows = a
    out = {"chosen": CK.scan_form(keys.shape[0] * (keys.shape[1] // rows), rows, keys.device)}
    for form in CK.SCAN_FORMS:
        res = _scan_launch(a, form)
        out[form], got = _cuda_ms(_scan_launch, (a, form, res), reps=5)
        _require_same("scan", f"{where} ({form} form, launcher)", got, want, err)
    _log(f"timing: scan {where}, device ms through the launcher: thread form "
         f"{out['thread']:.4f}, group form (8 threads a column) {out['group']:.4f}; the "
         f"wrapper picks the {out['chosen']} form here")
    return out


def _keys64(keys):
    """The int64 keys of the same (digit, item) pairs as ``keys``."""
    from vdf_tpu_torch.curves import kernels as CK

    return CK.make_keys(CK.key_digit(keys), CK.key_item(keys), 64)


def _scan_widths(a, want, where: str, err: dict) -> None:
    """K4 in each form on the int64 keys of the data of ``a`` (whose keys are
    int32) == ``want``, the result on the int32 keys, bit for bit."""
    import torch

    from vdf_tpu_torch.curves import kernels as CK

    bf, table, keys, rows = a
    if keys.dtype != torch.int32:
        raise SystemExit(f"scan {where}: expected the int32 keys the wrapper makes here")
    wide = (bf, table, _keys64(keys), rows)
    for form in CK.SCAN_FORMS:
        got = _scan_launch(wide, form)
        torch.cuda.synchronize()
        _require_same("scan", f"{where} ({form} form, int64 keys)", got, want, err)


def _digits_widths(sf: str, scalars, m_pad: int, window_rows: bool, where: str,
                   err: dict) -> dict:
    """K3 mode 0 in each key width == its plain version, bit for bit, every
    position (the padding the kernel writes too); torch.sort of each width's
    keys timed (mean of 5), the two sorted sequences the same pairs.
    Returns {key_bits: sort ms}."""
    import torch

    from vdf_tpu_torch.curves import kernels as CK

    sort_ms, pairs = {}, []
    for bits in (32, 64):
        got = CK.canon_digits(sf, scalars, m_pad, window_rows, key_bits=bits)
        want = CK.canon_digits_plain(sf, scalars, m_pad, window_rows, key_bits=bits)
        torch.cuda.synchronize()
        if got.dtype != CK.KEY_DTYPES[bits]:
            raise SystemExit(f"canon_digits {where}: {bits}-bit keys came as {got.dtype}")
        _require_same("canon_digits", f"{where} ({bits}-bit keys)", got, want, err)
        rows = got.reshape(-1, m_pad)
        sort_ms[bits], out = _cuda_ms(lambda k: torch.sort(k, dim=-1).values, (rows,), reps=5)
        pairs.append((CK.key_digit(out), CK.key_item(out)))
        del got, want, rows, out
    if not all(torch.equal(x, y) for x, y in zip(*pairs)):
        raise SystemExit(f"torch.sort {where}: the int32 and int64 keys sort differently")
    _log(f"commit kernels: canon_digits {where} == plain in both key widths, every position; "
         f"torch.sort ms: int32 {sort_ms[32]:.4f}, int64 {sort_ms[64]:.4f}")
    return sort_ms


def _shift_launch(bf: str, gens, form: str, out=None):
    """K7 in ``form`` (one of curves.kernels.SHIFT_FORMS) through its C
    launcher (the wrapper launches only the form shift_form picks), into
    ``out`` (fresh by default); returns the table."""
    import torch

    from vdf_tpu_torch import _build
    from vdf_tpu_torch.curves import kernels as CK

    n = gens.shape[0]
    if out is None:
        out = torch.empty((CK.WINDOWS * n, 3, 8), dtype=torch.int32, device=gens.device)
    if _build.load_kernels().lib.vdf_shift_gens(
            _build.FIELD_INDEX[bf], gens.data_ptr(), out.data_ptr(), n,
            CK.SHIFT_FORMS.index(form), torch.cuda.current_stream().cuda_stream):
        raise SystemExit(f"shift_gens: the {form} form's launch failed")
    return out


SHIFT_CHECK_N = (1, 127, 129, 4096, 1 << 14)  # K7 against plain in both forms
SHIFT_TIMED_N = (4096, 1 << 14)  # the engine's key, a commit's


def _shift_forms(device, err: dict) -> dict:
    """K7 in each form == plain, bit for bit, at SHIFT_CHECK_N on both curves
    (the generators of _generators); the group form the same bits REPEATS
    launches over at the timed lengths; each form's device ms there (mean of
    5 launches through the launcher) on Pallas, and the form the wrapper
    picks."""
    import torch

    from vdf_tpu_torch.curves import CURVES
    from vdf_tpu_torch.curves import kernels as CK

    times = {}
    for curve_name in COMMIT_CURVES:
        bf = CURVES[curve_name].base_field
        for n in SHIFT_CHECK_N:
            gens = _generators(curve_name, n, device)[1]
            want = CK.shift_gens_plain(bf, gens)
            for form in CK.SHIFT_FORMS:
                got = _shift_launch(bf, gens, form)
                torch.cuda.synchronize()
                _require_same("shift_gens", f"on {curve_name} at n={n} ({form} form)", got, want,
                              err)
            if n not in SHIFT_TIMED_N:
                continue
            for _ in range(REPEATS):
                if not torch.equal(_shift_launch(bf, gens, "group"), want):
                    raise SystemExit(f"shift_gens on {curve_name} at n={n} (group form): two "
                                     f"launches on the same inputs gave different outputs")
            if curve_name == "pallas":
                out = {"chosen": CK.shift_form(n, device)}
                for form in CK.SHIFT_FORMS:
                    res = _shift_launch(bf, gens, form)
                    out[form], _ = _cuda_ms(_shift_launch, (bf, gens, form, res), reps=5)
                times[f"n={n}"] = out
                _log(f"timing: shift_gens on pallas at n={n}, device ms through the launcher: "
                     f"thread form {out['thread']:.4f}, group form {out['group']:.4f}; the "
                     f"wrapper picks the {out['chosen']} form here")
        _log(f"commit kernels: {curve_name} K7 == plain in both forms at n={SHIFT_CHECK_N}, bit "
             f"for bit; the group form the same bits {REPEATS} launches over at {SHIFT_TIMED_N}")
    return times


# K5 at the shapes that stress its tiles: (batch rows, columns, share of columns
# that hold a run's head; column 0 always does unless the share is 0).  A tile
# is 128 columns up to 16,384 columns a row and 512 beyond.
CARRY_EDGE_SHAPES = (
    (2, 1, 0.3), (2, 129, 0.3), (2, 300, 0.3), (2, 300, 1.0), (2, 300, 0.0),  # tiles of 128
    (2, 16385, 0.05), (1, 34 * 512 + 1, 1.0), (1, 20000, 0.0),  # tiles of 512
    (1, 130 * 512 + 3, 0.0005),  # more tiles a row than one block scans at once
)


def _edge_checks(curve_name: str, table, device, err: dict) -> None:
    """K5 and K6 against their plain versions, bit for bit, on inputs made
    for the edges of their structure: rows of one column, of a tile and one
    more, of a ragged last tile, with a head in every column or in none; K6
    with a carry into no bucket, into every bucket, and with identity tails."""
    import numpy as np
    import torch

    from vdf_tpu_torch.curves import CURVES
    from vdf_tpu_torch.curves import kernels as CK

    bf = CURVES[curve_name].base_field
    rng = np.random.default_rng(5)

    def points(*shape):
        idx = torch.from_numpy(rng.integers(0, table.shape[0], size=shape)).to(device)
        return table[idx].contiguous()

    for k, cols, share in CARRY_EDGE_SHAPES:
        flags = torch.from_numpy((rng.random((k, cols)) < share).astype(np.int32)).to(device)
        if share:
            flags[:, 0] = 1
        sums = points(k, cols)
        got, want = CK.column_carries(bf, sums, flags), CK.column_carries_plain(bf, sums, flags)
        torch.cuda.synchronize()
        _require_same("colscan", f"on {curve_name} at {k} x {cols} columns, heads in "
                      f"{share:.2%}", got, want, err)
    cols = 7
    for carried, identity_tails in (("none", False), ("all", False), ("some", True)):
        tails = CK._identity_rows(bf, (2, CK.NB), device) if identity_tails else points(2, CK.NB)
        tail_col = torch.from_numpy(rng.integers(0, cols, size=(2, CK.NB)).astype(np.int32))
        if carried == "none":
            tail_col[:] = -1
        elif carried == "some":
            tail_col[torch.from_numpy(rng.random((2, CK.NB)) < 0.5)] = -1
        a = (bf, tails, tail_col.to(device), points(2, cols))
        got, want = CK.bucket_sums(*a), CK.bucket_sums_plain(*a)
        torch.cuda.synchronize()
        _require_same("bucket", f"on {curve_name} with a carry into {carried} buckets"
                      f"{', identity tails' if identity_tails else ''}", got, want, err)
    _log(f"commit kernels: {curve_name} K5 == plain at {len(CARRY_EDGE_SHAPES)} edge shapes "
         f"(1 to {max(c for _, c, _ in CARRY_EDGE_SHAPES)} columns), K6 == plain with a carry "
         f"into no bucket, into every bucket, and with identity tails, bit for bit")


def phase_commit_kernels(device, check_n: int, n: int, clock_hz: float) -> dict:
    """K3-K7 vs plain, bit for bit, on both curves at check_n (K = 2
    rows), K5 and K6 at their edge shapes, then K3-K7 at n (K = 1) with
    times; returns per-kernel error and the Pallas times at n."""
    import torch

    from vdf_tpu_torch.curves import CURVES
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
            if kname == "scan":
                _scan_forms(args[kname], want, f"on {curve_name} at n={check_n}", err)
        _log(f"commit kernels: {curve_name} K3-K7 == plain at n={check_n}, K=2, bit for bit "
             f"(K4 in each form)")
        _edge_checks(curve_name, CK.shift_gens(*args["shift_gens"]), device, err)
    shift_forms = _shift_forms(device, err)

    sort_ms = {}
    for curve_name in COMMIT_CURVES:
        sf = CURVES[curve_name].scalar_field
        for k in (1, 2):
            _, _, s, keys, _ = _commit_inputs(curve_name, n, k, device)
            for m_pad in (keys.shape[1], keys.shape[1] + 5):  # the layout's, and with padding
                where = f"on {curve_name} at n={n}, K={k}, m_pad={m_pad}"
                ms = _digits_widths(sf, s, m_pad, False, where, err)
                if curve_name == "pallas" and m_pad == keys.shape[1]:
                    sort_ms[f"commit K={k}"] = ms
        gens, ints, s, keys, sorted_keys = _commit_inputs(curve_name, n, 1, device)
        args = _commit_stage_args(curve_name, gens, ints, s, sorted_keys)
        for kname, (fn, _) in COMMIT_KERNELS.items():
            ms, got = _cuda_ms(getattr(CK, fn), args[kname], reps=5)
            plain_ms, want = _cuda_ms(getattr(CK, fn + "_plain"), args[kname], reps=1)
            _require_same(kname, f"on {curve_name} at n={n}", got, want, err)
            bound = _bound(kname, args[kname], got, clock_hz)
            _log(f"timing: {kname} {curve_name} n={n}: kernel {ms:.4f} ms, plain "
                 f"{plain_ms:.4f} ms, bound {bound['bound_ms']:.6f} ms ({bound['bound_by']}); "
                 f"== plain, bit for bit")
            extra = {}
            if kname == "scan":
                where = f"on {curve_name} at n={n}"
                extra["forms"] = _scan_form_times(args[kname], want, where, err)
                _scan_forms(args[kname], want, where, err, repeats=REPEATS)
                _scan_widths(args[kname], want, where, err)
            if kname == "shift_gens":
                extra["forms"] = shift_forms
            if kname == "canon_digits":
                extra["key_bits"] = CK.key_bits_of(got)
                extra["sort_ms"] = sort_ms
            if curve_name == "pallas":
                times[kname] = {"ms": ms, "plain_ms": plain_ms, **bound, **extra}
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


def _stage_split(stages, reps: int = 5):
    """Mean device milliseconds of each stage of a pipeline, from CUDA events
    recorded between the stages of reps back-to-back passes (after one
    warm-up pass), and the last pass's result.  ``stages`` are (name, fn)
    pairs, each fn taking the result of the stage before it.  A stage's time
    runs from the end of the stage before it, so the stages add up to the
    passes' whole time, waits for the host included."""
    import torch

    def one_pass(events):
        out = None
        for (_, fn), event in zip(stages, events[1:]):
            out = fn(out)
            event.record()
        return out

    def new_events():
        return [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]

    one_pass(new_events())
    torch.cuda.synchronize()
    passes = [new_events() for _ in range(reps)]
    for events in passes:
        events[0].record()
        out = one_pass(events)
    torch.cuda.synchronize()
    split = {name: sum(ev[j].elapsed_time(ev[j + 1]) for ev in passes) / reps
             for j, (name, _) in enumerate(stages)}
    return split, out


def _accumulation_stages(curve_name: str, table, scalars, items: int, window_rows: bool):
    """The stages of one bucket accumulation as curves/bucket_msm.py and
    curves/msm.py run them: K3 keys, the sort, K4, K5, K6."""
    import torch

    from vdf_tpu_torch.curves import CURVES
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.curves.bucket_msm import ROWS

    bf, sf = CURVES[curve_name].base_field, CURVES[curve_name].scalar_field
    m_pad = -(-items // ROWS) * ROWS

    def keys(_):
        out = CK.canon_digits(sf, scalars, m_pad, window_rows)
        return out[0] if window_rows else out

    return [
        ("canon_digits", keys),
        ("sort", lambda k: torch.sort(k, dim=-1).values),
        ("scan", lambda k: CK.bucket_scan(bf, table, k, ROWS)),
        ("colscan", lambda r: (r[0], r[1], CK.column_carries(bf, r[2], r[3]))),
        ("bucket", lambda r: CK.bucket_sums(bf, *r)),
    ]


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
        split, staged = _stage_split(
            _accumulation_stages(name, table, s[None].contiguous(), CK.WINDOWS * n, False))
        if not torch.equal(staged[0], stack_point(pt)):
            raise SystemExit(f"commit: {name} the staged pass gave another commitment")
        _log(f"commit: {name} n={n} stages of one commit (events between the stages, mean of "
             f"5 passes), ms: " + json.dumps(split) + f"; sum {sum(split.values()):.4f}")
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
        # Blocks race only on the card: K5's and K6's many blocks a row, and
        # the lanes of K4's and K9's groups, must give the same bits however
        # they interleave.
        for kname, a in (("colscan", args["colscan"]), ("bucket", args["bucket"]),
                         ("horner", (bf, rows))):
            fn = getattr(CK, COMMIT_KERNELS[kname][0] if kname in COMMIT_KERNELS else kname)
            first = fn(*a)
            for _ in range(REPEATS):
                if not torch.equal(fn(*a), first):
                    raise SystemExit(f"{kname} on {curve_name} at n={check_n}, 22 rows: two "
                                     f"launches on the same inputs gave different outputs")
        scan_want = CK.bucket_scan_plain(*args["scan"])
        where = f"on {curve_name} at n={check_n}, variable base"
        _scan_forms(args["scan"], scan_want, where, err, repeats=REPEATS)
        _scan_widths(args["scan"], scan_want, where, err)
        _log(f"msm kernels: {curve_name} K9 == plain at B=1 and 5; K3 (window rows), K4 (each "
             f"form), K5, K6, K9 == plain at n={check_n} (22 rows), bit for bit; K4 (each "
             f"form), K5, K6 and K9 the same bits {REPEATS} launches over")

    base_aff, pts, scalars, _ = _msm_inputs("pallas", n, device)
    args, keys = _msm_stage_args("pallas", pts, scalars)
    stages = {}
    sf = CURVES["pallas"].scalar_field
    sort_ms = _digits_widths(sf, scalars[None], keys.shape[1], True,
                             f"on pallas at n={n}, window rows", err)
    stages["sort"] = {"ms": sort_ms[CK.key_bits_of(keys)], "by_key_bits": sort_ms}
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
        if kname == "scan":
            where = f"on pallas at n={n}, variable base"
            stages[kname]["forms"] = _scan_form_times(a, want, where, err)
            _scan_forms(a, want, where, err, repeats=REPEATS)
            _scan_widths(a, want, where, err)
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
    digit_sums.scatter_add_(1, CK.key_item(keys) % len(base_aff), CK.key_digit(keys))
    for w, (s_w, coeffs) in enumerate(zip(args["horner"][1][0], digit_sums.tolist())):
        if _affine(c, s_w) != msm_native_affine("pallas", list(base_aff), coeffs):
            raise SystemExit(f"msm kernels: window sum {w} at n={n} != the native Pippenger on "
                             f"the base points with the window's summed digits")
    _log(f"msm kernels: all {CK.WINDOWS} window sums at n={n} == the native Pippenger on the "
         f"{len(base_aff)} base points with the summed digits")
    del args, keys
    torch.cuda.empty_cache()
    return {"horner": {"max_abs_err": err["horner"], **stages["horner"]}, "stages": stages,
            "scan_err": err["scan"], "canon_digits_err": err["canon_digits"]}


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
    from vdf_tpu_torch.curves import Point, get_curve, get_int_curve, stack_point, unstack_point
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
    bf = c.params.base_field
    split, staged = _stage_split(
        _accumulation_stages("pallas", pts, scalars[None], n, True)
        + [("horner", lambda sums: CK.horner(bf, sums[None]))], reps=3)
    if not torch.equal(staged[0], stack_point(total)):
        raise SystemExit("msm: the staged pass gave another sum")
    _log(f"msm: pallas n={n} stages of one msm (events between the stages, mean of 3 passes), "
         f"ms: " + json.dumps(split) + f"; sum {sum(split.values()):.4f}")
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
    cross-check and the compressed proof's check after the counts are
    read)."""
    import dataclasses

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

    # The final witness compressed away: a Spartan argument in its place.
    cproof, compress_s = clock(lambda: proof.compress(pp))
    cok, cverify_s = clock(lambda: cproof.verify(pp, steps, z0, zi))
    if not cok:
        raise SystemExit("engine: the compressed proof does not verify")
    sp = cproof.spartan
    if dataclasses.replace(cproof, spartan=sp._replace(vW=f.add(sp.vW, f.one()))).verify(
            pp, steps, z0, zi):
        raise SystemExit("engine: a compressed proof with vW + 1 verified")
    _log(f"engine: proof.compress {compress_s:.3f} s, CompressedVDFProof.verify {cverify_s:.3f} "
         f"s (True); with vW + 1 rejected")

    split = {k: v / steps for k, v in split.items()}
    split["other"] = split_prove_s / steps - sum(split.values())
    stats = {"t": t, "steps": steps, "constraints": shape.num_cons, "key_n": ck.n,
             "setup_s": shape_s + key_s + table_s, "shape_s": shape_s, "key_s": key_s,
             "table_s": table_s, "eval_s": eval_s, "prove_step_s": prove_s / steps,
             "instrumented_prove_step_s": split_prove_s / steps, "prove_step_split_s": split,
             "verify_s": verify_s, "native_s": native_s, "compress_s": compress_s,
             "compressed_verify_s": cverify_s}
    _log("engine: " + json.dumps(stats))
    _log(f"engine: launches during the engine main path (set-up, eval, {steps} prove steps, "
         f"verify) {launches}")
    return stats, launches



def _median(xs):
    ys = sorted(xs)
    m = len(ys) // 2
    return ys[m] if len(ys) % 2 else (ys[m - 1] + ys[m]) / 2


def _prove_timed(pp, z0: list, steps: int, snapshot_at: int | None = None):
    """RecursiveIVC(pp, z0) and steps - 1 prove_steps, each between two
    synchronisations; the prover's phase split over every step after the
    first.  Returns (prover, base s, [s a step], split, kernel launches a
    prove step, proof at ``snapshot_at`` steps or None)."""
    import torch

    from vdf_tpu_torch import RecursiveIVC
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.fields import kernels as FK

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prover = RecursiveIVC(pp, z0)
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t0
    step_s, snap = [], None
    before = {**FK.LAUNCHES, **CK.LAUNCHES}
    for k in range(steps - 1):
        if k == 1:  # the split covers the timed steps, after the first
            prover.timer = type(prover.timer)(prover.timer.sync)
        t0 = time.perf_counter()
        prover.prove_step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if snapshot_at is not None and prover.i == snapshot_at:
            snap = prover.proof()  # the native engine's proof() changes no prover state
    per_step = {k: (v - before[k]) / (steps - 1) for k, v in {**FK.LAUNCHES,
                                                             **CK.LAUNCHES}.items()}
    timed = step_s[1:]
    split = {name: secs / len(timed) for name, secs in prover.timer.totals.items()}
    split["other"] = sum(timed) / len(timed) - sum(split.values())
    return prover, base_s, step_s, split, per_step, snap


# The device engine's fold, split: fold_cached's own parts and, inside the
# fused pass, its four parts.  The seeding of the product cache (the first
# primary fold) counts in "fold other".
FOLD_PARTS = {"encode x, u, r": ("Field", "encode"), "fused pass": ("Side", "_fold_strict"),
              "challenge": ("ivc", "fold_challenge"), "instance fold": ("Side", "fold_instance"),
              "witness fold": ("Side", "_wfoldp")}
FUSED_PARTS = {"lift (K3)": ("Side", "_lift"), "matvecs + cross term": ("Side", "_cross"),
               "K = 2 commit": ("CommitmentKey", "commit_batch"),
               "read + affine": ("Side", "_affine_of")}


@contextlib.contextmanager
def _fold_timers(acc: dict):
    """While inside, each fold_cached call and, within it, each outermost
    part of FOLD_PARTS and each outermost part of FUSED_PARTS inside the
    fused pass run between two synchronisations and add their host seconds
    to ``acc``.  The same functions called anywhere else run untimed."""
    import torch

    from vdf_tpu_torch.fields import Field
    from vdf_tpu_torch.nova import CommitmentKey, ivc
    from vdf_tpu_torch.nova.ivc import Side

    owners = {"Field": Field, "Side": Side, "CommitmentKey": CommitmentKey, "ivc": ivc}
    active = []  # the parts running now, outermost first
    saved = []

    def wrap(owner, name, part, counts):
        fn = getattr(owner, name)

        def timed(*args, _fn=fn, **kwargs):
            if not counts():
                return _fn(*args, **kwargs)
            torch.cuda.synchronize()
            active.append(part)
            t0 = time.perf_counter()
            try:
                out = _fn(*args, **kwargs)
                torch.cuda.synchronize()
            finally:
                active.pop()
            acc[part] = acc.get(part, 0.0) + time.perf_counter() - t0
            return out

        saved.append((owner, name, fn))
        setattr(owner, name, timed)

    wrap(Side, "fold_cached", "fold", lambda: not active)
    for part, (owner, name) in FOLD_PARTS.items():
        wrap(owners[owner], name, part, lambda: active == ["fold"])
    for part, (owner, name) in FUSED_PARTS.items():
        wrap(owners[owner], name, part, lambda: active == ["fold", "fused pass"])
    try:
        yield
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def _rates(step_s: list) -> dict:
    """folds/s (one prove step folds one instance on each curve; bench.py's
    unit) over the timed steps, every step after the first."""
    timed = step_s[1:]
    return {"folds_per_s_median": 1 / _median(timed), "folds_per_s_min": 1 / max(timed),
            "folds_per_s_max": 1 / min(timed), "step_s_median": _median(timed),
            "timed_steps": len(timed), "first_step_s": step_s[0]}


def phase_ivc(t: int, steps: int, check_steps: int, card: str) -> tuple[dict, dict, dict]:
    """The two-curve Nova IVC through its entry points with no device
    argument anywhere: the statement's eval (K1, one lane, t * steps
    rounds), ivc_public_params(t), RecursiveIVC and steps - 1 prove_steps,
    proof(), ivc_verify; tamper cases; the native engine's proof on the same
    (t, z0) equal instance for instance and witness for witness at
    check_steps steps.  Returns stats, the launch counts of K1/K2 and
    K3-K9 from the eval to the end of verify, and the proofs for phase 13."""
    import dataclasses

    import torch

    from vdf_tpu_torch import (
        Evaluation,
        IVCProof,
        RecursiveIVC,
        ivc_public_params,
        ivc_verify,
        pallas_vdf,
    )
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.fields import kernels as FK
    from vdf_tpu_torch.nova import pedersen
    from vdf_tpu_torch.utils import TEST_SEED, XorShiftRng, field_random

    vdf = pallas_vdf()
    f = vdf.field
    p = f.params.modulus
    x0 = field_random(XorShiftRng(TEST_SEED), p)
    start = [x0, 0, 1]
    # Phase 6's keys share the host derivation (derive_generators, cached);
    # their device form and K7 table are made again, inside this path.
    pedersen._key.cache_clear()

    FK.reset_launches()
    CK.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s0 = vdf.state_from_ints([x0], [0], [1])
    z0_t, _ = Evaluation.eval(vdf, s0, t * steps)
    z0 = [f.decode(v)[0] for v in z0_t]
    eval_s = time.perf_counter() - t0
    if tuple(z0) != _oracle(p, f.params.inv_alpha, tuple(start), t * steps):
        raise SystemExit("ivc: the statement's z0 differs from Python-int MinRoot")

    setup = {}
    t0 = time.perf_counter()
    pp = ivc_public_params(t)
    setup["shapes_s"] = time.perf_counter() - t0
    for name, side in (("primary", pp.primary), ("secondary", pp.secondary)):
        for part, get in (("dev_shape", lambda: side.dev_shape), ("key", lambda: side.ck),
                          ("table", lambda: side.ck.table)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            get()
            torch.cuda.synchronize()
            setup[f"{name}_{part}_s"] = time.perf_counter() - t0
    if pp.primary.ck.n != COMMIT_N or pp.secondary.ck.n != COMMIT_N:
        raise SystemExit(f"ivc: keys of {pp.primary.ck.n} and {pp.secondary.ck.n}, not {COMMIT_N}")

    prover, base_s, step_s, split, per_step, _ = _prove_timed(pp, z0, steps)
    t0 = time.perf_counter()
    proof = prover.proof()
    ok = ivc_verify(pp, proof, steps, z0, start)
    torch.cuda.synchronize()
    verify_s = time.perf_counter() - t0
    launches = {**FK.LAUNCHES, **CK.LAUNCHES}  # of eval, set-up, prove and verify alone
    if not ok:
        raise SystemExit("ivc: ivc_verify is False")
    if proof.z_i != start:
        raise SystemExit("ivc: the chain's z_N is not the statement's start")
    handles = [getattr(proof, k) for k in ("r_W_primary", "r_E_primary", "r_W_secondary",
                                           "r_E_secondary", "l_w_secondary")]
    if not all(isinstance(h, torch.Tensor) and h.is_cuda for h in handles):
        raise SystemExit("ivc: a witness handle of the device engine is not a CUDA tensor")
    _log(f"ivc: t={t}, {steps} steps: primary {pp.primary.shape.num_cons} constraints, "
         f"secondary {pp.secondary.shape.num_cons}, keys of {COMMIT_N}; proof verifies")

    U = proof.r_U_primary
    w_bad = proof.r_W_primary.clone()
    w_bad[0, 0] ^= 1
    x_bad = list(proof.l_u_secondary.X)
    x_bad[1] ^= 1
    tampered = {
        "wrong num_steps": (proof, steps + 1, z0, start),
        "wrong zn": (proof, steps, z0, [start[0] + 1, *start[1:]]),
        "wrong z0": (proof, steps, [z0[0] + 1, *z0[1:]], start),
        "one changed limb of r_W_primary": (
            dataclasses.replace(proof, r_W_primary=w_bad), steps, z0, start),
        "one changed l_u_secondary.X": (
            dataclasses.replace(proof, l_u_secondary=dataclasses.replace(
                proof.l_u_secondary, X=x_bad)), steps, z0, start),
        "r_U_primary's comm_w and comm_e swapped": (
            dataclasses.replace(proof, r_U_primary=dataclasses.replace(
                U, comm_w=U.comm_e, comm_e=U.comm_w)), steps, z0, start),
    }
    for what, args in tampered.items():
        if ivc_verify(pp, *args):
            raise SystemExit(f"ivc: a proof with {what} verified")
    _log(f"ivc: rejected {', '.join(tampered)}")

    # The native engine on the same (t, z0), and the device engine again to
    # check_steps: the same proof, instance for instance and witness for
    # witness.  Its steps are timed too: the baseline.
    pp_n = ivc_public_params(t, engine="native")
    _, base_n_s, step_n_s, split_n, _, proof_n = _prove_timed(pp_n, z0, steps, check_steps)
    # This run is instrumented (FOLD_PARTS): every fold's parts between two
    # synchronisations.
    fold_split: dict = {}
    with _fold_timers(fold_split):
        check = RecursiveIVC(pp, z0)
        for _ in range(check_steps - 1):
            check.prove_step()
    proof_d = check.proof()
    folds = 2 * (check_steps - 1)
    fold_split = {k: v / folds for k, v in fold_split.items()}
    fold_split["fold other"] = fold_split["fold"] - sum(fold_split[k] for k in FOLD_PARTS
                                                        if k in fold_split)
    fold_split["fused other"] = fold_split["fused pass"] - sum(fold_split[k] for k in FUSED_PARTS)
    for fld in dataclasses.fields(IVCProof):
        got, want = getattr(proof_d, fld.name), getattr(proof_n, fld.name)
        if isinstance(got, torch.Tensor):
            side = pp.primary if fld.name.endswith("primary") else pp.secondary
            got = side.field.decode(got)
        elif dataclasses.is_dataclass(got):
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        if got != want:
            raise SystemExit(f"ivc: {fld.name} of the device engine's {check_steps}-step proof "
                             f"differs from the native engine's")
    _log(f"ivc: the device and native engines' {check_steps}-step proofs are equal field by "
         f"field (instances, z_i, every witness)")

    for kname in ("minroot_eval", *COMMIT_KERNELS):
        if launches[kname] <= 0:
            raise SystemExit(f"evidence: kernel {kname} was not launched by the IVC main path")
    stats = {"t": t, "steps": steps, "card": card,
             "constraints": [pp.primary.shape.num_cons, pp.secondary.shape.num_cons],
             "key_n": COMMIT_N, "eval_s": eval_s, "setup_s": setup, "base_step_s": base_s,
             "device": _rates(step_s), "native": _rates(step_n_s),
             "native_base_step_s": base_n_s, "step_s": step_s, "native_step_s": step_n_s,
             "verify_s": verify_s, "phases_seconds_per_step": split,
             "native_phases_seconds_per_step": split_n, "launches_per_prove_step": per_step,
             "fold_split_s": fold_split}
    dev, nat = stats["device"], stats["native"]
    _log(f"ivc: device engine {dev['folds_per_s_median']:.3f} folds/s (median of "
         f"{dev['timed_steps']} steps; min {dev['folds_per_s_min']:.3f}, max "
         f"{dev['folds_per_s_max']:.3f}); native engine {nat['folds_per_s_median']:.3f} "
         f"(min {nat['folds_per_s_min']:.3f}, max {nat['folds_per_s_max']:.3f}); {card}")
    _log("ivc: phases_seconds_per_step " + json.dumps(split))
    _log(f"ivc: a device fold's parts (s a fold, mean of the {folds} folds of the instrumented "
         f"{check_steps}-step run) " + json.dumps(fold_split))
    _log("ivc: " + json.dumps(stats))
    _log(f"ivc: launches during the IVC main path (eval, set-up, {steps - 1} prove steps, "
         f"proof, verify) {launches}")
    proofs = {"pp": pp, "proof": proof, "steps": steps, "z0": z0, "start": start,
              "pp_native": pp_n, "check_native": proof_n, "check_device": proof_d,
              "check_steps": check_steps}
    return stats, launches, proofs


def _compress_shape_checks(pp, err: dict) -> None:
    """K3-K7 and K9 against their plain versions, bit for bit, at the shapes
    compression gives them, on both curves: the table ``with_h`` builds (K7's
    rows for G and for h, joined) against K7's plain version over G ‖ h; a
    random (2, n + 1) batch through K3, the sort, K4, K5 and K6 on that table,
    each stage against its plain version, the end equal to ``commit_batch``
    and to the native Pippenger over G ‖ h; and an ``msm`` over 29 points
    (an opening's check: Q and 14 rounds of L and R) through K3's window
    rows, K4-K6 and K9, each against its plain version, the sum against the
    native Pippenger."""
    import torch

    from vdf_tpu_torch.curves import (
        CURVES,
        get_curve,
        hash_to_curve_ints,
        msm,
        stack_point,
        unstack_point,
    )
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.curves.bucket_msm import ROWS, layout
    from vdf_tpu_torch.native import msm_native_affine
    from vdf_tpu_torch.nova import derive_generators
    from vdf_tpu_torch.utils import TEST_SEED, XorShiftRng

    rng = XorShiftRng(TEST_SEED)
    for side in (pp.primary, pp.secondary):
        name, ck = side.curve_name, side.ck.with_h
        c = get_curve(name)
        bf, sf = CURVES[name].base_field, CURVES[name].scalar_field
        n, q, device = ck.n, c.scalar.params.modulus, ck.gens.x.device
        where = f"on {name} at the IPA's key of {n} generators (G ‖ h), K=2"
        _require_same("shift_gens", where, ck.table,
                      CK.shift_gens_plain(bf, stack_point(ck.gens).contiguous()), err)
        vals = _xorshift_ints(2 * n, q, rng)
        s = c.scalar.encode(vals, device).reshape(2, n, 8)
        _, m_pad = layout(n)
        keys = CK.canon_digits(sf, s, m_pad)
        _require_same("canon_digits", where, keys, CK.canon_digits_plain(sf, s, m_pad), err)
        scan_args = (bf, ck.table, torch.sort(keys, dim=-1).values, ROWS)
        tails, tail_col, sums, flags = CK.bucket_scan(*scan_args)
        _require_same("scan", where, (tails, tail_col, sums, flags),
                      CK.bucket_scan_plain(*scan_args), err)
        carries = CK.column_carries(bf, sums, flags)
        _require_same("colscan", where, carries, CK.column_carries_plain(bf, sums, flags), err)
        got = CK.bucket_sums(bf, tails, tail_col, carries)
        _require_same("bucket", where, got, CK.bucket_sums_plain(bf, tails, tail_col, carries),
                      err)
        if not torch.equal(got, stack_point(ck.commit_batch(s))):
            raise SystemExit(f"compress: the staged commit {where} != commit_batch")
        aff = list(derive_generators(name, n - 1))  # G_0 .. G_(n-2), then h
        for k, pt in enumerate(c.to_affine_ints(unstack_point(got))):
            if pt != msm_native_affine(name, aff, vals[k * n : (k + 1) * n]):
                raise SystemExit(f"compress: commit row {k} {where} != the native Pippenger")

        m_aff = hash_to_curve_ints(name, 29, domain=b"vdf_tpu/t")
        pts = stack_point(c.from_affine_ints(m_aff, device)).contiguous()
        m_vals = _xorshift_ints(29, q, rng)
        scalars = c.scalar.encode(m_vals, device)
        args, _ = _msm_stage_args(name, pts, scalars)
        for kname, a in args.items():
            fn = COMMIT_KERNELS[kname][0] if kname in COMMIT_KERNELS else kname
            got, want = getattr(CK, fn)(*a), getattr(CK, fn + "_plain")(*a)
            torch.cuda.synchronize()
            _require_same(kname, f"on {name} at n=29, variable base", got, want, err)
        if _affine(c, msm(c, unstack_point(pts), scalars)) != \
                msm_native_affine(name, m_aff, m_vals):
            raise SystemExit(f"compress: msm on {name} at n=29 != the native Pippenger")
    _log(f"compress kernels: both curves, the key with h ({n} generators): its table == K7's "
         f"plain version over G ‖ h; K3, K4, K5, K6 == plain at K=2 and the commits == "
         f"commit_batch == the native Pippenger; msm at n=29: K3 (window rows), K4, K5, K6, "
         f"K9 == plain and the sum == the native Pippenger; bit for bit")


def phase_compress(ivc: dict, card: str) -> tuple[dict, dict, dict]:
    """Compression and serialization of phase 12's proofs, with no device
    argument anywhere: ivc_compress -> ivc_verify_compressed on the 8-step
    device proof (each between two synchronisations), serialize_compressed
    -> deserialize_compressed -> verify and the same bytes again; the device
    engine's compress of the 3-step device proof byte-equal to the native
    engine's of the 3-step native proof; tamper cases; the compress split
    by part (ivc_compress's PhaseTimer spans); then K3-K7 and K9 against
    their plain versions at compression's shapes.  Returns stats, the launch
    counts of K1/K2 and K3-K9 from the keys' h tables to the end of verify,
    and each kernel's largest difference from its plain version here."""
    import dataclasses

    import torch

    from vdf_tpu_torch import (
        SerializationError,
        deserialize_compressed,
        ivc_compress,
        ivc_verify_compressed,
        serialize_compressed,
    )
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.fields import kernels as FK
    from vdf_tpu_torch.spartan import SpartanProof
    from vdf_tpu_torch.utils.profiling import PhaseTimer

    pp, proof, steps, z0, start = (ivc[k] for k in ("pp", "proof", "steps", "z0", "start"))

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    FK.reset_launches()
    CK.reset_launches()
    # Set-up: each key with h appended (K7 on h, the table copied once).
    _, h_tables_s = clock(lambda: [side.ck.with_h.table for side in (pp.primary, pp.secondary)])
    cp, compress_s = clock(lambda: ivc_compress(pp, proof))
    ok, verify_s = clock(lambda: ivc_verify_compressed(pp, cp, steps, z0, start))
    launches = {**FK.LAUNCHES, **CK.LAUNCHES}  # of set-up, compress and verify alone
    if not ok:
        raise SystemExit("compress: ivc_verify_compressed is False")
    if not isinstance(cp.spartan_primary, SpartanProof) or not cp.spartan_primary.vW.is_cuda:
        raise SystemExit("compress: the device engine's argument is not on the card")
    for kname in ("canon_digits", "scan", "colscan", "bucket", "horner"):
        if launches[kname] <= 0:
            raise SystemExit(f"evidence: kernel {kname} was not launched by the compress path")
    blob, serialize_s = clock(lambda: serialize_compressed(pp, cp))
    back, deserialize_s = clock(lambda: deserialize_compressed(pp, blob))
    if not ivc_verify_compressed(pp, back, steps, z0, start):
        raise SystemExit("compress: the deserialized proof does not verify")
    if serialize_compressed(pp, back) != blob:
        raise SystemExit("compress: serialize(deserialize(bytes)) gives other bytes")
    _log(f"compress: t={pp.t}, {steps} steps: {len(blob)} bytes; verifies, and so does its "
         f"byte round trip")

    # The device engine's compress of the 3-step device proof, and the
    # native engine's of the 3-step native proof: the same bytes.
    pp_n, n_steps = ivc["pp_native"], ivc["check_steps"]
    cp_d = ivc_compress(pp, ivc["check_device"])
    cp_n, native_compress_s = clock(lambda: ivc_compress(pp_n, ivc["check_native"]))
    blob_d, blob_n = serialize_compressed(pp, cp_d), serialize_compressed(pp_n, cp_n)
    if blob_d != blob_n:
        raise SystemExit(f"compress: the device and native engines' compressed {n_steps}-step "
                         f"proofs differ")
    if len(blob_d) != len(blob):
        raise SystemExit(f"compress: {len(blob_d)} bytes at {n_steps} steps, {len(blob)} at "
                         f"{steps}: the size depends on the steps")
    _log(f"compress: the device and native engines' compressed {n_steps}-step proofs are "
         f"byte-equal ({len(blob_d)} bytes, the same as at {steps} steps)")

    f_p, f_s = pp.primary.field, pp.secondary.field
    sp_p, sp_s = cp.spartan_primary, cp.spartan_secondary
    msg0 = sp_p.sc1_messages[0]
    ipa = sp_p.ipa_w
    tampered = {
        "wrong num_steps": (cp, steps + 1, start),
        "wrong zn": (cp, steps, [start[0] + 1, *start[1:]]),
        "a changed sumcheck message": (dataclasses.replace(cp, spartan_primary=sp_p._replace(
            sc1_messages=((f_p.add(msg0[0], f_p.one()), *msg0[1:]), *sp_p.sc1_messages[1:]))),
            steps, start),
        "vW + 1": (dataclasses.replace(cp, spartan_secondary=sp_s._replace(
            vW=f_s.add(sp_s.vW, f_s.one()))), steps, start),
        "a swapped IPA point": (dataclasses.replace(cp, spartan_primary=sp_p._replace(
            ipa_w=ipa._replace(ls=(ipa.rs[0], *ipa.ls[1:]), rs=(ipa.ls[0], *ipa.rs[1:])))),
            steps, start),
    }
    for what, (bad, n, zn) in tampered.items():
        if ivc_verify_compressed(pp, bad, n, z0, zn):
            raise SystemExit(f"compress: a compressed proof with {what} verified")
    try:
        deserialize_compressed(pp, blob[:-1])
        raise SystemExit("compress: a truncated blob decoded")
    except SerializationError:
        pass
    _log(f"compress: rejected {', '.join(tampered)}, a truncated blob")

    # The split: ivc_compress's own spans, each between two synchronisations.
    timer = PhaseTimer(sync=torch.cuda.synchronize)
    again, split_s = clock(lambda: ivc_compress(pp, proof, timer))
    if serialize_compressed(pp, again) != blob:
        raise SystemExit("compress: the instrumented compress gave other bytes")
    split = dict(timer.totals)
    for side in (pp.primary, pp.secondary):
        name = side.curve_name
        split[f"{name}/other"] = split[name] - sum(v for k, v in timer.totals.items()
                                                  if k.startswith(name + "/"))
    split["other"] = split_s - split["closing fold"] - split["pallas"] - split["vesta"]

    err: dict = {}
    _compress_shape_checks(pp, err)
    stats = {"t": pp.t, "steps": steps, "card": card, "bytes": len(blob),
             "h_tables_s": h_tables_s, "compress_s": compress_s, "verify_s": verify_s,
             "serialize_s": serialize_s, "deserialize_s": deserialize_s,
             "native_compress_s": native_compress_s, "instrumented_compress_s": split_s,
             "compress_split_s": split}
    _log(f"compress: ivc_compress {compress_s:.4f} s, ivc_verify_compressed {verify_s:.4f} s, "
         f"{len(blob)} bytes; native engine's compress {native_compress_s:.3f} s; {card}")
    _log("compress: split of an instrumented compress (s) " + json.dumps(split))
    _log("compress: " + json.dumps(stats))
    _log(f"compress: launches during the compress main path (h tables, compress, verify) "
         f"{launches}")
    return stats, launches, err


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; nothing was run")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import vdf_tpu_torch  # noqa: F401  (fails where the package is absent)

    device = torch.device("cuda", 0)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    card = _card()
    clock_hz = _sm_clock_hz()
    _log(f"bounds: {SMS} SMs x {INT32_LANES} int32 lanes x {clock_hz / 1e6:.0f} MHz "
         f"(nvidia-smi clocks.max.sm), {HBM_BYTES_PER_S / 1e12} TB/s")
    phase_build()
    kernel_stats = phase_kernels(device, CHECK_LANES, CHECK_T, LANES, T, clock_hz)
    main_stats = phase_main(device, LANES, T, T_APPEND)
    # K1's launch at the main shape was phase 3's eval.
    k1_main = kernel_stats["minroot_eval"]["main_shape"]
    k1_main["ms"] = main_stats["eval_event_s"] * 1e3
    _log("timing: minroot_eval Fq at the main shape: " + json.dumps(k1_main))
    if min(k1_main["ms"], kernel_stats["minroot_inverse"]["main_shape"]["ms"]) <= 0:
        raise SystemExit("timing: a main-shape launch took no time")
    commit_kernel_stats = phase_commit_kernels(device, COMMIT_CHECK_N, COMMIT_N, clock_hz)
    _, commit_launches = phase_commit(device, COMMIT_N)
    msm_kernel_stats = phase_msm_kernels(device, MSM_CHECK_N, MSM_N, clock_hz)
    _, msm_launches = phase_msm(device, MSM_N, MSM_CHECK_N)
    _, engine_launches = phase_engine(ENGINE_T, ENGINE_STEPS)
    _, ivc_launches, ivc_proofs = phase_ivc(IVC_T, IVC_STEPS, IVC_CHECK_STEPS, card)
    _, compress_launches, compress_err = phase_compress(ivc_proofs, card)
    del ivc_proofs

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
                "timed_at": timed_at,
                **{k: st[k] for k in ("main_shape", "msm_shape", "forms", "key_bits", "sort_ms")
                   if k in st}}

    # K4 at the MSM's shape beside its commit-shape entry; its error covers both.
    msm_scan = msm_kernel_stats["stages"]["scan"]
    commit_kernel_stats["scan"]["max_abs_err"] = max(commit_kernel_stats["scan"]["max_abs_err"],
                                                     msm_kernel_stats["scan_err"])
    commit_kernel_stats["scan"]["msm_shape"] = {
        "n": MSM_N, "batch": 22, **{k: msm_scan[k] for k in (  # a batch row a window
            "ms", "plain_ms", "bound_ms", "bound_by", "forms")}}
    # K3's window rows at the MSM's shape beside its commit-shape entry.
    msm_digits = msm_kernel_stats["stages"]["canon_digits"]
    commit_kernel_stats["canon_digits"]["max_abs_err"] = max(
        commit_kernel_stats["canon_digits"]["max_abs_err"], msm_kernel_stats["canon_digits_err"])
    commit_kernel_stats["canon_digits"]["sort_ms"]["msm"] = \
        msm_kernel_stats["stages"]["sort"]["by_key_bits"]
    commit_kernel_stats["canon_digits"]["msm_shape"] = {
        "n": MSM_N, "window_rows": True, **{k: msm_digits[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by")}}
    # Each kernel's error also covers its checks at compression's shapes.
    for name, e in compress_err.items():
        st = msm_kernel_stats["horner"] if name == "horner" else commit_kernel_stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], e)
    msm_src = "vdf_tpu_torch/csrc/msm_kernels.cuh"
    kernels = [
        entry(name, "vdf_tpu_torch/csrc/minroot_kernels.cuh", replaces[name],
              {"minroot": main_stats["launches"][name], "engine": engine_launches[name],
               "ivc": ivc_launches[name], "compress": compress_launches[name]},
              st, {"lanes": st["lanes"], "t": st["t"], "field": "Fq"})
        for name, st in kernel_stats.items()
    ] + [
        entry(name, msm_src, COMMIT_KERNELS[name][1],
              {"commit": commit_launches[name], "msm": msm_launches[name],
               "engine": engine_launches[name], "ivc": ivc_launches[name],
               "compress": compress_launches[name]},
              st, {"n": COMMIT_N, "curve": "pallas", "batch": 1})
        for name, st in commit_kernel_stats.items()
    ] + [
        entry("horner", msm_src, "vdf_tpu/curves/pallas_msm.py:234",
              {"msm": msm_launches["horner"], "engine": engine_launches["horner"],
               "ivc": ivc_launches["horner"], "compress": compress_launches["horner"]},
              msm_kernel_stats["horner"], {"batch": 1, "curve": "pallas"}),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
