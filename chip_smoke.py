#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py   # MinRoot Fq, t = 2^16, 8,192 lanes; commits n = 2^14

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
  4. evidence the launch counters of both kernels moved during phase 3;
  5. commit kernels  K3 (canon_digits, canon_mont), K7 (shift_gens), K4
             (scan), K5 (colscan) and K6 (bucket) against their plain
             versions on the card, on Pallas and Vesta at n = 256 (K = 2
             rows): every output element bit-for-bit equal; then at the
             commit's main shape, n = 2^14, each kernel's time beside its
             plain version's, outputs again bit-for-bit equal;
  6. commit  for Pallas and Vesta: commitment_key(curve, 2^14) (host
             derivation and K7 table timed apart), commit of xorshift
             scalars == the native C++ Pippenger in affine, the K = 2 batch
             == two single commits, zero -> identity, e_0 -> G_0,
             (q - 1) e_{n-1} -> -G_{n-1}, one changed scalar changes the
             commitment; commit_fixed's canonical output agrees; wall and
             CUDA-event ms of a commit at K = 1 and K = 2;
  7. evidence the launch counters of K3-K7 moved during phase 6.

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
COMMIT_N = 1 << 14  # commit length: the bench IVC's (t = 32) _commit_pad, both curves
COMMIT_CHECK_N = 256  # kernel-vs-plain commit length
COMMIT_CURVES = ("pallas", "vesta")
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


def phase_commit_kernels(device, check_n: int, n: int) -> dict:
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
            _log(f"timing: {kname} {curve_name} n={n}: kernel {ms:.4f} ms, plain "
                 f"{plain_ms:.4f} ms; == plain, bit for bit")
            if curve_name == "pallas":
                times[kname] = {"ms": ms, "plain_ms": plain_ms}
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

    from vdf_tpu_torch.curves import commit_fixed, get_curve, stack_point
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.native import msm_native_affine
    from vdf_tpu_torch.nova import DEFAULT_LABEL, commitment_key, derive_generators
    from vdf_tpu_torch.utils import TEST_SEED, XorShiftRng

    stats = {}
    CK.reset_launches()
    for name in COMMIT_CURVES:
        c = get_curve(name)
        mod, q = c.field.params.modulus, c.scalar.params.modulus
        t0 = time.perf_counter()
        pts = derive_generators(name, n, DEFAULT_LABEL)
        derive_s = time.perf_counter() - t0
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
        t0 = time.perf_counter()
        got = _affine(c, pt)
        decode_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = msm_native_affine(name, list(pts[:n]), vals)
        native_s = time.perf_counter() - t0
        if got is None or got != want:
            raise SystemExit(f"commit: {name} commit != native Pippenger in affine")

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
        _log(f"commit: {name} == native in affine; K=2 == singles; zero, e_0, (q-1) e_(n-1) "
             f"and a changed scalar ok; " + json.dumps(stats[name]))
    torch.cuda.synchronize()
    launches = dict(CK.LAUNCHES)
    _log(f"commit: launches during the commit main path {launches}")
    for kname, count in launches.items():
        if count <= 0:
            raise SystemExit(f"evidence: kernel {kname} was not launched by the commit main path")
    return stats, launches


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
    commit_kernel_stats = phase_commit_kernels(device, COMMIT_CHECK_N, COMMIT_N)
    _, commit_launches = phase_commit(device, COMMIT_N)

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
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "vdf_tpu_torch/csrc/msm_kernels.cuh",
            "replaces": COMMIT_KERNELS[name][1],
            "launches": commit_launches[name],
            "max_abs_err": st["max_abs_err"],
            "ms": st["ms"],
            "plain_ms": st["plain_ms"],
            "timed_at": {"n": COMMIT_N, "curve": "pallas", "batch": 1},
        }
        for name, st in commit_kernel_stats.items()
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
