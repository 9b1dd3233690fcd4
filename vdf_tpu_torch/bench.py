"""The port's benchmark: the repo root's ``bench.py`` on PyTorch and the card.

    python -m vdf_tpu_torch.bench                        # every section, on cuda:0
    python -m vdf_tpu_torch.bench --folding --sweep      # one section: also --msm, --minroot
    python -m vdf_tpu_torch.bench --smoke                # small shapes, still on the card
    python -m vdf_tpu_torch.bench --smoke --device cpu   # small shapes, the plain versions

Sections, in the reference's order and at its sizes (default · ``--smoke``):

  1. folding: the headline ``nova_folding_steps_per_sec``.  The statement's
     z0 is t n forward rounds from (987654321, 0, 1) through K1, checked
     against host ints; ``RecursiveIVC`` proves n steps on the ``"device"``
     engine, then on the ``"native"`` engine (the baseline) on the same z0;
     the first fold of each chain warms it and the n - 2 after it are
     timed one by one.  t = 32, n = 8 · t = 2, n = 4 on ``"native"`` twice;
  2. interleaved: ``prove_interleaved`` at K = 4 and 8 chains of n steps
     on the headline's params, aggregate folds/s a K · not run;
  3. msm: ``msm_points_per_sec_per_chip``, Pallas, the reference's inputs
     (1,024 hash-derived bases repeated, scalars from
     ``np.random.default_rng(7)``): n = 2^20, oracle at 2^12, the native
     Pippenger at n · 2^14, oracle and native baseline at 2^12;
  4. minroot: ``minroot_aggregate_iters_per_sec``, Fq, x = 3 + lane: 16,384
     lanes, 4 chained segments of t = 256 (K1), verify of one segment (K2),
     the native single chain, and K1 on 1,024 lanes (the latency point) ·
     64 lanes, 2 segments of t = 8, no latency point;
  5. per_mode: each ``EvalMode``'s eager mode program on 2,048 lanes,
     t = 64 · not run;
  6. sweep (``--sweep``, or the default run): the reference's points
     (t, n) = (10, 200), (100, 20), (1000, 2), each proving 12, 12 and 4
     steps on both engines · 6, 6 and 4 steps on ``"native"``.

Every section is gated by its oracle before a number of it is printed, and
nothing fails soft: a section whose gate fails or that raises is named in
``section_errors`` (its traceback goes to stderr) and the sections after it
still run; a section or K the budget (``VDF_TPU_BENCH_BUDGET_S``, default
600 s) leaves no room for is named in ``skipped``.  On a CUDA device each
section must also have launched its kernels (the launch counters, reset
before each section, are in the ``launches`` detail).  Each rate is the
median of the timed steps or repetitions, each between two
``torch.cuda.synchronize()``, with ``[min, max]`` beside it
(``*_min_max``); no first, cold call is timed.

Output: after each section, the full merged JSON line (the reference's
``metric``, ``value``, ``unit``, ``vs_baseline`` and ``detail`` with every
key of its sections, plus the tables: phases, the per-mode table, the
sweep, the interleaved detail, the launches); then, as the last line, a
short one (under 1,500 characters) with the headline, each section's
metric and native baseline, the card, the host, ``skipped`` and
``section_errors``.

Exit codes: 0 when every section ran and every gate held; 1 when a
section failed or was skipped (the last line is printed first), or when
there is no card and ``--device cpu`` was not given (``KernelError``,
before any section); 2 for a malformed command line; 128 + signum on
SIGTERM or SIGINT, after the last line.

Departures from ``bench.py``, each a repair of a fault its reviews found:
the headline's engine is ``"device"`` (the port has no ``"auto"``); rates
are medians, not means; the last line is short and always carries the
headline; the native baselines have no estimate to fall back on; every
oracle gate is required; a failed or skipped section makes the exit code
non-zero; a signal exits 128 + signum.  ``--xla-path`` runs the mode
programs (``MinRootVDF.round``, ``fields/chains.py``) in place of K1/K2.
The native baselines are timed on inputs already in the native tier's
form, as the card's are already on the card.

Imports neither jax nor vdf_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import platform
import signal
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from .device import resolve_device
from .errors import VDFError

BUDGET_ENV = "VDF_TPU_BENCH_BUDGET_S"
DEFAULT_BUDGET_S = 600.0
START = (987654321, 0, 1)  # the statement's start (bench.py:96)
INTERLEAVED_K = (4, 8)
MSM_BASES = 1024
MSM_DOMAIN = b"vdf_tpu/bench"
MSM_SEED = 7
MSM_CHECK = 1 << 12
NATIVE_MINROOT_ITERS = 20000
NATIVE_REPS = 3
PERMODE_LANES = 2048
PERMODE_T = 64
LATENCY_LANES = 1024
# (t, n, steps proven, seconds of budget a point needs) (bench.py:664-668)
SWEEP = ((10, 200, 12, 90), (100, 20, 12, 90), (1000, 2, 4, 180))
SMOKE_SWEEP_CAP = 6
LAST_LINE_MAX = 1500
FOLD_KERNELS = ("canon_digits", "canon_mont", "scan", "colscan", "bucket", "field_ew",
                "r1cs_matvec")
MSM_KERNELS = ("canon_digits", "scan", "colscan", "bucket", "horner")


class BenchError(VDFError):
    """A section's result disagrees with its oracle."""


# ---------------------------------------------------------------------
# inputs and helpers
# ---------------------------------------------------------------------


def _forward_eval_ints(x, y, i, total):
    """``total`` forward MinRoot rounds over Fq on host ints (bench.py:76)."""
    from .fields.int_field import get_int_field

    p = get_int_field("Fq").p
    e = pow(5, -1, p - 1)
    for _ in range(total):
        x, y, i = pow((x + y) % p, e, p), (x + i) % p, i + 1
    return x, y, i


def _inverse_ints(x, y, i, total, p):
    """``total`` inverse MinRoot rounds on host ints (bench.py:466-469)."""
    for _ in range(total):
        i = (i - 1) % p
        nx = (y - i) % p
        x, y = nx, (pow(x, 5, p) - nx) % p
    return x, y, i


def msm_inputs(n: int) -> tuple[list, list]:
    """The reference's MSM inputs (bench.py:270-281): affine ints of
    MSM_BASES hash-derived Pallas points repeated to n, and n scalars from
    ``np.random.default_rng(MSM_SEED)``."""
    from .curves import get_curve, hash_to_curve_ints

    rng = np.random.default_rng(MSM_SEED)
    base = hash_to_curve_ints("pallas", MSM_BASES, domain=MSM_DOMAIN)
    q = get_curve("pallas").scalar.params.modulus
    return ([base[k % MSM_BASES] for k in range(n)],
            [int.from_bytes(rng.bytes(32), "little") % q for _ in range(n)])


def minroot_start(vdf, lanes: int, device):
    """The reference's start state: x = 3 + lane, y = i = 0 (bench.py:409-413)."""
    return vdf.state_from_ints(list(range(3, 3 + lanes)), [0] * lanes, [0] * lanes, device=device)


def _rounds(step, s, t: int):
    for _ in range(t):
        s = step(s)
    return s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device: torch.device):
    """(fn(), wall s between two synchronisations)."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _rate(work: float, seconds: list[float]) -> tuple[float, list[float]]:
    """Median of work / s over the timed repetitions, and [min, max]."""
    rates = [work / s for s in seconds]
    return statistics.median(rates), [min(rates), max(rates)]


def _platform(device: torch.device) -> str:
    return "gpu" if device.type == "cuda" else device.type


def card(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or the
    CPU's platform name."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=30)
    except FileNotFoundError:
        out = None
    if out is not None and out.returncode == 0 and out.stdout.strip():
        return out.stdout.strip()
    return f"{torch.cuda.get_device_name(device)}, power limit not read (no nvidia-smi)"


def host() -> str:
    """The host's CPU (its model name, or where a sandbox hides that, its
    vendor, family and model numbers) and the cores this process may use."""
    info = {}
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as fh:
            for ln in fh:
                key, _, value = ln.partition(":")
                info.setdefault(key.strip(), value.strip())
    model = info.get("model name", "unknown")
    if model == "unknown" and "vendor_id" in info:
        model = f"{info['vendor_id']} family {info.get('cpu family')} model {info.get('model')}"
    elif model == "unknown":
        model = platform.machine()
    return f"{model}, {len(os.sched_getaffinity(0))} of {os.cpu_count()} cores"


def _counts() -> dict:
    from .curves import kernels as CK
    from .fields import kernels as FK

    return {**FK.LAUNCHES, **CK.LAUNCHES}


def _reset_counts() -> None:
    from .curves import kernels as CK
    from .fields import kernels as FK

    FK.reset_launches()
    CK.reset_launches()


# ---------------------------------------------------------------------
# 1, 2, 6: the two-curve IVC
# ---------------------------------------------------------------------


def statement(starts: list, total: int, device) -> list[list[int]]:
    """Each chain's z0: ``total`` forward rounds from each start as one K1
    launch over the chains' lanes, equal to the host-int rounds."""
    from .minroot import pallas_vdf

    vdf = pallas_vdf()
    s = vdf.state_from_ints(*(list(c) for c in zip(*starts)), device=device)
    got = list(zip(*vdf.state_to_ints(vdf.eval(s, total))))
    want = [_forward_eval_ints(*st, total) for st in starts]
    if got != want:
        raise BenchError(f"the statement's K1 eval over {total} rounds differs from host ints")
    return [list(z) for z in want]


def _params(t: int, engine: str, device):
    from .nova.ivc import ivc_public_params

    return ivc_public_params(t, engine=engine, device=device if engine == "device" else None)


def prove_chain(pp, z0: list, n: int, start, device) -> dict:
    """n steps of one chain: the base step, one fold to warm the path, and
    n - 2 folds timed one by one; the proof must verify."""
    from .nova.ivc import RecursiveIVC, ivc_verify
    from .utils.profiling import PhaseTimer

    ivc = RecursiveIVC(pp, z0)
    ivc.prove_step()
    ivc.timer = PhaseTimer(ivc.timer.sync)
    step_s = [_timed(ivc.prove_step, device)[1] for _ in range(n - 2)]
    proof = ivc.proof()
    engine = pp.primary.engine
    if not ivc_verify(pp, proof, n, z0, list(start)):
        raise BenchError(f"the {engine} engine's proof at t={pp.t}, n={n} does not verify")
    return {"step_s": step_s, "z_n": [int(v) for v in proof.z_i],
            "phases": {k: round(v / (n - 2), 4) for k, v in sorted(ivc.timer.under().items())}}


def fold_pair(t: int, n: int, engine: str, device) -> tuple:
    """(pp, engine's chain, native chain): the same statement proven on
    ``engine`` and on ``"native"``; both verify and end at the same z_n."""
    if n < 3:
        raise ValueError(f"a timed chain needs n >= 3 steps, got {n}")
    z0 = statement([START], n * t, device)[0]
    pp = _params(t, engine, device)
    run = prove_chain(pp, z0, n, START, device)
    base = prove_chain(_params(t, "native", device), z0, n, START, device)
    if run["z_n"] != base["z_n"]:
        raise BenchError(f"the {engine} and native engines end at different z_n at t={t}")
    return pp, run, base


def folding_result(t: int, n: int, engine: str, device, card_s: str) -> dict:
    """The headline (bench.py:144-215): single-chain folds/s on ``engine``
    against the native engine on the same chain."""
    pp, run, base = fold_pair(t, n, engine, device)
    sps, sps_mm = _rate(1.0, run["step_s"])
    base_sps, base_mm = _rate(1.0, base["step_s"])
    return {
        "metric": "nova_folding_steps_per_sec",
        "value": round(sps, 3),
        "unit": "folds/s",
        "vs_baseline": round(sps / base_sps, 3),
        "detail": {
            "t_iters_per_step": t,
            "num_steps": n,
            "steps_timed": n - 2,
            "engine": engine,
            "single_chain_folds_per_sec": round(sps, 3),
            "single_chain_folds_per_sec_min_max": [round(v, 3) for v in sps_mm],
            "interleaved": None,
            "constraints_primary": pp.primary.shape.num_cons,
            "constraints_secondary": pp.secondary.shape.num_cons,
            "baseline_folds_per_sec": round(base_sps, 3),
            "baseline_folds_per_sec_min_max": [round(v, 3) for v in base_mm],
            "baseline_note": "native engine (C++ Pippenger MSM + int matvecs), single chain, "
                             "same statement",
            "verified": True,
            "backend": _platform(device),
            "card": card_s,
            "phases_seconds_per_step": run["phases"],
        },
    }


def interleaved_result(t: int, n: int, engine: str, device, remaining, skipped: list,
                       ks=INTERLEAVED_K) -> dict:
    """Aggregate folds/s of K interleaved chains (bench.py:114-141): K (n - 1)
    folds over the wall of ``prove_interleaved`` (base steps included); every
    chain verifies outside the clock.  A K the budget leaves no room for is
    appended to ``skipped``."""
    from .nova.ivc import ivc_verify
    from .nova.pipeline import prove_interleaved

    pp = _params(t, engine, device)
    by_k = {}
    for k in ks:
        if by_k and remaining() < 30:
            skipped.append(f"interleaved_k{k}")
            continue
        starts = [(START[0] + 17 * j, j, 1) for j in range(k)]
        z0s = statement(starts, n * t, device)
        proofs, dt = _timed(lambda: prove_interleaved(pp, z0s, n), device)
        for j, (proof, z0, s) in enumerate(zip(proofs, z0s, starts)):
            if not ivc_verify(pp, proof, n, z0, list(s)):
                raise BenchError(f"interleaved chain {j} of K={k} does not verify")
        by_k[k] = round(k * (n - 1) / dt, 3)
    best = max(by_k, key=by_k.get)
    return {"chains": best, "num_steps": n, "aggregate_folds_per_sec": by_k[best],
            "aggregate_folds_per_sec_by_chains": by_k, "verified": True}


def sweep_point(t: int, n_full: int, n_run: int, engine: str, device) -> dict:
    """One reference point (t, n) at t n = 2000 (bench.py:218-235): a prefix of
    ``n_run`` steps proven on both engines, n_run - 2 of them timed."""
    n_run = max(min(n_run, n_full + 2), 3)
    pp, run, base = fold_pair(t, n_run, engine, device)
    sps, sps_mm = _rate(1.0, run["step_s"])
    base_sps, base_mm = _rate(1.0, base["step_s"])
    return {"t": t, "n": n_full, "steps_proven": n_run, "steps_timed": n_run - 2,
            "engine": engine, "folds_per_sec": round(sps, 3),
            "folds_per_sec_min_max": [round(v, 3) for v in sps_mm],
            "baseline": round(base_sps, 3), "baseline_min_max": [round(v, 3) for v in base_mm],
            "vs_baseline": round(sps / base_sps, 3),
            "keys": [pp.primary._commit_pad, pp.secondary._commit_pad]}


# ---------------------------------------------------------------------
# 3: msm
# ---------------------------------------------------------------------


def msm_result(n: int, smoke: bool, device, card_s: str) -> dict:
    """Pippenger MSM points/s (bench.py:258-343): gated against the native
    Pippenger at min(n, 2^12), then timed at n; every timed result equals
    the first."""
    from .curves import Point, get_curve, msm
    from .curves.point import stack_point
    from .native import msm_native_affine, msm_native_packed, pack_points_u64, pack_scalars_u64

    curve = get_curve("pallas")
    n_check = min(n, MSM_CHECK)
    aff, sc = msm_inputs(n)
    pts = curve.from_affine_ints(aff, device)
    s = curve.scalar.encode(sc, device)

    want = msm_native_affine("pallas", aff[:n_check], sc[:n_check])
    checked = msm(curve, Point(*(v[:n_check] for v in pts)), s[:n_check])
    if curve.to_affine_ints(checked)[0] != want:
        raise BenchError(f"msm differs from the native Pippenger at n={n_check}")

    # the native baseline at the card's n (the smoke run: at 2^12)
    n_base = n_check if smoke else n
    packed = pack_points_u64(aff[:n_base]), pack_scalars_u64(sc[:n_base])
    msm_native_packed("pallas", packed[0][: 8 * 256], packed[1][: 4 * 256])  # warm
    base_s = []
    for _ in range(NATIVE_REPS):
        t0 = time.perf_counter()
        msm_native_packed("pallas", *packed)
        base_s.append(time.perf_counter() - t0)
    base_pps, base_mm = _rate(n_base, base_s)

    first = checked if n == n_check else msm(curve, pts, s)  # the warm call at n
    reps = 1 if smoke else 3
    wall = []
    for _ in range(reps):
        r, dt = _timed(lambda: msm(curve, pts, s), device)
        wall.append(dt)
        if not torch.equal(stack_point(r), stack_point(first)):
            raise BenchError("a timed msm differs from the first msm on the same inputs")
    pps, pps_mm = _rate(n, wall)
    return {
        "metric": "msm_points_per_sec_per_chip",
        "value": round(pps, 1),
        "unit": "points/s",
        "vs_baseline": round(pps / base_pps, 3),
        "detail": {
            "points": n,
            "wall_seconds": round(statistics.median(wall), 6),
            "reps": reps,
            "points_per_sec_min_max": [round(v, 1) for v in pps_mm],
            "oracle_checked_at": n_check,
            "checked_sum_affine_hex": None if want is None else [hex(c) for c in want],
            "baseline_points_per_sec": round(base_pps, 1),
            "baseline_points_per_sec_min_max": [round(v, 1) for v in base_mm],
            "baseline_points": n_base,
            "baseline_note": "native C++ Pippenger (pasta-msm equivalent) on packed inputs, "
                             + ("measured at same n" if n_base == n else
                                f"measured at n={n_base} (cross-size)"),
            "backend": _platform(device),
            "card": card_s,
        },
    }


# ---------------------------------------------------------------------
# 4, 5: MinRoot
# ---------------------------------------------------------------------


def _native_minroot_baseline() -> tuple[float, list[float]]:
    """The native single chain's iters/s (bench.py:52-63), its 200-round
    warm-up checked against host ints; no estimate to fall back on."""
    from .native import minroot_eval_native

    if minroot_eval_native("Fq", 7, 0, 0, 200) != _forward_eval_ints(7, 0, 0, 200):
        raise BenchError("the native MinRoot chain differs from host ints")
    secs = []
    for _ in range(NATIVE_REPS):
        t0 = time.perf_counter()
        minroot_eval_native("Fq", 7, 0, 0, NATIVE_MINROOT_ITERS)
        secs.append(time.perf_counter() - t0)
    return _rate(NATIVE_MINROOT_ITERS, secs)


def _check_lanes(vdf, s, t: int, what: str, lanes: int = 2) -> None:
    """Lanes 0..lanes-1 of ``s`` against t host-int rounds from the start."""
    f = vdf.field
    p, e = f.params.modulus, f.params.inv_alpha
    got = f.decode(s.x[:lanes])
    for lane in range(lanes):
        x, y, i = 3 + lane, 0, 0
        for _ in range(t):
            x, y, i = pow((x + y) % p, e, p), (x + i) % p, (i + 1) % p
        if got[lane] != x:
            raise BenchError(f"{what} differs from host ints on lane {lane}")


def permode_result(device, remaining, skipped: list, lanes: int = PERMODE_LANES,
                   t: int = PERMODE_T) -> dict:
    """Each EvalMode's eager mode program (bench.py:351-394): one warm round,
    then t rounds each timed; lane 0 against host ints.  A mode the budget
    leaves no room for is appended to ``skipped``."""
    from .minroot import EvalMode, pallas_vdf

    modes = {}
    for mode in EvalMode:
        if remaining() < 20:
            skipped.append(f"per_mode/{mode.value}")
            modes[mode.value] = {"skipped": "budget"}
            continue
        vdf = pallas_vdf(mode)
        s = minroot_start(vdf, lanes, device)
        vdf.round(s)  # the first launch of every op of a round
        round_s = []
        for _ in range(t):
            s, dt = _timed(lambda s=s: vdf.round(s), device)
            round_s.append(dt)
        _check_lanes(vdf, s, t, f"mode {mode.value}", lanes=1)
        rate, mm = _rate(lanes, round_s)
        modes[mode.value] = {"iters_per_sec": round(rate, 1),
                             "iters_per_sec_min_max": [round(v, 1) for v in mm],
                             "lanes": lanes, "t": t}
    return modes


def minroot_result(args, device, card_s: str, remaining, skipped: list,
                   with_modes: bool) -> dict:
    """MinRoot throughput, verify and latency (bench.py:397-529)."""
    from .minroot import EvalMode, pallas_vdf

    smoke = args.smoke
    lanes = args.lanes or (64 if smoke else 16384)
    t = args.iters or (8 if smoke else 256)
    n_rep = 2 if smoke else 4
    vdf = pallas_vdf(EvalMode(args.mode))
    f = vdf.field
    p = f.params.modulus
    if args.xla_path:
        path = "mode_program"

        def eval_fn(s):
            return _rounds(vdf.round, s, t)

        def verify_fn(s):
            return _rounds(vdf.inverse_round, s, t)
    else:
        path = "kernels"

        def eval_fn(s):
            return vdf.eval(s, t)

        def verify_fn(s):
            return vdf.inverse_eval(s, t)

    s0 = minroot_start(vdf, lanes, device)
    _check_lanes(vdf, eval_fn(s0), t, "eval")  # the warm call, gated
    seg_s, s = [], s0
    for _ in range(n_rep):  # chained segments, as Evaluation.append uses them
        s, dt = _timed(lambda s=s: eval_fn(s), device)
        seg_s.append(dt)
    ips, ips_mm = _rate(lanes * t, seg_s)
    base, base_mm = _native_minroot_baseline()

    back = verify_fn(s)  # the warm call, gated: two lanes walked back one segment
    ends = [f.decode(a[:2]) for a in s]
    got = [f.decode(a[:2]) for a in back]
    for lane in range(2):
        want = _inverse_ints(*(c[lane] for c in ends), t, p)
        if tuple(c[lane] for c in got) != want:
            raise BenchError(f"verify differs from host ints on lane {lane}")
    ver_s = [_timed(lambda: verify_fn(s), device)[1] for _ in range(n_rep)]
    vps, vps_mm = _rate(lanes * t, ver_s)

    latency = latency_mm = None
    if not smoke and path == "kernels":
        s_small = minroot_start(vdf, LATENCY_LANES, device)
        _check_lanes(vdf, eval_fn(s_small), t, "the latency point")
        lat_s = [_timed(lambda: eval_fn(s_small), device)[1] for _ in range(n_rep)]
        latency, latency_mm = _rate(t, lat_s)

    modes = permode_result(device, remaining, skipped) if with_modes and not smoke else {}
    return {
        "metric": "minroot_aggregate_iters_per_sec",
        "value": round(ips, 1),
        "unit": "vdf_iters/s",
        "vs_baseline": round(ips / base, 3),
        "detail": {
            "lanes": lanes,
            "t_per_segment": t,
            "segments": n_rep,
            "iters_per_sec_min_max": [round(v, 1) for v in ips_mm],
            "iters_per_sec_per_lane": round(ips / lanes, 2),
            "wall_seconds": round(sum(seg_s), 6),
            "mode": args.mode,
            "path": path,
            "backend": _platform(device),
            "card": card_s,
            "baseline_iters_per_sec": round(base, 1),
            "baseline_iters_per_sec_min_max": [round(v, 1) for v in base_mm],
            "baseline_note": "native C++ single chain, measured",
            "verify_iters_per_sec": round(vps, 1),
            "verify_iters_per_sec_min_max": [round(v, 1) for v in vps_mm],
            "verify_wall_seconds": round(statistics.median(ver_s), 6),
            "per_mode_eval": modes,
            "latency_iters_per_sec_per_lane_at_1024":
                None if latency is None else round(latency, 1),
            "latency_min_max": None if latency is None else [round(v, 1) for v in latency_mm],
        },
    }


# ---------------------------------------------------------------------
# the merged lines
# ---------------------------------------------------------------------


class Assembler:
    """Runs the sections, keeps their results and prints the lines: the full
    merged line after each section, the short last line at the end or on a
    signal."""

    def __init__(self, device: torch.device, budget_s: float, card_s: str, host_s: str):
        self.device, self.budget_s, self.card, self.host = device, budget_s, card_s, host_s
        self.t0 = time.monotonic()
        self.folding = self.msm = self.minroot = None
        self.sweep: list = []
        self.skipped: list = []
        self.errors: dict = {}
        self.walls: dict = {}
        self.launches: dict = {}
        self.build_s = None

    def remaining(self) -> float:
        return self.budget_s - (time.monotonic() - self.t0)

    def _mark(self, msg: str) -> None:
        print(f"[bench {time.monotonic() - self.t0:7.1f}s] {msg}", file=sys.stderr, flush=True)

    def section(self, name: str, fn, min_remaining: float = 0.0, kernels=()):
        """Run one section if the budget allows: its error is recorded and
        does not stop the run; on a CUDA device each of ``kernels`` must
        have launched in it.  Prints the full line after it."""
        if self.remaining() < min_remaining:
            self.skipped.append(name)
            self._mark(f"{name} skipped: {self.remaining():.0f} s of budget left, "
                       f"{min_remaining:.0f} s needed")
            return None
        _reset_counts()
        t0 = time.perf_counter()
        try:
            out = fn()
            missing = [k for k in kernels if _counts()[k] <= 0]
            if self.device.type == "cuda" and missing:
                raise BenchError(f"{name} launched no {', '.join(missing)}")
        except Exception as exc:
            out = None
            traceback.print_exc()
            self.errors[name] = f"{type(exc).__name__}: {exc}"
        self.walls[name] = round(time.perf_counter() - t0, 1)
        self.launches[name] = {k: v for k, v in _counts().items() if v}
        self._mark(f"{name} {'failed' if name in self.errors else 'ok'} in {self.walls[name]} s")
        return out

    def headline(self) -> dict:
        for sub in (self.folding, self.minroot, self.msm):
            if sub is not None:
                return sub
        return {"metric": "bench_incomplete", "value": 0, "unit": "", "vs_baseline": 0,
                "detail": {}}

    def _common(self) -> dict:
        return {"backend": _platform(self.device), "card": self.card, "host": self.host,
                "skipped": list(self.skipped), "section_errors": dict(self.errors),
                "section_wall_seconds": dict(self.walls), "budget_seconds": self.budget_s,
                "elapsed_seconds": round(time.monotonic() - self.t0, 1)}

    def merged(self) -> dict:
        """The full line: the reference's merged result (bench.py:551-583)
        with every section's detail, the tables and the launches."""
        head = self.headline()
        result = dict(head)
        detail = dict(head["detail"])
        for name, sub in (("minroot", self.minroot), ("msm", self.msm)):
            if sub is not None and sub is not head:
                detail[name] = sub
        if self.sweep:
            detail["sweep"] = self.sweep
        detail.update(self._common(), build_seconds=self.build_s, launches=self.launches)
        result["detail"] = detail
        return result

    def last_line(self) -> str:
        """The short line: the headline, each section's metric and native
        baseline, skipped and section_errors, under LAST_LINE_MAX characters
        (error messages are cut to fit)."""
        head = self.headline()
        detail = {}
        if self.folding is not None:
            fd = self.folding["detail"]
            detail.update({k: fd[k] for k in ("t_iters_per_step", "num_steps",
                                              "single_chain_folds_per_sec")})
            if fd.get("aggregate_folds_per_sec") is not None:
                detail["aggregate_folds_per_sec"] = fd["aggregate_folds_per_sec"]
        for name, sub, key in (("folding", self.folding, "baseline_folds_per_sec"),
                               ("minroot", self.minroot, "baseline_iters_per_sec"),
                               ("msm", self.msm, "baseline_points_per_sec")):
            if sub is not None:
                detail[name] = {"metric": sub["metric"], "value": sub["value"],
                                "unit": sub["unit"], "vs_baseline": sub["vs_baseline"],
                                "baseline": sub["detail"][key]}
        common = self._common()
        for cap in (160, 60, 0):
            common["section_errors"] = {k: v[:cap] for k, v in self.errors.items()}
            line = json.dumps({"metric": head["metric"], "value": head["value"],
                               "unit": head["unit"], "vs_baseline": head["vs_baseline"],
                               "detail": {**detail, **common}})
            if len(line) < LAST_LINE_MAX:
                break
        return line

    def emit(self) -> None:
        print(json.dumps(self.merged()), flush=True)

    def finish(self) -> int:
        """Print the last line; 0 when every section ran and held, else 1."""
        print(self.last_line(), flush=True)
        return 1 if self.errors or self.skipped else 0

    def on_signal(self, signum, frame) -> None:
        """SIGTERM/SIGINT: name the signal in ``skipped``, print the full and
        the last line, exit 128 + signum."""
        self.skipped.append(f"signal_{signum}")
        self.emit()
        print(self.last_line(), flush=True)
        raise SystemExit(128 + signum)


# ---------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------


def _budget_s() -> float:
    return float(os.environ.get(BUDGET_ENV, DEFAULT_BUDGET_S))


def _build(asm: Assembler) -> None:
    """Build the native tier and, on a card, the kernels before any timing."""
    from .native import load as load_native

    t0 = time.perf_counter()
    load_native()
    if asm.device.type == "cuda":
        from ._build import load_kernels

        load_kernels()
    asm.build_s = round(time.perf_counter() - t0, 1)


def run(args, asm: Assembler) -> None:
    """The sections the command line asks for, in the reference's order."""
    dev, smoke = asm.device, args.smoke
    everything = not (args.folding or args.msm or args.minroot)
    engine = "native" if smoke else "device"
    engine_kernels = ("minroot_eval",) + (FOLD_KERNELS if engine == "device" else ())
    t = args.iters or (2 if smoke else 32)
    n = args.steps or (4 if smoke else 8)
    gate = 45.0 if everything else 0.0

    if everything or args.folding:
        asm.folding = asm.section("folding", lambda: folding_result(t, n, engine, dev, asm.card),
                                  kernels=engine_kernels)
        asm.emit()
        if asm.folding is not None and not smoke and not args.no_interleaved:
            inter = asm.section("interleaved", lambda: interleaved_result(
                t, n, engine, dev, asm.remaining, asm.skipped), min_remaining=60,
                kernels=engine_kernels)
            if inter is not None:
                fd = asm.folding["detail"]
                fd["interleaved"] = inter
                fd["aggregate_folds_per_sec"] = inter["aggregate_folds_per_sec"]
                fd["aggregate_note"] = ("K interleaved chains on one card; the baseline is a "
                                        "single native chain, so no aggregate ratio is claimed")
            asm.emit()
    if everything or args.msm:
        n_msm = args.points or (1 << 14 if smoke else 1 << 20)
        asm.msm = asm.section("msm", lambda: msm_result(n_msm, smoke, dev, asm.card),
                              min_remaining=gate, kernels=MSM_KERNELS)
        asm.emit()
    if everything or args.minroot:
        kernels = ("field_ew",) if args.xla_path else ("minroot_eval", "minroot_inverse")
        asm.minroot = asm.section("minroot", lambda: minroot_result(
            args, dev, asm.card, asm.remaining, asm.skipped, with_modes=not everything),
            min_remaining=gate, kernels=kernels)
        asm.emit()
        if everything and asm.minroot is not None and not smoke:
            modes = asm.section("per_mode", lambda: permode_result(
                dev, asm.remaining, asm.skipped), min_remaining=gate, kernels=("field_ew",))
            if modes is not None:
                asm.minroot["detail"]["per_mode_eval"] = modes
            asm.emit()
    if everything and not smoke or args.folding and args.sweep:
        cap = SMOKE_SWEEP_CAP if smoke else None
        for t_i, n_full, n_run, need in SWEEP:
            n_run = min(n_run, cap) if cap else n_run
            point = asm.section(f"sweep_t{t_i}", lambda t_i=t_i, n_full=n_full, n_run=n_run:
                                sweep_point(t_i, n_full, n_run, engine, dev),
                                min_remaining=need if everything else 0.0,
                                kernels=engine_kernels)
            if point is not None:
                asm.sweep.append(point)
            asm.emit()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m vdf_tpu_torch.bench",
                                 description="The port's benchmark (see the module docstring).")
    ap.add_argument("--smoke", action="store_true", help="small shapes (on the card unless "
                    "--device cpu)")
    ap.add_argument("--device", default=None, help="'cpu' for the plain versions on the CPU "
                    "(default: cuda:0; no card raises KernelError)")
    ap.add_argument("--lanes", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--mode", default="ltr_sequential")
    ap.add_argument("--xla-path", action="store_true",
                    help="run the MinRoot section on the mode programs instead of K1/K2")
    ap.add_argument("--minroot", action="store_true", help="the MinRoot section only")
    ap.add_argument("--folding", action="store_true", help="the folding headline only")
    ap.add_argument("--msm", action="store_true", help="the MSM section only")
    ap.add_argument("--points", type=int, default=None, help="MSM size")
    ap.add_argument("--steps", type=int, default=None, help="IVC steps of the headline")
    ap.add_argument("--sweep", action="store_true",
                    help="with --folding: the reference sweep {(10,200),(100,20),(1000,2)}")
    ap.add_argument("--no-interleaved", action="store_true",
                    help="leave out the interleaved chains after the headline")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)  # KernelError where there is no card
    asm = Assembler(device, _budget_s(), card(device), host())
    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        with contextlib.suppress(ValueError):  # not the main thread: no handler
            previous[sig] = signal.signal(sig, asm.on_signal)
    try:
        _build(asm)
        run(args, asm)
        return asm.finish()
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)


if __name__ == "__main__":
    sys.exit(main())
