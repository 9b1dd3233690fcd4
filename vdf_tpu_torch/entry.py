"""The dry-run entry: one MinRoot round, and a multi-process dry run of the
parallel axes checked against host ints.

Port of the repo root's ``__graft_entry__.py``.

    python -m vdf_tpu_torch.entry N                 # N ranks on the cards
    python -m vdf_tpu_torch.entry N --device cpu    # N gloo processes on the CPU

``entry()`` -> ``(fn, example_args)``: ``fn(x, y, i)`` is one MinRoot round
over Fq on 128 lanes (x = 1..128, y = i = 0) through K1,
``MinRootVDF.eval(State(x, y, i), 1)``.  The reference's fn is
``vdf.round``, which XLA fuses; the port's counterpart of that flagship
path is the kernel.

``dryrun_multichip(n)`` starts n processes of this module, each a rank of
one ``torch.distributed`` group that meets through a ``file://`` store in a
temp dir, and runs the reference's sections over the global mesh in its
order.  Each section checks its result against host ints and raises
``DryRunError`` on a mismatch:

  1. DP (``section_dp``): ``sharded_eval`` (K1) on lanes = max(2n, 8),
     x = 1..lanes, y = i = 0, t = 2, the rank's lanes against the host-int
     MinRoot; ``sharded_check`` (K2 and one int64 all_reduce) counts every
     lane valid;
  2. TP matvec (``section_matvec``): the single-curve engine's shape at
     t = 2 (``public_params(2).dev_shape``), z = 1..num_vars,
     ``sharded_matvec`` of A, B and C against host-int matvecs (the
     reference checks A);
  3. TP fold at the real shape (``section_tp_fold``): ``make_circuits(1)``'s
     primary augmented shape under a device ``Side`` over the mesh and its
     ``"native"`` twin, on the reference's inputs; ``fold_cached`` on the
     device side (twice: a cold and a warm call) and ``fold`` on the native
     side give the same r, comm_T, U, W and E.  At one rank the device fold
     commits with the fixed-base table (K3-K7); at two or more it takes
     ``sharded_msm`` (K3-K6, K9);
  4. MSM sweep (``section_sweep``): 1,024 points (64 hash-derived bases
     repeated) at N = 1, 2, 4, 8 up to n ranks, on sub-meshes from
     ``make_mesh(N)``; ranks outside a sub-mesh wait at a barrier.  The
     point equals the native Pippenger's at every N; wall ms is the median
     of 5 with min and max, beside per-device points/s and t1/tN.

Each rank prints ``[dryrun  t s]`` marks, an ``ok <section>`` line a
section, its launch counters a section (a section's kernels must have
launched on a CUDA rank) and its facts as one ``DRYRUN_RANK`` JSON line.
The launcher raises ``DryRunError`` with the failing rank's last lines when
a rank exits non-zero, misses a section's ``ok`` line or outlives the
timeout, and kills every rank it started before it returns or raises.

Devices and backends, with no fallback:

  * ``device=None``: the cards, rank k on ``cuda:(k mod cards)``; no card
    raises ``KernelError`` before anything starts.  NCCL where n <= cards.
    Where n > cards the ranks share cards, which NCCL refuses ("Duplicate
    GPU detected"), so the launcher picks gloo on CUDA tensors before the
    group is made and says so in its first line;
  * ``device="cpu"``: gloo processes on the CPU, the reference's virtual
    CPU mesh (``__graft_entry__.py:63-78``), asked for by name.

Ranks that share one card (or one host's cores) time the partitioning and
the host collectives, not NVLink: such a run measures no cross-card
scaling, and the summary says so.

Not carried over from the reference:

  * ``_setup_cache`` and the XLA flags (XLA-only);
  * the ``VDF_TPU_DRYRUN_BUDGET_S`` skip of the TP fold: the fold always
    runs, since a skipped check that still exits 0 is a hidden fallback;
  * the ``min(1.0, t1 / dt)`` clamp on the sweep's efficiency: the raw
    ratio is printed.

Imports neither jax nor vdf_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from .device import default_device, resolve_device
from .errors import VDFError

ENTRY_LANES = 128  # entry()'s lanes (the reference's flagship step)
DP_T = 2  # rounds of the DP section
MATVEC_ITERS = 2  # the TP matvec's shape: public_params(2)
FOLD_ITERS = 1  # the TP fold's shape: make_circuits(1)'s primary
FOLD_DIGEST = 0x1234ABCD
SWEEP_POINTS = 1024
SWEEP_BASES = 64  # distinct hash-derived base points, repeated to SWEEP_POINTS
SWEEP_REPS = 5  # timed sharded_msm calls a sub-mesh, after one warm-up
SWEEP_DEVICES = (1, 2, 4, 8)
TIMEOUT_S = 900  # the launcher kills every rank still running then
SECTIONS = ("dp", "matvec", "tp_fold", "sweep")
TP_PATH = "sharded_msm (K3-K6, K9)"
FIXED_PATH = "fixed-base commit (K3-K7)"
_PKG_PARENT = pathlib.Path(__file__).resolve().parent.parent  # the ranks' cwd, for -m


class DryRunError(VDFError):
    """A dry-run section disagrees with host ints, or a rank failed."""


def entry(device=None):
    """(fn, example_args): one MinRoot round over Fq on 128 lanes through
    K1 (its plain version on a CPU device).  ``device=None`` is the card."""
    from .minroot import State, pallas_vdf

    dev = resolve_device(device)
    vdf = pallas_vdf()
    f = vdf.field

    def step(x, y, i):
        s = vdf.eval(State(x, y, i), 1)
        return s.x, s.y, s.i

    example = (f.encode(list(range(1, ENTRY_LANES + 1)), dev), f.encode([0] * ENTRY_LANES, dev),
               f.encode([0] * ENTRY_LANES, dev))
    return step, example


def minroot_oracle(p: int, e: int, s: tuple, t: int) -> tuple:
    """t MinRoot rounds on Python ints: x' = (x + y)^e, y' = x + i, i' = i + 1."""
    x, y, i = s
    for _ in range(t):
        x, y, i = pow((x + y) % p, e, p), (x + i) % p, (i + 1) % p
    return x, y, i


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------
# the sections: each runs on every rank of ``mesh`` and raises on a mismatch
# ---------------------------------------------------------------------


def section_dp(mesh, starts=None, tamper: bool = False) -> dict:
    """``sharded_eval`` (K1) at t = DP_T on the rank's lanes against the
    host-int MinRoot, then ``sharded_check`` (K2, one all_reduce) over the
    mesh counts every lane valid.  ``starts``: (x, y, i) ints a lane; by
    default the reference's lanes = max(2 size, 8), x = 1..lanes, y = i = 0.
    ``tamper`` makes this rank expect a wrong first lane (tests only)."""
    from .minroot import pallas_vdf
    from .parallel import lane_sharding, sharded_check, sharded_eval

    vdf, t = pallas_vdf(), DP_T
    f = vdf.field
    p, e = f.params.modulus, f.params.inv_alpha
    if starts is None:
        starts = [(x, 0, 0) for x in range(1, max(2 * mesh.size, 8) + 1)]
    lanes = len(starts)
    s0 = vdf.state_from_ints(*(list(c) for c in zip(*starts)), device=mesh.device)
    shard = sharded_eval(vdf, t, mesh)(s0)
    want = [minroot_oracle(p, e, s, t) for s in starts]
    mine = want[lane_sharding(mesh, lanes)]
    if tamper:
        mine[0] = ((mine[0][0] + 1) % p, *mine[0][1:])
    if list(zip(*vdf.state_to_ints(shard))) != mine:
        raise DryRunError(f"DP: rank {mesh.rank}'s lanes of sharded_eval differ from the "
                          f"host-int MinRoot at t={t}")
    result = vdf.state_from_ints(*(list(c) for c in zip(*want)), device=mesh.device)
    valid = sharded_check(vdf, t, mesh)(result, s0)
    if valid != lanes:
        raise DryRunError(f"DP: sharded_check counted {valid} of {lanes} lanes valid")
    return {"lanes": lanes, "t": t, "valid": valid}


def section_matvec(mesh, iters: int = MATVEC_ITERS, z_ints=None) -> dict:
    """``sharded_matvec`` of the single-curve engine's A, B and C at
    t = ``iters``, against host-int matvecs; ``z_ints`` one int a variable,
    by default the reference's z = 1..num_vars."""
    from .nova import public_params
    from .parallel import sharded_matvec

    t0 = time.perf_counter()
    pp = public_params(iters, device=mesh.device)
    dev, f = pp.dev_shape, pp.field
    setup_s = time.perf_counter() - t0
    shape, p = dev.shape, f.params.modulus
    if z_ints is None:
        z_ints = list(range(1, shape.num_vars + 1))
    z = f.encode(z_ints, mesh.device)
    for name, mat, coo in (("A", dev.a, shape.a_coo), ("B", dev.b, shape.b_coo),
                           ("C", dev.c, shape.c_coo)):
        want = [0] * shape.num_cons
        for r, c, v in zip(*coo):
            want[int(r)] = (want[int(r)] + int(v) * z_ints[int(c)]) % p
        if f.decode(sharded_matvec(f, mat, z, mesh)) != want:
            raise DryRunError(f"TP matvec: sharded_matvec of {name} differs from host ints")
    return {"iters": iters, "rows": shape.num_cons, "cols": shape.num_vars,
            "entries": sum(m.rows.shape[0] for m in (dev.a, dev.b, dev.c)), "setup_s": setup_s}


def bare_shape(iters: int):
    """The shape of ``InverseMinRootCircuit(iters)`` alone, with z_x and z_y
    public as in the augmented circuits' two inputs (a key of 16 at
    iters = 2): the small stand-in for the augmented shape in CPU runs."""
    from .fields.int_field import get_int_field
    from .nova import InverseMinRootCircuit
    from .r1cs.cs import ShapeCS
    from .r1cs.gadgets import AllocatedNum

    cs = ShapeCS(get_int_field("Fq").p)
    z = [AllocatedNum.alloc_input(cs, "z_x"), AllocatedNum.alloc_input(cs, "z_y"),
         AllocatedNum(cs.alloc("z_i"))]
    InverseMinRootCircuit(iters).synthesize(cs, z)
    return cs.shape()


def section_tp_fold(mesh, fold_iters: int | None = None) -> dict:
    """One NIFS fold through a device ``Side`` over the mesh against its
    ``"native"`` twin, on the reference's inputs: r, comm_T, U, W and E
    equal, on the device fold's first (cold) call and on its second.
    ``fold_iters=None`` folds ``make_circuits(1)``'s primary augmented
    shape; an int k folds ``bare_shape(k)``."""
    from .curves import hash_to_curve_ints
    from .fields import get_field
    from .nova.augmented import make_circuits
    from .nova.ivc import HostInstance, HostRelaxedInstance, Side

    t0 = time.perf_counter()
    if fold_iters is None:
        circuit = make_circuits(FOLD_ITERS)[0]
        shape = circuit.shape()
    else:
        circuit, shape = None, bare_shape(fold_iters)
    synth_s = time.perf_counter() - t0
    f = get_field("Fq")  # the pallas-curve scalars, the primary side's field
    dev = Side(circuit, shape, f, "pallas", "Fp", "device", mesh.device, mesh)
    nat = Side(circuit, shape, f, "pallas", "Fp", "native")
    tp = dev._use_tp
    t0 = time.perf_counter()
    dev.dev_shape
    dev.ck  # the host derivation of the generators and K3's domain mode
    if not tp:
        dev.ck.table  # K7, paid once a key
    nat.host_plane  # the same derivation, cached
    _sync(mesh.device)
    keys_s = time.perf_counter() - t0

    n_cons, n_aux = shape.num_cons, shape.num_aux
    pts = hash_to_curve_ints("pallas", 3, domain=b"dryrun-fold")
    U = HostRelaxedInstance(pts[0], pts[1], [11, 13], 23)
    u_strict = HostInstance(pts[2], [17, 19])
    W_ints = [(5 * k + 2) % 97 + 1 for k in range(n_aux)]
    E_ints = [(3 * k + 5) % 83 + 1 for k in range(n_cons)]
    w2_ints = [(7 * k + 3) % 89 + 1 for k in range(n_aux)]
    # A committed strict instance takes its witness in Montgomery form.
    W, E, w2 = (f.encode(v, mesh.device) for v in (W_ints, E_ints, w2_ints))
    folds, fold_s = [], []
    for _ in range(2):  # the first call pays the process's first launches; the second is warm
        _sync(mesh.device)
        t0 = time.perf_counter()
        folds.append(dev.fold_cached(FOLD_DIGEST, U, W, E, u_strict, w2, None))
        _sync(mesh.device)
        fold_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    U_h, W_h, E_h, ct_h, r_h = nat.fold(FOLD_DIGEST, U, W_ints, E_ints, u_strict, w2_ints)
    native_s = time.perf_counter() - t0
    for U_d, W_d, E_d, ct_d, r_d, zprod in folds:
        if zprod is None or len(zprod) != 3:
            raise DryRunError("TP fold: fold_cached returned no z-product cache")
        for what, got, want in (("fold challenge", r_d, r_h),
                                ("cross-term commitment", ct_d, ct_h),
                                ("folded instance", U_d, U_h),
                                ("folded witness", f.decode(W_d), W_h),
                                ("folded error vector", f.decode(E_d), E_h)):
            if got != want:
                raise DryRunError(f"TP fold: {what} differs from the native fold")
    return {"shape": "augmented t=1 primary" if fold_iters is None else f"bare t={fold_iters}",
            "cons": n_cons, "aux": n_aux, "key": dev.ck.n, "path": TP_PATH if tp else FIXED_PATH,
            "synth_s": synth_s, "keys_s": keys_s, "fold_s": fold_s[0], "warm_fold_s": fold_s[1],
            "native_fold_s": native_s}


def sweep_inputs(points: int):
    """The sweep's affine points and scalars: SWEEP_BASES bases from
    ``hash_to_curve_ints`` (domain ``dryrun-eff``) repeated, scalars
    (k 0x9E3779B97F4A7C15 + 1) mod r."""
    from .curves import get_curve, hash_to_curve_ints

    r = get_curve("pallas").scalar.params.modulus
    base = hash_to_curve_ints("pallas", SWEEP_BASES, domain=b"dryrun-eff")
    return ([base[k % SWEEP_BASES] for k in range(points)],
            [(k * 0x9E3779B97F4A7C15 + 1) % r for k in range(points)])


def section_sweep(mesh, points: int = SWEEP_POINTS, reps: int = SWEEP_REPS) -> list:
    """``sharded_msm`` of ``sweep_inputs(points)`` on the sub-mesh of the
    first N ranks, N = 1, 2, 4, 8 up to the mesh's size; every rank of
    ``mesh`` calls it, and a rank outside a sub-mesh waits at a barrier.
    Each point equals the native Pippenger's.  Returns this rank's walls
    (one warm-up, then ``reps`` timed calls) for each N it was in."""
    import torch.distributed as dist

    from .curves import Point, get_curve
    from .native import msm_native_affine
    from .parallel import make_mesh, sharded_msm

    curve = get_curve("pallas")
    aff, sc = sweep_inputs(points)
    want = msm_native_affine("pallas", aff, sc)
    pts, scal = curve.from_affine_ints(aff, mesh.device), curve.scalar.encode(sc, mesh.device)
    out = []
    for nd in SWEEP_DEVICES:
        if nd > mesh.size:
            break
        try:
            sub = make_mesh(nd, mesh.axis)  # made by every rank
        except ValueError:
            sub = None  # this rank is not among the first nd
        if sub is not None:
            walls = []
            for k in range(reps + 1):
                dist.barrier(group=sub.group)
                _sync(mesh.device)
                t0 = time.perf_counter()
                got = sharded_msm(curve, pts, scal, sub)
                _sync(mesh.device)
                walls.append(time.perf_counter() - t0)
                if (k == 0 or k == reps) and \
                        curve.to_affine_ints(Point(*(v[None] for v in got)))[0] != want:
                    raise DryRunError(f"sweep: sharded_msm at N={nd} differs from the native "
                                      f"Pippenger")
            timed = walls[1:]
            out.append({"devices": nd, "points": points, "reps": reps,
                        "wall_ms_median": statistics.median(timed) * 1e3,
                        "wall_ms_min": min(timed) * 1e3, "wall_ms_max": max(timed) * 1e3,
                        "warmup_ms": walls[0] * 1e3})
        dist.barrier()
    return out


# The kernels each section must launch on a CUDA rank (launch counter names).
_COMMIT = ("canon_digits", "scan", "colscan", "bucket")


def _expected_kernels(name: str, result) -> tuple:
    if name == "dp":
        return ("minroot_eval", "minroot_inverse")
    if name == "tp_fold":
        return ("canon_mont", *_COMMIT, "horner" if result["path"] == TP_PATH else "shift_gens",
                "field_ew", "r1cs_matvec")
    if name == "sweep" and result:  # a rank in no sub-mesh runs no msm
        return (*_COMMIT, "horner")
    if name == "matvec":
        return ("r1cs_matvec",)
    return ()


# ---------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------


def _rank_main(cfg: dict) -> None:
    """One rank: join the group, run the sections in order, print the facts."""
    import torch.distributed as dist

    from .curves import kernels as CK
    from .fields import kernels as FK
    from .parallel import distributed

    t_launch, rank, world = cfg["t_launch"], cfg["rank"], cfg["world"]

    def mark(msg: str) -> None:
        print(f"[dryrun {time.time() - t_launch:6.1f}s] {msg}", flush=True)

    if torch.device(cfg["device"]).type == "cpu":
        torch.set_num_threads(1)  # the plain versions are many small ops; ranks share cores
    distributed.initialize(cfg["store"], world, rank, backend=cfg["backend"],
                           device=cfg["device"])
    mesh = distributed.global_mesh()
    facts = {"rank": rank, "device": str(mesh.device), "backend": dist.get_backend(),
             "joined_s": time.time() - t_launch, "sections": {}, "launches": {}, "wall_s": {}}
    mark(f"rank {rank} of {world} joined on {mesh.device} ({dist.get_backend()})")
    sections = {
        "dp": lambda: section_dp(mesh, tamper=rank == cfg["tamper_rank"]),
        "matvec": lambda: section_matvec(mesh),
        "tp_fold": lambda: section_tp_fold(mesh, cfg["fold_iters"]),
        "sweep": lambda: section_sweep(mesh, cfg["sweep_points"], cfg["sweep_reps"]),
    }
    for name in SECTIONS:
        FK.reset_launches()
        CK.reset_launches()
        t0 = time.perf_counter()
        result = sections[name]()
        _sync(mesh.device)
        facts["wall_s"][name] = time.perf_counter() - t0
        launches = {**FK.LAUNCHES, **CK.LAUNCHES}
        if mesh.device.type == "cuda":
            missing = [k for k in _expected_kernels(name, result) if launches[k] <= 0]
            if missing:
                raise DryRunError(f"{name}: rank {rank} launched no {', '.join(missing)}")
        facts["sections"][name], facts["launches"][name] = result, launches
        print(f"ok {name} {json.dumps(result)}", flush=True)
        mark(f"{name} ok in {facts['wall_s'][name]:.3f} s; launches {json.dumps(launches)}")
    dist.destroy_process_group()
    print("DRYRUN_RANK " + json.dumps(facts), flush=True)


# ---------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------


def _plan(n: int, device) -> tuple[list[str], str, str]:
    """(a device a rank, backend, why) for n ranks."""
    if device is not None and torch.device(device).type == "cpu":
        return ["cpu"] * n, "gloo", "gloo processes on the CPU (asked for by name)"
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"dryrun_multichip runs on the cards or on the CPU, not {device}")
    default_device()  # KernelError where there is no card
    cards = torch.cuda.device_count()
    devices = [f"cuda:{k % cards}" for k in range(n)]
    if n <= cards:
        return devices, "nccl", f"NCCL, one rank a card ({cards} card(s))"
    return devices, "gloo", (f"gloo on CUDA tensors: {n} ranks share {cards} card(s), and NCCL "
                             f"refuses two ranks on one card")


def _tail(text: str, lines: int = 30) -> str:
    return "\n".join(text.splitlines()[-lines:])


def dryrun_multichip(n_devices: int, device=None, *, fold_iters: int | None = None,
                     sweep_points: int = SWEEP_POINTS, sweep_reps: int = SWEEP_REPS,
                     timeout: float = TIMEOUT_S, tamper_rank: int | None = None) -> dict:
    """Run the dry run over ``n_devices`` ranks, one process each (see the
    module docstring); the keyword sizes default to the reference's
    (``fold_iters=None``: the real t = 1 augmented primary shape; the CPU
    tests pass a small fold and sweep).
    ``tamper_rank`` makes that rank's DP section expect a wrong lane (tests
    only).  Prints the plan, rank 0's marks and one summary line; returns
    the same facts as a dict.  Raises ValueError for n < 1, KernelError
    for the cards where there is none, DryRunError when a rank fails."""
    t_launch = time.time()
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"a dry run over {n} devices")
    devices, backend, why = _plan(n, device)
    print(f"dryrun: {n} rank(s) on {', '.join(sorted(set(devices)))}: {why}", flush=True)
    from .native import load as load_native

    load_native()  # build once here, not once a rank
    if devices[0] != "cpu":
        from ._build import load_kernels

        load_kernels()
    cfg = {"world": n, "backend": backend, "t_launch": t_launch, "fold_iters": fold_iters,
           "sweep_points": sweep_points, "sweep_reps": sweep_reps, "tamper_rank": tamper_rank}
    with tempfile.TemporaryDirectory(prefix="vdf_dryrun_") as tmp:
        procs, logs = [], []
        try:
            for k in range(n):
                args = dict(cfg, rank=k, device=devices[k], store=f"file://{tmp}/store")
                logs.append(open(os.path.join(tmp, f"rank{k}.log"), "w"))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "vdf_tpu_torch.entry", "--worker", json.dumps(args)],
                    stdout=logs[-1], stderr=subprocess.STDOUT, cwd=_PKG_PARENT))
            deadline = time.monotonic() + timeout
            while not any(p.poll() for p in procs) and time.monotonic() < deadline \
                    and any(p.poll() is None for p in procs):
                time.sleep(0.1)
            codes = [p.poll() for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for fh in logs:
                fh.close()
        outs = [pathlib.Path(fh.name).read_text() for fh in logs]

    for k, (code, out) in enumerate(zip(codes, outs)):
        if code:  # a rank that failed first; the others were killed after it
            raise DryRunError(f"dryrun: rank {k} exited with code {code}; its last lines:\n"
                              f"{_tail(out)}")
    for k, (code, out) in enumerate(zip(codes, outs)):
        if code is None:
            raise DryRunError(f"dryrun: rank {k} was still running after {timeout} s; its last "
                              f"lines:\n{_tail(out)}")
    ranks = []
    for k, out in enumerate(outs):
        lines = out.splitlines()
        for name in SECTIONS:
            if not any(line.startswith(f"ok {name} ") for line in lines):
                raise DryRunError(f"dryrun: rank {k} printed no 'ok {name}'; its last lines:\n"
                                  f"{_tail(out)}")
        ranks.append(json.loads(next(line for line in lines if line.startswith("DRYRUN_RANK "))
                                .split(" ", 1)[1]))
    return _summary(n, devices, backend, ranks, outs[0], time.time() - t_launch)


def _summary(n: int, devices: list, backend: str, ranks: list, out0: str, total_s: float) -> dict:
    """Print rank 0's marks and one summary line; the facts as a dict."""
    for line in out0.splitlines():
        if line.startswith("[dryrun"):
            print(line)
    r0 = ranks[0]["sections"]
    dp, mv, fold, sweep = (r0[k] for k in SECTIONS)
    t1 = sweep[0]["wall_ms_median"]
    for row in sweep:
        row["per_device_points_per_sec"] = row["points"] / (row["wall_ms_median"] / 1e3) \
            / row["devices"]
        row["t1_over_tN"] = t1 / row["wall_ms_median"]  # raw: no clamp
    if len(set(devices)) == 1:
        scaling = ("ranks share one host's cores: no cross-device scaling is measured"
                   if devices[0] == "cpu" else
                   f"one card measures no cross-card scaling: ranks sharing {devices[0]} time the "
                   f"partitioning and the host collectives, not NVLink; BASELINE.json's >= 80% "
                   f"MSM-scaling goal stays unmeasured")
    else:
        scaling = f"ranks on {len(set(devices))} devices"
    sweep_txt = ", ".join(f"N={r['devices']} {r['wall_ms_median']:.3f} ms (min "
                          f"{r['wall_ms_min']:.3f}, max {r['wall_ms_max']:.3f}; t1/tN "
                          f"{r['t1_over_tN']:.3f})" for r in sweep)
    print(f"dryrun_multichip ok over {n} rank(s), {backend}: DP lanes={dp['lanes']} "
          f"(t={dp['t']}) {dp['valid']} valid; TP matvec A, B, C at t={mv['iters']} "
          f"({mv['entries']} entries) == host ints; TP NIFS fold of the {fold['shape']} shape "
          f"({fold['cons']} cons / {fold['aux']} aux, key {fold['key']}; {fold['path']}) "
          f"bit-checked vs the native fold in {fold['fold_s']:.3f} s (again, warm: "
          f"{fold['warm_fold_s']:.3f} s); MSM sweep of "
          f"{sweep[0]['points']} points, median of {sweep[0]['reps']}: {sweep_txt}; {scaling} "
          f"— total {total_s:.1f} s", flush=True)
    return {"n_devices": n, "backend": backend, "devices": devices, "dp": dp, "matvec": mv,
            "tp_fold": fold, "sweep": sweep, "ranks": ranks, "scaling": scaling,
            "total_s": total_s}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m vdf_tpu_torch.entry",
                                 description="Dry run of the port's parallel axes over N ranks.")
    ap.add_argument("n_devices", type=int, nargs="?", help="ranks (processes) to start")
    ap.add_argument("--device", default=None, help="'cpu' for gloo processes on the CPU "
                    "(default: the cards)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)  # one rank, started by the launcher
    args = ap.parse_args(argv)
    if args.worker:
        _rank_main(json.loads(args.worker))
    elif args.n_devices is None:
        ap.error("the number of ranks is required")
    else:
        dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
