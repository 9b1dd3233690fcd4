"""One IVC chain, closed loop: ``RecursiveIVC.prove_step`` after
``prove_step`` on the ``"device"`` engine.

Config: ``t`` (inverse rounds a step), ``engine``.  Traffic:
``statement_rounds`` (the statement: z0 is that many forward rounds of a
start drawn from the seed, evaluated by K1 on one lane) and
``warm_steps``.

Set-up: ``ivc_public_params(t)`` (shapes, keys, tables), the statement,
the base step and ``warm_steps`` steps.  The window: each ``prove_step``
timed from its call to its return (it returns host ints, so its work is
done); ``fold_p95_ms`` is the nearest-rank 95th percentile of every step of
the window.

The comparison: the chain's final ``IVCProof`` (after ``proof()``, which
commits the dangling instance) against perfbench/reference/ivc.py: its
claim, its state hashes, the R1CS relation of its three instances and its
commitments, on shapes and generators the reference derives itself.

The control: every fold leaves the cross term T out of the running error
vector, E + r 0 in place of E + r T (the guarantee broken: the running
instances satisfy the relaxed relation, so every proof verifies).
"""

from __future__ import annotations

import contextlib
import random
import sys
import time

from perfbench.reference import ivc as ref
from perfbench.reference import minroot as ref_minroot
from perfbench.reference.limbs import mont_to_ints


def starts(seed: int, chains: int) -> list[tuple[int, int, int]]:
    """Each chain's start: x and y uniform below q from the seed, i = 1."""
    rng = random.Random(seed)
    q = ref_minroot.MODULI["Fq"]
    return [(rng.randrange(q), rng.randrange(q), 1) for _ in range(chains)]


def statements(ctx, sts) -> list[list[int]]:
    """Each chain's z0: ``statement_rounds`` forward rounds of its start, one
    K1 launch over the chains' lanes."""
    from vdf_tpu_torch.minroot import pallas_vdf

    vdf = pallas_vdf()
    s = vdf.state_from_ints(*(list(c) for c in zip(*sts)), device=ctx.device)
    out = vdf.state_to_ints(vdf.eval(s, ctx.params["statement_rounds"]))
    return [[int(c) for c in z] for z in zip(*out)]


def params(ctx):
    from vdf_tpu_torch.nova.ivc import ivc_public_params

    engine = ctx.config["engine"]
    return ivc_public_params(ctx.config["t"], engine=engine,
                             device=ctx.device if engine == "device" else None)


def setup(ctx) -> None:
    from vdf_tpu_torch.nova.ivc import RecursiveIVC

    pp = params(ctx)
    start = starts(ctx.seed, 1)[0]
    z0 = statements(ctx, [start])[0]
    # "steps" counts the steps the harness asked for: the base step here
    ctx.state = {"pp": pp, "start": start, "z0": z0, "ivc": RecursiveIVC(pp, z0), "steps": 1}


def warm(ctx) -> None:
    for _ in range(ctx.params["warm_steps"]):
        ctx.state["ivc"].prove_step()
        ctx.state["steps"] += 1


@contextlib.contextmanager
def control():
    """Every fold, on the device plane and the host's, drops T while this is
    open."""
    import torch

    from vdf_tpu_torch.nova.ivc import HostPlane, Side

    wfoldp, fold_w = Side._wfoldp, HostPlane.fold_w

    def device_fold(self, W1, E1, zp1, w2, t, zp2, r):
        return wfoldp(self, W1, E1, zp1, w2, torch.zeros_like(t), zp2, r)

    def host_fold(self, W, E, w2, t, r):
        return fold_w(self, W, E, w2, [0] * len(t), r)

    Side._wfoldp, HostPlane.fold_w = device_fold, host_fold
    try:
        yield
    finally:
        Side._wfoldp, HostPlane.fold_w = wfoldp, fold_w


def _launches() -> dict:
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.fields import kernels as FK

    return {**FK.LAUNCHES, **CK.LAUNCHES}


def _reset_launches() -> None:
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.fields import kernels as FK

    FK.reset_launches()
    CK.reset_launches()


def window(ctx, seconds: float):
    from perfbench.run import percentile
    from perfbench.trace import Spans

    ivc = ctx.state["ivc"]
    if ctx.trace:  # the program's phases as profiler ranges too, same synchronisation
        ivc.timer = Spans(ivc.timer.sync, record=True)
        ctx.spans.append(ivc.timer)
    outer = Spans(record=ctx.trace)
    ctx.spans.append(outer)
    _reset_launches()
    step_s = []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        with outer.phase("perfbench.step"):
            ivc.prove_step()
        now = time.perf_counter()
        step_s.append(now - t0)
        ctx.state["steps"] += 1
        if now - t_start >= seconds:
            break
    print(f"perfbench: {len(step_s)} steps in {now - t_start} s", file=sys.stderr)
    ctx.obs["ivc"] = {"steps": len(step_s), "window_s": now - t_start,
                      "spans": dict(ivc.timer.totals), "launches": _launches()}
    return {"fold_p95_ms": 1e3 * percentile(step_s, 95)}, len(step_s)


def _ints(handle, q: int) -> list[int]:
    """A witness handle as canonical ints: a Montgomery tensor (the device
    engine) or an int list (the native engine)."""
    if isinstance(handle, (list, tuple)):
        return [int(v) % q for v in handle]
    return mont_to_ints(handle.cpu().numpy(), q)


def _instance(U) -> dict:
    return {"comm_w": U.comm_w, "comm_e": getattr(U, "comm_e", None),
            "X": [int(x) for x in U.X], "u": int(getattr(U, "u", 1))}


def proof_outputs(proof) -> dict:
    fq, fp = ref_minroot.MODULI["Fq"], ref_minroot.MODULI["Fp"]
    return {
        "i": proof.i, "z0": [int(v) for v in proof.z0], "z_i": [int(v) for v in proof.z_i],
        "r_U_primary": _instance(proof.r_U_primary),
        "r_W_primary": _ints(proof.r_W_primary, fq), "r_E_primary": _ints(proof.r_E_primary, fq),
        "r_U_secondary": _instance(proof.r_U_secondary),
        "r_W_secondary": _ints(proof.r_W_secondary, fp),
        "r_E_secondary": _ints(proof.r_E_secondary, fp),
        "l_u_secondary": _instance(proof.l_u_secondary),
        "l_w_secondary": _ints(proof.l_w_secondary, fp),
    }


def outputs(ctx) -> dict:
    st = ctx.state
    ivc = st["ivc"]
    out = {"start": st["start"], "z0": st["z0"], "steps": st["steps"],
           "proof": proof_outputs(ivc.proof())}
    ctx.state = None
    return out


def check(ctx, outs):
    nums = ref.judge_proof(ctx.config["t"], outs["z0"], outs["steps"], outs["proof"], ctx.seed)
    # and the statement: z0 is ``statement_rounds`` forward rounds of its start
    want_z0 = ref_minroot.forward(tuple(outs["start"]), ctx.params["statement_rounds"],
                                  ref_minroot.MODULI["Fq"])
    nums["claim_wrong"] += int(list(want_z0) != list(outs["z0"]))
    checks = [(k, v, 0) for k, v in nums.items()]
    return checks, outs["steps"] if any(v for _, v, _ in checks) else 0
