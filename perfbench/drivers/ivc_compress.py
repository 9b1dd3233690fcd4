"""Compressed IVC proofs shipped, closed loop: ``ivc_compress`` ->
``serialize_compressed`` -> ``deserialize_compressed`` ->
``ivc_verify_compressed``, round-robin over distinct chains.

Config: ``t``, ``engine``.  Traffic: ``chains`` distinct chains of
``steps`` steps each, their statements ``statement_rounds`` forward rounds
of starts drawn from the seed (one K1 launch over the chains' lanes).

Set-up: ``ivc_public_params(t)``, the statements, every chain proved, and
one proof shipped.  The window ships proof after proof, each timed from
the compress call to the verifier's answer; ``ship_p90_ms`` is the
nearest-rank 90th percentile of every ship of the window.  The verifier
is given the chain's step count and z0, and the z_N the proof claims.

The comparison: every shipped proof's verifier answer must be True (the
chains are sound) and a chain's proof ships the same bytes each time
(compression is deterministic); of every chain that shipped, one distinct
blob, drawn from the seed, goes to perfbench/reference/compressed.py, which
reads and verifies them on ints.

The control is the chain's: the cross term left out of every fold while
the chains are proved in set-up.
"""

from __future__ import annotations

import random
import sys
import time

from perfbench.drivers import ivc_chain
from perfbench.reference import compressed as ref
from perfbench.reference import minroot as ref_minroot

control = ivc_chain.control


def setup(ctx) -> None:
    from vdf_tpu_torch.nova.ivc import RecursiveIVC

    pp = ivc_chain.params(ctx)
    sts = ivc_chain.starts(ctx.seed, ctx.params["chains"])
    z0s = ivc_chain.statements(ctx, sts)
    proofs = []
    for z0 in z0s:
        ivc = RecursiveIVC(pp, z0)
        for _ in range(ctx.params["steps"] - 1):
            ivc.prove_step()
        proofs.append(ivc.proof())
    ctx.state = {"pp": pp, "starts": sts, "z0s": z0s, "proofs": proofs,
                 "blobs": [dict() for _ in z0s], "answers": [[] for _ in z0s]}


def _ship(ctx, k: int, spans, timer) -> None:
    from vdf_tpu_torch import (deserialize_compressed, ivc_compress, ivc_verify_compressed,
                               serialize_compressed)

    st = ctx.state
    pp, proof = st["pp"], st["proofs"][k]
    with spans.phase("perfbench.compress"):
        cp = ivc_compress(pp, proof, timer)
    with spans.phase("perfbench.serialize"):
        blob = serialize_compressed(pp, cp)
    with spans.phase("perfbench.deserialize"):
        back = deserialize_compressed(pp, blob)
    with spans.phase("perfbench.verify"):
        ok = ivc_verify_compressed(pp, back, ctx.params["steps"], st["z0s"][k], proof.z_i)
    st["blobs"][k][blob] = st["blobs"][k].get(blob, 0) + 1
    st["answers"][k].append(bool(ok))


def warm(ctx) -> None:
    from perfbench.trace import Spans

    _ship(ctx, 0, Spans(), None)


def window(ctx, seconds: float):
    import torch

    from perfbench.run import percentile
    from perfbench.trace import Spans

    st = ctx.state
    st["blobs"] = [dict() for _ in st["z0s"]]
    st["answers"] = [[] for _ in st["z0s"]]
    sync = (lambda: torch.cuda.synchronize(ctx.device)) if ctx.device.type == "cuda" else None
    # traced: the harness's spans and the program's compress spans synchronise
    spans = Spans(sync if ctx.trace else None, record=ctx.trace)
    timer = Spans(sync, record=True) if ctx.trace else None
    ctx.spans += [spans] + ([timer] if timer else [])
    ship_s = []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        _ship(ctx, len(ship_s) % len(st["z0s"]), spans, timer)
        now = time.perf_counter()
        ship_s.append(now - t0)
        if now - t_start >= seconds:
            break
    shipped = len(ship_s)
    print(f"perfbench: {shipped} proofs shipped in {now - t_start} s", file=sys.stderr)
    ctx.obs["compress"] = {"proofs": shipped, "window_s": now - t_start,
                           "spans": {**spans.totals, **(timer.totals if timer else {})}}
    return {"ship_p90_ms": 1e3 * percentile(ship_s, 90)}, shipped


def outputs(ctx) -> dict:
    st = ctx.state
    out = {"starts": st["starts"], "z0s": st["z0s"], "blobs": st["blobs"],
           "answers": st["answers"]}
    ctx.state = None
    return out


def check(ctx, outs):
    t, steps = ctx.config["t"], ctx.params["steps"]
    rng = random.Random(ctx.seed + 2)
    shipped = [k for k, blobs in enumerate(outs["blobs"]) if blobs]
    claim = 0
    for k in shipped:
        want_z0 = ref_minroot.forward(tuple(outs["starts"][k]), ctx.params["statement_rounds"],
                                      ref_minroot.MODULI["Fq"])
        claim += int(list(want_z0) != outs["z0s"][k])
    nums = ref.judge_blobs(t, [(outs["z0s"][k], steps, rng.choice(sorted(outs["blobs"][k])))
                               for k in shipped], ctx.seed)
    nums["claim_wrong"] += claim
    # every chain is sound, so every verifier answer has to be True
    nums["answers_false"] = sum(not a for answers in outs["answers"] for a in answers)
    nums["bytes_differ"] = sum(len(b) - 1 for b in outs["blobs"] if b)
    checks = [(name, v, 0) for name, v in nums.items()]
    failed = nums["answers_false"] if not any(v for _, v, _ in checks[:4]) else \
        sum(len(a) for a in outs["answers"])
    return checks, failed
