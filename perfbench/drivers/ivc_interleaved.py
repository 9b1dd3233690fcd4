"""K IVC chains folded side by side on one card by the program's interleaved
prover (``vdf_tpu_torch.nova.pipeline.InterleavedProver``), closed loop: each
chain's next ``prove_step`` starts as soon as its previous one returns.

Config: ``t`` (inverse rounds a step), ``engine``, ``chains`` (K).  Traffic:
``statement_rounds`` (each chain's statement: z0 is that many forward rounds
of its own start drawn from the seed; the K statements are one K1 launch over
K lanes) and ``warm_steps``.

Set-up: ``ivc_public_params(t)``, the statements, and ``InterleavedProver``
(the chains' base steps).  Warm-up: ``run(num_steps=warm_steps + 1)``, so
each chain makes ``warm_steps`` folds.  The window: the prover's counters
reset, then one ``run`` until the deadline of ``--seconds`` (asked before
each step, so a step begun finishes), each step timed by the program from
its call to its return and handed to the driver's callback; ``fold_p95_ms``
is the nearest-rank 95th percentile of every step of every chain in the
window.  The driver counts each chain's steps itself, from the callbacks.

In traced runs each chain's timer is a ``perfbench.trace.Spans`` without a
``sync``: a synchronise is device-wide, so one chain's span would wait on
the other chains' kernels and serialise what the cell exists to overlap.
Its spans are host time, ended where the program reads its results back.

``ctx.obs["ivc"]`` is ``drivers/ivc_chain.py``'s, with steps and span
totals summed over the chains; ``ctx.obs["interleave"]`` holds the prover's
counters, one slot a chain (``steps``, ``wall_s``, ``cpu_s``).

The comparison: every chain's final ``IVCProof`` (after ``proof()``)
against perfbench/reference/ivc.py as in ``ivc_chain``, on that chain's own
statement, and its z0 against its own start walked forward; the sums over
the chains of ``claim_wrong``, ``hash_wrong``, ``rows_wrong`` and
``commit_wrong``, and ``chains_stalled`` (chains that completed no step in
the window).  A proof that depends on another chain's statement reads
``claim_wrong``.

The control is ``ivc_chain``'s: every fold of every chain leaves the cross
term out of the running error vector.
"""

from __future__ import annotations

import sys
import time

from perfbench.drivers.ivc_chain import (  # noqa: F401  (control: found by name)
    _launches,
    _reset_launches,
    control,
    params,
    proof_outputs,
    starts,
    statements,
)
from perfbench.reference import ivc as ref
from perfbench.reference import minroot as ref_minroot

CHECKS = ("claim_wrong", "hash_wrong", "rows_wrong", "commit_wrong")


def setup(ctx) -> None:
    from vdf_tpu_torch.nova.pipeline import InterleavedProver

    pp = params(ctx)
    sts = starts(ctx.seed, ctx.config["chains"])
    z0s = statements(ctx, sts)
    # "steps" counts, a chain, the steps the harness asked for: the base step here
    ctx.state = {"starts": sts, "z0s": z0s, "prover": InterleavedProver(pp, z0s),
                 "steps": [1] * len(sts), "window_steps": [0] * len(sts)}


def _count(ctx, window: bool, step_s: list | None = None):
    steps, window_steps = ctx.state["steps"], ctx.state["window_steps"]

    def on_step(k: int, seconds: float) -> None:
        steps[k] += 1  # each slot written only by chain k's thread
        if window:
            window_steps[k] += 1
            step_s.append(seconds)

    return on_step


def warm(ctx) -> None:
    ctx.state["prover"].run(num_steps=ctx.params["warm_steps"] + 1, on_step=_count(ctx, False))


def window(ctx, seconds: float):
    from perfbench.run import percentile
    from perfbench.trace import Spans

    prover = ctx.state["prover"]
    if ctx.trace:  # the program's phases as profiler ranges too; no synchronise (above)
        for chain in prover.chains:
            chain.timer = Spans(None, record=True)
            ctx.spans.append(chain.timer)
    prover.reset_counters()
    _reset_launches()
    step_s: list[float] = []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    prover.run(until=lambda: time.perf_counter() >= deadline,
               on_step=_count(ctx, True, step_s))
    now = time.perf_counter()
    print(f"perfbench: {len(step_s)} steps in {now - t_start} s, by chain "
          f"{ctx.state['window_steps']}", file=sys.stderr)
    spans: dict[str, float] = {}
    for chain in prover.chains:
        for name, v in chain.timer.totals.items():
            spans[name] = spans.get(name, 0.0) + v
    ctx.obs["ivc"] = {"steps": len(step_s), "window_s": now - t_start, "spans": spans,
                      "launches": _launches()}
    ctx.obs["interleave"] = {"steps": list(prover.steps), "wall_s": list(prover.wall_s),
                             "cpu_s": list(prover.cpu_s)}
    return {"fold_p95_ms": 1e3 * percentile(step_s, 95)}, len(step_s)


def outputs(ctx) -> dict:
    st = ctx.state
    proofs = st["prover"].proofs()
    out = {"chains": [{"start": s, "z0": z0, "steps": n, "window_steps": w,
                       "proof": proof_outputs(p)}
                      for s, z0, n, w, p in zip(st["starts"], st["z0s"], st["steps"],
                                                st["window_steps"], proofs)]}
    ctx.state = None
    return out


def check(ctx, outs):
    sums = dict.fromkeys(CHECKS, 0)
    stalled = failed = 0
    for k, c in enumerate(outs["chains"]):
        nums = ref.judge_proof(ctx.config["t"], c["z0"], c["steps"], c["proof"], ctx.seed + k)
        # the chain's own statement: z0 is ``statement_rounds`` forward rounds of its start
        want_z0 = ref_minroot.forward(tuple(c["start"]), ctx.params["statement_rounds"],
                                      ref_minroot.MODULI["Fq"])
        nums["claim_wrong"] += int(list(want_z0) != list(c["z0"]))
        nums["chains_stalled"] = int(c["window_steps"] == 0)
        for name in CHECKS:
            sums[name] += nums[name]
        stalled += nums["chains_stalled"]
        failed += c["steps"] if any(nums.values()) else 0
    checks = [(k, v, 0) for k, v in sums.items()] + [("chains_stalled", stalled, 0)]
    return checks, failed
