"""MinRoot segments, closed loop: ``Evaluation.eval`` of t rounds on every
lane, each segment chained from the last one's result, as
``Evaluation.append`` chains proofs.

Config: ``field`` (``Fq`` or ``Fp``), ``mode``, ``segment_rounds`` (t).
Traffic: ``lanes``.  Start states: x and y drawn from the seed, uniform
below p, and i = 0, one per lane.

Set-up makes the start states and warms with one whole segment, which
the chain keeps.  The window runs segment after segment, each ended by a
synchronise, with CUDA events around each ``eval``.
``vdf_iters_per_s`` = lanes x t x segments completed in the window, over
the seconds from the window's start to the end of its last segment.

The comparison: on lanes 0 and lanes - 1 and four more drawn from the
seed, the reference walks the final state back by every round the chain
ran (inverse rounds on Python ints); each lane must arrive at its start.

The control: every segment runs t - 1 rounds (the guarantee broken: n
segments are exactly n t rounds).
"""

from __future__ import annotations

import contextlib
import random
import time

from perfbench.reference import minroot as ref
from perfbench.reference.limbs import mont_to_ints

SAMPLED_LANES = 6


def _vdf(ctx):
    from vdf_tpu_torch.minroot import EvalMode, MinRootVDF
    from vdf_tpu_torch.fields import get_field

    return MinRootVDF(get_field(ctx.config["field"]), EvalMode(ctx.config["mode"]))


def starts(seed: int, lanes: int, p: int) -> list[tuple[int, int, int]]:
    rng = random.Random(seed)
    return [(rng.randrange(p), rng.randrange(p), 0) for _ in range(lanes)]


def sampled(seed: int, lanes: int) -> list[int]:
    rest = list(range(1, lanes - 1))
    pick = random.Random(seed + 1).sample(rest, min(len(rest), SAMPLED_LANES - 2))
    return sorted({0, lanes - 1, *pick})


def setup(ctx) -> None:
    vdf = _vdf(ctx)
    p = ref.MODULI[ctx.config["field"]]
    st = starts(ctx.seed, ctx.params["lanes"], p)
    ctx.state = {"vdf": vdf, "t": int(ctx.config["segment_rounds"]), "p": p, "starts": st,
                 "s": vdf.state_from_ints(*map(list, zip(*st)), device=ctx.device),
                 "segments": 0}


def _segment(ctx):
    from vdf_tpu_torch.minroot import Evaluation

    st = ctx.state
    _, proof = Evaluation.eval(st["vdf"], st["s"], st["t"])
    st["s"] = proof.result
    st["segments"] += 1


@contextlib.contextmanager
def control():
    """Every segment runs t - 1 rounds while this is open."""
    global _segment
    sound = _segment

    def short(ctx):
        from vdf_tpu_torch.minroot import Evaluation

        st = ctx.state
        _, proof = Evaluation.eval(st["vdf"], st["s"], st["t"] - 1)
        st["s"] = proof.result
        st["segments"] += 1

    _segment = short
    try:
        yield
    finally:
        _segment = sound


def _sync(ctx):
    import torch

    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def warm(ctx) -> None:
    _segment(ctx)
    _sync(ctx)


def window(ctx, seconds: float):
    import torch

    from perfbench.trace import Spans

    st = ctx.state
    cuda = ctx.device.type == "cuda"
    spans = Spans(record=ctx.trace)
    ctx.spans.append(spans)
    if cuda:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    event_ms, segs = 0.0, 0
    t_start = time.perf_counter()
    while True:
        with spans.phase("segment"):
            if cuda:
                e0.record()
            _segment(ctx)
            if cuda:
                e1.record()
            _sync(ctx)
        now = time.perf_counter()
        segs += 1
        if cuda:
            event_ms += e0.elapsed_time(e1)
        if now - t_start >= seconds:
            break
    lanes = ctx.params["lanes"]
    ctx.obs["minroot"] = {"lanes": lanes, "t": st["t"], "segments": segs,
                          "event_s": event_ms * 1e-3 if cuda else None,
                          "field": ctx.config["field"]}
    return {"vdf_iters_per_s": lanes * st["t"] * segs / (now - t_start)}, lanes * segs


def outputs(ctx) -> dict:
    st = ctx.state
    lanes = sampled(ctx.seed, ctx.params["lanes"])
    s = st["s"]
    out = {"lanes": lanes, "rounds": st["segments"] * st["t"], "p": st["p"],
           "starts": [st["starts"][k] for k in lanes],
           "final": [s.x[lanes].cpu().numpy(), s.y[lanes].cpu().numpy(),
                     s.i[lanes].cpu().numpy()]}
    ctx.state = None
    return out


def check(ctx, outs):
    p = outs["p"]
    finals = list(zip(*(mont_to_ints(c, p) for c in outs["final"])))
    wrong = sum(ref.back(f, outs["rounds"], p) != s for f, s in zip(finals, outs["starts"]))
    return [("lanes_wrong", wrong, 0)], wrong
