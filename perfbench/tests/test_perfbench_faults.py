"""The harness's comparison on the CPU, at sizes a test run holds: a sound
run comes out correct, and each fault a cell can have, planted under the
timed path, and each cell's control come out not correct.

Runs go through ``run.run`` with ``device="cpu"`` (the program's plain
versions; the IVC cells on its ``"native"`` engine, whose fold is host
code), which skips only the look for a card.
"""

from __future__ import annotations

import contextlib
import json
import time

import pytest
import torch

from perfbench import control, run, spec

torch.set_num_threads(1)

TINY = {
    "minroot.lanes8192": ({"segment_rounds": 7}, {"lanes": 5}, 0.2),
    "ivc_t100.chain": ({"t": 1, "engine": "native"}, {"statement_rounds": 4, "warm_steps": 0},
                      0.05),
    "ivc_t100.compress": ({"t": 1, "engine": "native"},
                         {"statement_rounds": 4, "chains": 1, "steps": 2}, 0.05),
}


def run_cpu(monkeypatch, cell: str, seed: int, more=None, seconds=None) -> dict:
    cfg_over, params_over, tiny_seconds = TINY[cell]
    params_over = {**params_over, **(more or {})}
    seconds = tiny_seconds if seconds is None else seconds
    config, workload = spec.config, spec.workload
    monkeypatch.setattr(spec, "config", lambda name: {**config(name), **cfg_over})
    monkeypatch.setattr(spec, "workload", lambda name: {
        **workload(name), "params": {**workload(name)["params"], **params_over}})
    res = run.run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", "0"], time.perf_counter(), device="cpu")
    json.dumps(res)  # the result line serialises
    return res


@contextlib.contextmanager
def patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


# -- MinRoot ------------------------------------------------------------


def _eval_unchanged():
    from vdf_tpu_torch.minroot.vdf import MinRootVDF

    return patched(MinRootVDF, "eval", lambda old: lambda self, s, t: s)


def _eval_half_lanes():
    from vdf_tpu_torch.minroot.vdf import MinRootVDF, State

    def make(old):
        def ev(self, s, t):
            h = s.x.shape[0] // 2
            out = old(self, State(*(c[:h] for c in s)), t)
            return State(*(torch.cat([a, b[h:]]) for a, b in zip(out, s)))
        return ev

    return patched(MinRootVDF, "eval", make)


def _eval_altered():
    from vdf_tpu_torch.minroot.vdf import MinRootVDF, State

    def make(old):
        def ev(self, s, t):
            out = old(self, s, t)
            x = out.x.clone()
            x[0, 0] += 1
            return State(x, out.y, out.i)
        return ev

    return patched(MinRootVDF, "eval", make)


# -- the IVC chain (native engine on the CPU) ----------------------------


def _step_unchanged():
    from vdf_tpu_torch.nova.ivc import RecursiveIVC

    return patched(RecursiveIVC, "prove_step", lambda old: lambda self: None)


def _half_witness_fold():
    from vdf_tpu_torch.nova.ivc import HostPlane

    def make(old):
        def fold_w(self, W, E, w2, t, r):
            W2, E2 = old(self, W, E, w2, t, r)
            h = len(W) // 2
            return W2[:h] + list(W[h:]), E2
        return fold_w

    return patched(HostPlane, "fold_w", make)


def _instance_altered():
    from vdf_tpu_torch.nova.ivc import Side

    def make(old):
        def fold_instance(self, U, u, comm_t, r):
            out = old(self, U, u, comm_t, r)
            out.X[0] = (out.X[0] + 1) % self.field.params.modulus
            return out
        return fold_instance

    return patched(Side, "fold_instance", make)


# -- compression ----------------------------------------------------------


def _bytes_altered():
    import vdf_tpu_torch

    def make(old):
        def ser(pp, cp):
            blob = bytearray(old(pp, cp))
            blob[-32] ^= 1  # the low byte of the last element: still canonical
            return bytes(blob)
        return ser

    return patched(vdf_tpu_torch, "serialize_compressed", make)


def _compress_unchanged():
    """Every call returns the first call's compressed proof: a stale answer
    for every chain after the first."""
    import vdf_tpu_torch

    def make(old):
        first = []

        def compress(pp, proof, timer=None):
            if not first:
                first.append(old(pp, proof, timer))
            return first[0]
        return compress

    return patched(vdf_tpu_torch, "ivc_compress", make)


FAULTS = {
    "minroot.lanes8192": {"unchanged": _eval_unchanged, "half_lanes": _eval_half_lanes,
                          "altered": _eval_altered},
    "ivc_t100.chain": {"unchanged": _step_unchanged, "half_fold": _half_witness_fold,
                      "altered": _instance_altered},
    "ivc_t100.compress": {"unchanged": _compress_unchanged, "altered": _bytes_altered},
}
# a stale proof shows only once a second chain ships in the window: two
# chains, and a window long enough for two of the CPU's ~30 s compressions
MORE = {("ivc_t100.compress", "unchanged"): ({"chains": 2}, 40.0)}
# the number that has to catch a fault, where the program's own verifier is
# not enough: the reference judges a blob of every chain, the second too
CAUGHT_BY = {("ivc_t100.compress", "unchanged"): "claim_wrong"}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(monkeypatch, cell):
    res = run_cpu(monkeypatch, cell, 2**31 + 11)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS) for f in FAULTS[c]])
def test_fault_is_caught(monkeypatch, cell, fault):
    more, seconds = MORE.get((cell, fault), (None, None))
    with FAULTS[cell][fault]():
        res = run_cpu(monkeypatch, cell, 2**31 + 13, more, seconds)
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0
    if (cell, fault) in CAUGHT_BY:
        assert res["checks"][CAUGHT_BY[cell, fault]]["value"] > 0, res["checks"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(monkeypatch, cell):
    with control.control_for(cell)():
        res = run_cpu(monkeypatch, cell, 2**31 + 17)
    assert not res["correct"], res["checks"]
