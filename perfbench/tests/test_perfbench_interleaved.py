"""The cell ``ivc_t100.interleaved4`` on the CPU, at sizes a test run holds: a
sound run of four chains comes out correct; each fault planted under the timed
path, and the cell's control, come out not correct by the number named; the
two readers of the interleaved prover's counters.

Runs go through ``run.run`` with ``device="cpu"`` and the ``"native"`` engine
at t = 1, as in test_perfbench_faults.py.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time

import pytest
import torch

from perfbench import control, run, spec

torch.set_num_threads(1)

CELL = "ivc_t100.interleaved4"
CONFIG = {"t": 1, "engine": "native"}
# a window of a second: every chain's thread asks before its first step, long
# before the deadline, and each CPU step takes longer than the window
PARAMS, SECONDS = {"statement_rounds": 4, "warm_steps": 0}, 1.0


def run_cpu(monkeypatch, seed: int) -> dict:
    config, workload = spec.config, spec.workload
    monkeypatch.setattr(spec, "config", lambda name: {**config(name), **CONFIG})
    monkeypatch.setattr(spec, "workload", lambda name: {
        **workload(name), "params": {**workload(name)["params"], **PARAMS}})
    res = run.run(["--workload", CELL, "--seed", str(seed), "--seconds", str(SECONDS),
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


def _in_chain(k: int) -> bool:
    return threading.current_thread().name == f"ivc-chain-{k}"


def _proofs_swapped():
    """Chains 0 and 1 hand back each other's final proof."""
    from vdf_tpu_torch.nova.pipeline import InterleavedProver

    def make(old):
        def proofs(self):
            out = old(self)
            out[0], out[1] = out[1], out[0]
            return out
        return proofs

    return patched(InterleavedProver, "proofs", make)


def _one_step_unchanged():
    """Chain 2's steps return its state unchanged."""
    from vdf_tpu_torch.nova.ivc import RecursiveIVC

    def make(old):
        def prove_step(self):
            if not _in_chain(2):
                old(self)
        return prove_step

    return patched(RecursiveIVC, "prove_step", make)


def _one_chain_stalled():
    """Chain 3 is stopped before its first step of every deadline-bound run."""
    from vdf_tpu_torch.nova.pipeline import InterleavedProver

    def make(old):
        def run_(self, num_steps=None, until=None, on_step=None):
            if until is not None:
                until = (lambda u: lambda: _in_chain(3) or u())(until)
            return old(self, num_steps, until, on_step)
        return run_

    return patched(InterleavedProver, "run", make)


FAULTS = {"swapped": (_proofs_swapped, ("claim_wrong",)),
          "unchanged": (_one_step_unchanged, ("claim_wrong", "hash_wrong")),
          "stalled": (_one_chain_stalled, ("chains_stalled",))}


def test_sound_run_is_correct(monkeypatch):
    res = run_cpu(monkeypatch, 2**31 + 23)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 4
    assert set(res["checks"]) == {"claim_wrong", "hash_wrong", "rows_wrong", "commit_wrong",
                                  "chains_stalled"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(monkeypatch, fault):
    plant, caught_by = FAULTS[fault]
    with plant():
        res = run_cpu(monkeypatch, 2**31 + 29)
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0
    assert any(res["checks"][name]["value"] > 0 for name in caught_by), res["checks"]


def test_control_is_not_correct(monkeypatch):
    with control.control_for(CELL)():
        res = run_cpu(monkeypatch, 2**31 + 31)
    assert not res["correct"], res["checks"]
    assert res["checks"]["rows_wrong"]["value"] > 0


@pytest.mark.parametrize("name", ["ivc.chain_wait_ms", "ivc.chain_balance"])
def test_readers_without_counters_read_none(name):
    read = spec.metric_reader(name)
    assert read({}) is None
    assert read({"ivc": {"steps": 5, "window_s": 1.0, "spans": {}, "launches": {}}}) is None
    assert read({"interleave": {"steps": [0, 0], "wall_s": [0.0, 0.0],
                                "cpu_s": [0.0, 0.0]}}) is None


def test_readers_on_counters():
    obs = {"interleave": {"steps": [10, 8, 10, 6], "wall_s": [1.0, 0.9, 1.1, 0.8],
                          "cpu_s": [0.4, 0.3, 0.5, 0.2]}}
    # 1e3 (3.8 - 1.4) / 34 ms a step
    assert spec.metric_reader("ivc.chain_wait_ms")(obs) == pytest.approx(1e3 * 2.4 / 34)
    assert spec.metric_reader("ivc.chain_balance")(obs) == pytest.approx(0.6)
