"""The resumable interleaved prover (vdf_tpu_torch.nova.pipeline.InterleavedProver)
on the CPU: the native engine at t = 1, keys of 2^14 (their derivation is most
of this file's time).

  * ``run(until=...)`` stops every chain, and the counters add up;
  * after an uneven stop each chain's proof is byte-equal to a lone
    RecursiveIVC's after the same steps, and a second ``run`` continues every
    chain, still byte-equal;
  * an exception in one chain reaches the caller with ``partial_proofs``.

``prove_interleaved``'s own cases are in tests/test_torch_service.py.
"""

from __future__ import annotations

import threading

import pytest
import torch

from vdf_tpu_torch.nova import pipeline
from vdf_tpu_torch.nova.ivc import RecursiveIVC, ivc_public_params, ivc_verify
from vdf_tpu_torch.nova.pipeline import InterleavedProver
from vdf_tpu_torch.serialize import serialize_ivc_proof

torch.set_num_threads(1)  # many small tensor ops; see tests/test_torch_commit.py

T = 1


@pytest.fixture(scope="module")
def pp():
    return ivc_public_params(T, engine="native")


def _z0(x: int) -> list[int]:
    return [x, 0, 1]


def test_until_stops_every_chain_and_counters_add_up(pp):
    prover = InterleavedProver(pp, [_z0(3), _z0(4)])
    calls = []
    prover.run(until=lambda: len(calls) >= 3, on_step=lambda k, s: calls.append((k, s)))
    assert 3 <= len(calls) <= 4  # each chain asks before each step; a begun step finishes
    assert sum(prover.steps) == len(calls)
    for k, chain in enumerate(prover.chains):
        assert prover.steps[k] == sum(1 for j, _ in calls if j == k) == chain.i - 1
        assert prover.steps[k] >= 1  # both asked before any step had returned
        assert 0 < prover.cpu_s[k] <= prover.wall_s[k] + 1e-3
        assert prover.wall_s[k] == pytest.approx(sum(s for j, s in calls if j == k))
    assert all(s > 0 for _, s in calls)
    prover.reset_counters()
    assert prover.steps == [0, 0] and prover.wall_s == [0.0, 0.0] == prover.cpu_s
    with pytest.raises(ValueError, match="num_steps or until"):
        prover.run()


def test_uneven_stop_and_resume_match_lone_chains(pp):
    z0s = [_z0(5), _z0(6)]
    prover = InterleavedProver(pp, z0s)
    # chain 1 is told to stop before its first step, chain 0 folds once
    prover.run(num_steps=2, until=lambda: threading.current_thread().name == "ivc-chain-1")
    assert prover.steps == [1, 0]
    lone = [RecursiveIVC(pp, z0) for z0 in z0s]
    for chain, n in zip(lone, (1, 0)):
        for _ in range(n):
            chain.prove_step()

    def same():
        for got, want in zip(prover.proofs(), (c.proof() for c in lone)):
            assert serialize_ivc_proof(pp, got) == serialize_ivc_proof(pp, want)

    same()
    # a second run continues both chains from where they stopped
    prover.run(num_steps=3)
    assert prover.steps == [2, 2] and [c.i for c in prover.chains] == [3, 3]
    for chain, n in zip(lone, (1, 2)):
        for _ in range(n):
            chain.prove_step()
    same()
    for proof, z0 in zip(prover.proofs(), z0s):
        assert proof.i == 3 and proof.z0 == z0


def test_chain_error_reaches_caller_with_partial_proofs(pp, monkeypatch):
    z0s = [_z0(7), _z0(8)]
    prover = InterleavedProver(pp, z0s)
    real = pipeline.RecursiveIVC.prove_step

    def prove_step(self):
        if self.z0 == z0s[1]:
            raise RuntimeError("chain failed")
        real(self)

    monkeypatch.setattr(pipeline.RecursiveIVC, "prove_step", prove_step)
    with pytest.raises(RuntimeError, match="chain failed") as info:
        prover.run(num_steps=2)
    good, failed = info.value.partial_proofs
    assert failed is None and good.i == 2
    zn = prover.chains[0].z_i
    assert ivc_verify(pp, good, 2, z0s[0], zn)
    assert prover.steps == [1, 0]
