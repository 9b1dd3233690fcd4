"""The memo of Poseidon permutations (poseidon/int_poseidon.py::permute_memo)
on the CPU, with the native engine at T = 2 iterations a step.

  * A chain's witnesses are byte for byte the same whether the memo is left
    warm or emptied before every synthesis, on both sides.
  * From the second step on, every permutation of a synthesis's input hash
    and of its fold challenge is served from the memo (the previous output
    hash on the same side, the host's ``fold_challenge``), and every one of
    its output hash is computed: the ``PERMS`` counter, permutation by
    permutation.
  * The warm chain's proof verifies.
  * Only the sponge's value-only pass and ``fold_challenge`` write the memo:
    a Spartan sumcheck's and an IPA's transcripts, ``state_hash`` and
    ``ivc_verify`` leave it as it was; it never holds more than its bound,
    and the S-box values it hands out refuse writes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vdf_tpu_torch.fields import get_int_field
from vdf_tpu_torch.nova.gadgets import sponge
from vdf_tpu_torch.nova.ivc import (
    HostRelaxedInstance,
    RecursiveIVC,
    ivc_public_params,
    ivc_verify,
    state_hash,
)
from vdf_tpu_torch.poseidon import int_poseidon
from vdf_tpu_torch.poseidon.int_poseidon import (
    MEMO_ENTRIES,
    PERMS,
    IntTranscript,
    MemoTranscript,
    permute_ints,
    permute_memo,
)
from vdf_tpu_torch.spartan import host

torch.set_num_threads(1)  # many small tensor ops; see tests/test_torch_commit.py

T, STEPS = 2, 4  # iterations a step; prove steps after the base step
Z0 = [5, 6, 0]
SPONGES = ("hin", "ro", "hout")


def _chain(cold: bool):
    """A native-engine chain of STEPS prove steps after the base step: its
    prover and, for each synthesis in order, (side, step index, the witness's
    ``aux_u64()`` bytes, [(sponge, served from the memo) for each of its
    permutations]).  The memo starts empty; ``cold`` empties it before every
    synthesis too."""
    pp = ivc_public_params(T, engine="native")
    syntheses, perms = [], []

    def empty_memo():
        with int_poseidon._MEMO_LOCK:
            int_poseidon._MEMO.clear()

    def counted_permute(cs, field_name, state, name="pos"):
        before = PERMS["reused"]
        out = permute_gadget(cs, field_name, state, name)
        perms.append((name.split("_perm")[0], PERMS["reused"] > before))
        return out

    def recording(side, witness):
        def run(inp, **kw):
            if cold:
                empty_memo()
            perms.clear()
            cs, z_next = witness(inp, **kw)
            syntheses.append((side, inp.i, cs.aux_u64().tobytes(), list(perms)))
            return cs, z_next
        return run

    permute_gadget = sponge.permute_gadget
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sponge, "permute_gadget", counted_permute)
        for side in ("primary", "secondary"):
            circuit = getattr(pp, side).circuit
            mp.setattr(circuit, "witness", recording(side, circuit.witness))
        empty_memo()
        prover = RecursiveIVC(pp, Z0)
        for _ in range(STEPS):
            prover.prove_step()
    return pp, prover, syntheses


@pytest.fixture(scope="module")
def chains():
    return _chain(cold=True), _chain(cold=False)


def test_witnesses_equal_with_memo_cold_and_warm(chains):
    (_, _, cold), (_, _, warm) = chains
    assert len(cold) == len(warm) == 2 * (STEPS + 1)
    for c, w in zip(cold, warm):
        assert c[:2] == w[:2]
        assert c[2] == w[2], f"{c[0]} synthesis at step {c[1]}"


def test_repeated_permutations_are_reused(chains):
    """Each side's syntheses from the second step on: the input hash and the
    challenge from the memo, the output hash computed."""
    _, (_, _, warm) = chains
    steady = [s for s in warm if s[1] >= 2]
    assert len(steady) == 2 * (STEPS - 1)
    for side, i, _, perms in steady:
        assert {name for name, _ in perms} == set(SPONGES)
        for name, reused in perms:
            assert reused == (name != "hout"), f"{side} step {i}: {name}"
    # 34 a step over both sides, 23 of them reused, at any t: the sponges'
    # inputs do not grow with the step
    step = [p for s in steady[:2] for p in s[3]]
    assert (len(step), sum(r for _, r in step)) == (34, 23)


def test_warm_chain_verifies(chains):
    _, (pp, prover, _) = chains
    proof = prover.proof()
    assert ivc_verify(pp, proof, prover.i, Z0, prover.z_i)


def test_other_transcripts_leave_the_memo_alone(chains):
    _, (pp, prover, _) = chains
    proof = prover.proof()
    q = get_int_field("Fq").p
    before = dict(int_poseidon._MEMO)

    tr = IntTranscript("Fq")
    tr.absorb(7)
    polys = [[(3 * k + j) % q for k in range(8)] for j in range(2)]
    host.sumcheck_prove_ints(q, tr, polys, 2, lambda a, b: a * b)
    gens, h = host.host_ck("pallas", 8)
    host.ipa_prove_ints("pallas", q, gens, h, list(range(1, 9)), list(range(9, 17)),
                        IntTranscript("Fq"))
    state_hash("Fq", pp.digest, prover.i, Z0, prover.z_i, HostRelaxedInstance.default())
    assert ivc_verify(pp, proof, prover.i, Z0, prover.z_i)
    assert dict(int_poseidon._MEMO) == before


def test_memo_is_bounded_and_read_only():
    p = get_int_field("Fp").p
    states = [[p - 1 - k, k, 2 * k, 3, 4] for k in range(MEMO_ENTRIES + 20)]
    for st in states:
        permute_memo("Fp", st)
        assert len(int_poseidon._MEMO) <= MEMO_ENTRIES
    # the least recently used went first
    assert ("Fp", tuple(states[0])) not in int_poseidon._MEMO
    assert ("Fp", tuple(states[-1])) in int_poseidon._MEMO
    out, triples = permute_memo("Fp", states[-1])
    assert list(out) == permute_ints("Fp", states[-1])
    assert not triples.flags.writeable
    with pytest.raises(ValueError):
        triples[0, 0] = np.uint64(1)


def test_memo_transcript_squeezes_as_int_transcript():
    """The fold challenge's transcript gives ``IntTranscript``'s values, on
    a cold memo and on a warm one."""
    els = [11, 22, 33, 44, 55, 66, 77, 88, 99]

    def squeezes(cls):
        tr = cls("Fq")
        tr.absorb(*els)
        return [tr.squeeze(), tr.squeeze()]

    want = squeezes(IntTranscript)
    assert squeezes(MemoTranscript) == want
    assert squeezes(MemoTranscript) == want
