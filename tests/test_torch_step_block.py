"""The MinRoot step circuit on the block path (InverseMinRootCircuit in the
value-only pass over host ints, ``WitnessCS.blocks``): at t = 1, 2, 100 and
1000 the counter moves the step's 3t + 2 elements from ``single`` to
``block`` and the words stay those of the step per element; at t = 100 and
1000 the shapes and the parameters' digest are those frozen here and the
benchmark's independent reference's (perfbench/reference/ivc.py, synthesized
from its frozen copy), whose t = 1000 shape the witness satisfies, while one
altered word of the step's block fails a row.  The witness against the
check=True pass at each t: tests/test_torch_augmented.py; the digests at
t = 1, 2: tests/test_golden.py."""

from __future__ import annotations

import pytest
import torch

from perfbench.reference import ivc as ref
from test_torch_augmented import _chain_inputs
from vdf_tpu_torch.native import ints_of_u64
from vdf_tpu_torch.nova import augmented, ivc
from vdf_tpu_torch.r1cs import witness

torch.set_num_threads(1)  # many small tensor ops; see tests/test_torch_commit.py

# the two augmented shapes' (num_cons, num_aux) and the digest at t
FROZEN = {
    100: ((15552, 14906), (14672, 14031),
          1483331520945421607053730572629583485716344354154748673244271147901754803985),
    1000: ((18252, 17606), (14672, 14031),
           1060774643657276903088561490075645185432521630039154870496268371156772571359),
}


class _Step:
    """The step circuit as the augmented circuit calls it, noting where its
    allocations start; ``per_element`` runs it with the pass's blocks off,
    the way it ran before it had a block path."""

    def __init__(self, step, per_element: bool = False):
        self.step, self.per_element, self.first = step, per_element, None

    def arity(self) -> int:
        return self.step.arity()

    def synthesize(self, cs, z):
        self.first = cs.num_aux
        if not self.per_element:
            return self.step.synthesize(cs, z)
        blocks, cs.blocks = cs.blocks, False
        try:
            return self.step.synthesize(cs, z)
        finally:
            cs.blocks = blocks


def _primary(t: int, per_element: bool = False):
    circ = augmented.make_circuits(t)[0]
    circ.step = _Step(circ.step, per_element)
    return circ


def _counted(circ, inp):
    before = dict(witness.ELEMENTS)
    cs, z = circ.witness(inp)
    return cs, z, {k: witness.ELEMENTS[k] - before[k] for k in before}


@pytest.mark.parametrize("t", sorted(FROZEN))
def test_step_block_shapes_and_digest(t):
    """The shape pass takes no block path: both shapes and the digest are
    those frozen here and the reference's."""
    _, _, shape_p, shape_s, digest = ivc._shapes(t)
    prim, sec, want = FROZEN[t]
    assert digest == want
    assert (shape_p.num_cons, shape_p.num_aux) == prim
    assert (shape_s.num_cons, shape_s.num_aux) == sec
    sp, ss, d = ref.shapes(t)
    assert d == digest
    assert (sp.num_cons, sp.num_aux, ss.num_cons, ss.num_aux) == (
        shape_p.num_cons, shape_p.num_aux, shape_s.num_cons, shape_s.num_aux)


@pytest.mark.parametrize("t", [1, 2, 100, 1000])
def test_step_block_moves_its_elements_to_blocks(t):
    """Against the same pass with the step per element: the same words, and
    3t + 2 elements fewer one at a time and as many more in a block."""
    inp = _chain_inputs(ivc, augmented, t, "primary", 2)
    old, z_old, n_old = _counted(_primary(t, per_element=True), inp)
    new, z_new, n_new = _counted(_primary(t), inp)
    assert new.aux_u64().tobytes() == old.aux_u64().tobytes() and z_new == z_old
    assert n_old["single"] - n_new["single"] == 3 * t + 2
    assert n_new["block"] - n_old["block"] == 3 * t + 2


@pytest.fixture(scope="module")
def t1000_step():
    """A t = 1000 primary step whose input hash is the host's state hash, so
    every row holds: (its cs, the aux index of the step's block)."""
    inp = _chain_inputs(ivc, augmented, 1000, "primary", 1)
    inp.u.X[0] = ivc.state_hash("Fq", inp.digest, inp.i, inp.z0, inp.z_i, inp.U)
    circ = _primary(1000)
    cs, _ = circ.witness(inp)
    return cs, circ.step.first


def test_t1000_witness_satisfies_reference_shape(t1000_step):
    cs, _ = t1000_step
    sp, _, _ = ref.shapes(1000)
    assert cs.num_aux == sp.num_aux
    assert ref.rows_failing(sp, cs.aux, None, cs.inputs, 1, sp.modulus) == 0


# positions in the step's block: the first tmp1, a tmp2 and a new_y of the
# middle, the last new_y, final_x, final_i
@pytest.mark.parametrize("k", [0, 1501, 1502, 2999, 3000, 3001])
def test_t1000_altered_step_word_fails_a_row(t1000_step, k):
    cs, first = t1000_step
    sp, _, _ = ref.shapes(1000)
    words = cs.aux_u64().copy()
    assert first + k < sp.num_aux
    words[first + k, 0] ^= 1
    w = ints_of_u64(words)
    assert ref.rows_failing(sp, w, None, cs.inputs, 1, sp.modulus) >= 1
