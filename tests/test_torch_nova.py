"""The port's single-curve Nova folding engine (vdf_tpu_torch.nova) on the
CPU at t = 2 iterations a step, n = 3 steps (the size of tests/test_nova.py):
it proves, verifies and rejects tampered proofs, and each fold equals the
JAX package's ``NIFS.prove`` called directly on the same inputs carried
across with interop.  Equality is exact, at canonical integers and affine
points.

The JAX package's jitted whole-step prover compiles for minutes on the CPU,
so only the ``slow`` test at the end, in which each package verifies the
other's whole proof, reaches it.
"""

import numpy as np
import pytest
import torch

from vdf_tpu.curves.point import Point as JaxPoint
from vdf_tpu.nova import NovaVDFProof as JaxNovaVDFProof
from vdf_tpu.nova import RecursiveSNARK as JaxRecursiveSNARK
from vdf_tpu.nova import public_params as jax_public_params
from vdf_tpu.nova.nifs import R1CSInstance as JaxR1CSInstance
from vdf_tpu.nova.nifs import RelaxedInstance as JaxRelaxedInstance
from vdf_tpu.nova.nifs import RelaxedWitness as JaxRelaxedWitness
from vdf_tpu.poseidon import Transcript as JaxTranscript
from vdf_tpu_torch import (
    NovaVDFProof,
    eval_and_make_circuits,
    interop,
    msm,
    pallas_vdf,
    public_params,
)
from vdf_tpu_torch.errors import KernelError, NovaError
from vdf_tpu_torch.native import msm_native_affine
from vdf_tpu_torch.nova import (
    InverseMinRootCircuit,
    R1CSInstance,
    RecursiveSNARK,
    RelaxedInstance,
    RelaxedWitness,
    derive_generators,
)
from vdf_tpu_torch.nova.nifs import absorb_point, squeeze_challenge_bits
from vdf_tpu_torch.poseidon import IntTranscript, Transcript
from vdf_tpu_torch.utils import TEST_SEED, XorShiftRng, field_random

torch.set_num_threads(1)  # many small tensor ops; see tests/test_torch_commit.py

T, N = 2, 3
CURVE = "pallas"


@pytest.fixture(scope="module")
def proven():
    """One proof by the port's engine, shared by the checks."""
    vdf = pallas_vdf()
    x = field_random(XorShiftRng(TEST_SEED), vdf.field.params.modulus)
    s0 = vdf.state_from_ints(x, 0, 1, device="cpu")  # initial i = 1 like the reference test
    pp = public_params(T, device="cpu")
    z0, circuits = eval_and_make_circuits(vdf, T, N, s0)
    proof = NovaVDFProof.prove_recursively(pp, circuits, z0)
    return pp, proof, z0, list(s0), vdf, circuits


def affine(curve, p):
    from vdf_tpu_torch.curves import Point

    return curve.to_affine_ints(Point(*(v[None] for v in p)))[0]


def replaced(proof, **parts):
    """The proof with parts of its snark (step_instances, U, W) replaced."""
    s = proof.snark
    fields = {"step_instances": s.step_instances, "U": s.U, "W": s.W, **parts}
    return NovaVDFProof(RecursiveSNARK(**fields), proof.comm_ts)


def test_proof_verifies_and_chains_back_to_the_input(proven):
    pp, proof, z0, zi, vdf, _ = proven
    assert proof.verify(pp, N, z0, zi)
    f = pp.field
    xs = [f.decode(u.x) for u in proof.snark.step_instances]
    assert xs[0][:3] == [f.decode(v) for v in z0]
    assert xs[-1][3:] == [f.decode(v) for v in zi]
    assert len(proof.comm_ts) == N
    assert callable(proof.compress)  # the Spartan argument: tests/test_torch_compressed.py


def test_wrong_num_steps_rejected(proven):
    pp, proof, z0, zi, _, _ = proven
    assert not proof.verify(pp, N + 1, z0, zi)
    assert not proof.verify(pp, 0, z0, zi)


def test_wrong_zi_rejected(proven):
    pp, proof, z0, _, vdf, _ = proven
    bad = vdf.state_from_ints(123, 0, 1, device="cpu")
    assert not proof.verify(pp, N, z0, list(bad))


def test_wrong_z0_rejected(proven):
    pp, proof, _, zi, vdf, _ = proven
    bad = vdf.state_from_ints(321, 0, 1, device="cpu")
    assert not proof.verify(pp, N, list(bad), zi)


def test_one_changed_limb_of_the_final_witness_rejected(proven):
    pp, proof, z0, zi, _, _ = proven
    w_bad = proof.snark.W.w.clone()
    w_bad[0, 0] ^= 1
    assert not replaced(proof, W=RelaxedWitness(w_bad, proof.snark.W.e)).verify(pp, N, z0, zi)
    e_bad = proof.snark.W.e.clone()
    e_bad[1, 3] ^= 1
    assert not bool(pp.final_check(proof.snark.U, RelaxedWitness(proof.snark.W.w, e_bad)))


@pytest.mark.parametrize("k", range(N))
def test_changed_step_instance_x_rejected(proven, k):
    """A changed public value of step k: the chaining check catches the
    values that chain, the transcript replay the rest."""
    pp, proof, z0, zi, _, _ = proven
    inst = list(proof.snark.step_instances)
    for row in (1, 4):
        x_bad = inst[k].x.clone()
        x_bad[row] = pp.field.add(x_bad[row], pp.field.one(device="cpu"))
        bad = inst[:k] + [R1CSInstance(inst[k].comm_w, x_bad)] + inst[k + 1 :]
        assert not replaced(proof, step_instances=bad).verify(pp, N, z0, zi)


def test_swapped_commitment_rejected(proven):
    pp, proof, z0, zi, _, _ = proven
    inst = list(proof.snark.step_instances)
    inst[0] = R1CSInstance(inst[1].comm_w, inst[0].x)
    assert not replaced(proof, step_instances=inst).verify(pp, N, z0, zi)
    ts = [proof.comm_ts[1], proof.comm_ts[0], proof.comm_ts[2]]
    assert not NovaVDFProof(proof.snark, ts).verify(pp, N, z0, zi)


def test_forged_new_x_witness_fails_the_relaxed_check(proven):
    """The forged-new_x case of tests/test_nova.py on tensors: a witness
    whose new_x is a free choice (with new_y made consistent with it) does
    not satisfy the step's shape."""
    pp, _, _, _, _, _ = proven
    f, p = pp.field, pp.field.params.modulus
    dev = public_params(1, device="cpu").dev_shape
    x, y, i = 12345, 67890, 7
    tmp2 = pow(x, 4, p)

    def check(new_x):
        new_y = (tmp2 * x - new_x) % p
        w = f.encode([x * x % p, tmp2, new_y, new_x, (i - 1) % p], device="cpu")
        xio = f.encode([x, y, i, new_x, new_y, (i - 1) % p], device="cpu")
        e = torch.zeros((dev.shape.num_cons, 8), dtype=torch.int32)
        return dev.check_relaxed(f, w, e, xio, f.one(device="cpu"))

    assert check((y - (i - 1)) % p)
    assert not check(999)


def test_entry_points_and_sizes(proven):
    pp, proof, _, _, vdf, _ = proven
    s = pp.dev_shape.shape
    assert (s.num_cons, s.num_aux, s.num_inputs) == (3 * T + 5, 3 * T + 2, 6)
    assert pp.nifs.ck.n == 16  # the next power of two over num_cons = 11
    assert proof.snark.W.w.shape == (s.num_aux, 8) and proof.snark.W.e.shape == (s.num_cons, 8)
    with pytest.raises(NovaError):
        eval_and_make_circuits(vdf, T, 0, vdf.state_from_ints(1, 0, 1, device="cpu"))
    with pytest.raises(KernelError):  # no card here, and the CPU is never the default
        public_params(T)


def test_folded_commitment_opens_by_msm_and_native_pippenger(proven):
    """U.comm_w is the commitment of the folded witness: the fixed-base
    commit, the variable-base ``msm`` over the key's generators and the
    native C++ Pippenger agree in affine; the first and the last also for W.e."""
    pp, proof, _, _, _, _ = proven
    c, ck, f = pp.nifs.curve, pp.nifs.ck, pp.field
    gens = derive_generators(CURVE, ck.n)
    for vec, comm in ((proof.snark.W.w, proof.snark.U.comm_w),
                      (proof.snark.W.e, proof.snark.U.comm_e)):
        want = msm_native_affine(CURVE, gens[: vec.shape[0]], f.decode(vec))
        assert affine(c, comm) == want
        assert affine(c, ck.commit(vec)) == want
    w = proof.snark.W.w
    pts = type(ck.gens)(*(v[: w.shape[0]] for v in ck.gens))
    assert affine(c, msm(c, pts, w)) == affine(c, proof.snark.U.comm_w)


def test_absorb_point_and_challenge_match_the_integer_transcript(proven):
    """A point goes in as four 128-bit halves and a flag; the identity as
    five zeros and flag 1; the challenge is the low 128 bits."""
    pp, proof, _, _, _, _ = proven
    c, f = pp.nifs.curve, pp.field
    pt = proof.snark.U.comm_w
    ax, ay = affine(c, pt)
    mask = (1 << 128) - 1
    tr, it = Transcript("Fq"), IntTranscript("Fq")
    absorb_point(tr, f, c, pt)
    absorb_point(tr, f, c, c.identity((), device="cpu"))
    it.absorb(ax & mask, ax >> 128, ay & mask, ay >> 128, 0, 0, 0, 0, 0, 1)
    r_mont, bits = squeeze_challenge_bits(tr, f)
    want = it.squeeze() & mask
    assert f.decode(r_mont) == want
    assert bits.tolist() == [(want >> k) & 1 for k in range(128)]


# ---------------------------------------------------------------------
# each fold against the JAX package's NIFS on the carried-over inputs
# ---------------------------------------------------------------------


def jax_point(t):
    import jax.numpy as jnp

    return JaxPoint(*(jnp.asarray(a) for a in t))


def to_jax_relaxed(U, W):
    import jax.numpy as jnp

    cw, ce, x, u = interop.relaxed_instance_to_jax(CURVE, U)
    w, e = interop.relaxed_witness_to_jax(CURVE, W)
    return (JaxRelaxedInstance(jax_point(cw), jax_point(ce), jnp.asarray(x), jnp.asarray(u)),
            JaxRelaxedWitness(jnp.asarray(w), jnp.asarray(e)))


def to_jax_transcript(tr):
    import jax.numpy as jnp

    state, buf = tr.export_state()
    conv = lambda items: tuple(jnp.asarray(interop.to_jax("Fq", a)) for a in items)  # noqa: E731
    return JaxTranscript.from_state("Fq", (conv(state), conv(buf)))


def test_each_fold_matches_jax_nifs(proven):
    """The port's prover, fold by fold: the step's witness and instance, the
    running (U, W) and the transcript state are carried to the JAX package,
    whose ``NIFS.prove`` must give the same comm_T, U', W' and (through
    U'.u - U.u) the same 128-bit challenge.  The last fold ends at the
    accumulator that ``prove_recursively`` returned."""
    import jax.numpy as jnp

    pp, proof, _, _, _, circuits = proven
    f, nifs, c = pp.field, pp.nifs, pp.nifs.curve
    q = f.params.modulus
    jpp = jax_public_params(T)
    jnifs = jpp.nifs
    assert interop.jax_limbs_to_ints("Fq", np.asarray(jpp.digest)) == [f.decode(pp.digest)]
    ck_from_jax = interop.commitment_key_from_jax(jnifs.ck, device="cpu")
    assert torch.equal(ck_from_jax.gens.x, nifs.ck.gens.x)

    shape = pp.dev_shape.shape
    tr = pp.new_transcript()
    U = RelaxedInstance.default(c, f, shape.num_inputs, device="cpu")
    W = RelaxedWitness.default(f, shape.num_aux, shape.num_cons, device="cpu")
    for k, circ in enumerate(circuits):
        z_in = list(circ.result)
        cs, outs = InverseMinRootCircuit(T).witness(f, z_in)
        w2 = cs.witness()
        u2 = R1CSInstance(nifs.ck.commit(w2), torch.stack(z_in + outs))
        assert torch.equal(u2.x, proof.snark.step_instances[k].x)

        jtr = to_jax_transcript(tr)
        jU, jW = to_jax_relaxed(U, W)
        cw, x = interop.r1cs_instance_to_jax(CURVE, u2)
        ju2 = JaxR1CSInstance(jax_point(cw), jnp.asarray(x))
        jU2, jW2, jcomm_t = jnifs.prove(jtr, jU, jW, ju2, jnp.asarray(interop.to_jax("Fq", w2)))

        u_before = f.decode(U.u)
        U, W, comm_t = nifs.prove(tr, U, W, u2, w2)
        assert affine(c, comm_t) == affine(c, interop.point_from_jax(CURVE, jcomm_t, "cpu"))
        assert affine(c, comm_t) == affine(c, proof.comm_ts[k])
        want_u = interop.relaxed_instance_from_jax(CURVE, jU2, device="cpu")
        want_w = interop.relaxed_witness_from_jax(CURVE, jW2, device="cpu")
        assert affine(c, U.comm_w) == affine(c, want_u.comm_w)
        assert affine(c, U.comm_e) == affine(c, want_u.comm_e)
        assert torch.equal(U.x, want_u.x) and torch.equal(U.u, want_u.u)
        assert torch.equal(W.w, want_w.w) and torch.equal(W.e, want_w.e)
        r = (f.decode(U.u) - u_before) % q
        assert 0 < r < 1 << 128
        assert (f.decode(want_u.u) - u_before) % q == r
        # The two transcripts go on in step.
        jstate = [interop.jax_limbs_to_ints("Fq", np.asarray(a))[0] for a in jtr.export_state()[0]]
        assert [f.decode(a) for a in tr.export_state()[0]] == jstate

    assert torch.equal(U.u, proof.snark.U.u) and torch.equal(U.x, proof.snark.U.x)
    assert torch.equal(W.w, proof.snark.W.w) and torch.equal(W.e, proof.snark.W.e)
    assert affine(c, U.comm_w) == affine(c, proof.snark.U.comm_w)


def test_proof_round_trips_through_interop(proven):
    pp, proof, z0, zi, _, _ = proven
    parts = interop.nova_proof_to_jax(CURVE, proof)
    snark = JaxRecursiveSNARK(
        [JaxR1CSInstance(JaxPoint(*cw), x) for cw, x in parts["step_instances"]],
        JaxRelaxedInstance(JaxPoint(*parts["U"][0]), JaxPoint(*parts["U"][1]), *parts["U"][2:]),
        JaxRelaxedWitness(*parts["W"]))
    back = interop.nova_proof_from_jax(
        CURVE, JaxNovaVDFProof(snark, [JaxPoint(*t) for t in parts["comm_ts"]]), device="cpu")
    assert torch.equal(back.snark.W.w, proof.snark.W.w)
    assert torch.equal(back.snark.U.comm_e.y, proof.snark.U.comm_e.y)
    assert back.verify(pp, N, z0, zi)


@pytest.mark.slow
def test_each_package_verifies_the_others_whole_proof(proven):
    """The JAX package's jitted engine proves the same chain; its proof
    verifies in the port, the port's in the JAX package, and the two final
    accumulators are the same values."""
    import jax.numpy as jnp

    from vdf_tpu.minroot import pallas_vdf as jax_pallas_vdf
    from vdf_tpu.nova import eval_and_make_circuits as jax_eval_and_make_circuits

    pp, proof, z0, zi, vdf, _ = proven
    f = pp.field
    jvdf = jax_pallas_vdf()
    js0 = jvdf.state_from_ints(*(f.decode(v) for v in zi))
    jpp = jax_public_params(T)
    jz0, jcircuits = jax_eval_and_make_circuits(jvdf, T, N, js0)
    jproof = JaxNovaVDFProof.prove_recursively(jpp, jcircuits, jz0)
    jzi = [js0.x, js0.y, js0.i]
    assert jproof.verify(jpp, N, jz0, jzi)

    carried = interop.nova_proof_from_jax(CURVE, jproof, device="cpu")
    assert carried.verify(pp, N, z0, zi)
    assert torch.equal(carried.snark.W.w, proof.snark.W.w)
    assert torch.equal(carried.snark.W.e, proof.snark.W.e)
    assert torch.equal(carried.snark.U.u, proof.snark.U.u)

    parts = interop.nova_proof_to_jax(CURVE, proof)
    arr = jnp.asarray
    snark = JaxRecursiveSNARK(
        [JaxR1CSInstance(jax_point(cw), arr(x)) for cw, x in parts["step_instances"]],
        JaxRelaxedInstance(jax_point(parts["U"][0]), jax_point(parts["U"][1]),
                           arr(parts["U"][2]), arr(parts["U"][3])),
        JaxRelaxedWitness(arr(parts["W"][0]), arr(parts["W"][1])))
    ours_in_jax = JaxNovaVDFProof(snark, [jax_point(t) for t in parts["comm_ts"]])
    assert ours_in_jax.verify(jpp, N, jz0, jzi)
    bad_w = snark.W.w.at[0].set(jpp.field.encode(999))
    tampered = JaxNovaVDFProof(
        JaxRecursiveSNARK(snark.step_instances, snark.U, JaxRelaxedWitness(bad_w, snark.W.e)),
        ours_in_jax.comm_ts)
    assert not tampered.verify(jpp, N, jz0, jzi)
