"""The port's two-curve Nova IVC (vdf_tpu_torch.nova.ivc) on the CPU.

  * The native engine at T = 2 iterations a step, N = 3 steps (the size of
    tests/test_ivc.py): that file's 13 cases on the port, its proof equal
    to the JAX package's native proof field by field on the same (T, z0,
    N), and each package's ivc_verify accepting the other's proof through
    interop.
  * The device engine's fold on a small R1CS shape with device="cpu" (the
    kernels' plain versions): fold for fold equal to the native engine's,
    check_sat agreeing on good and tampered inputs, the witness domain and
    the product cache guarded.
  * The instance fold (``Side.fold_instance``: pairs of points in one
    batched native call, a pair with an identity operand on IntCurve)
    against the IntCurve formula on both sides of the cycle, the counter
    ``INSTANCE_FOLDS`` beside it, and a short device-engine fold chain
    equal, instance for instance, to the same chain on IntCurve alone.
  * With no card the device engine raises; a ``slow`` test runs the
    full-shape device engine on the CPU against the native one (~30 min on one core).
  * The prover's spans: its default timer is off (a step never calls its
    sync); a recording one gets each section of a synthesis once a side and,
    on the device engine, the encode of a deferred witness and each part of
    a fold once a fold, under names the benchmark's readers do not sum.

Equality is exact: host ints, affine points, canonical witness values.
"""

from __future__ import annotations

import copy
import dataclasses

import pytest
import torch

from vdf_tpu.nova import ivc as jax_ivc
from vdf_tpu_torch import interop
from vdf_tpu_torch.curves.int_ops import get_int_curve
from vdf_tpu_torch.errors import KernelError, NovaError
from vdf_tpu_torch.fields import get_field, get_int_field
from vdf_tpu_torch.nova import InverseMinRootCircuit
from vdf_tpu_torch.nova import ivc as ivc_module
from vdf_tpu_torch.nova.augmented import AugmentedInputs
from vdf_tpu_torch.nova.ivc import (
    CanonicalWitness,
    HostInstance,
    HostRelaxedInstance,
    IVCProof,
    RecursiveIVC,
    Side,
    ivc_public_params,
    ivc_verify,
    state_hash,
)
from vdf_tpu_torch.nova.pedersen import derive_generators
from vdf_tpu_torch.r1cs.cs import ShapeCS, Variable
from vdf_tpu_torch.r1cs.gadgets import AllocatedNum
from vdf_tpu_torch.r1cs.witness import WitnessCS
from vdf_tpu_torch.utils import TEST_SEED, XorShiftRng, field_random
from vdf_tpu_torch.utils.profiling import PhaseTimer

torch.set_num_threads(1)  # many small tensor ops; see tests/test_torch_commit.py

T, N = 2, 3  # iterations a step, steps


def forward_eval(x: int, y: int, i: int, total: int):
    """Host-int forward MinRoot over Fq (the slow direction)."""
    f = get_int_field("Fq")
    invalpha = pow(5, -1, f.p - 1)
    for _ in range(total):
        x, y, i = pow((x + y) % f.p, invalpha, f.p), (x + i) % f.p, i + 1
    return x, y, i


def _start():
    x0 = field_random(XorShiftRng(TEST_SEED), get_int_field("Fq").p)
    start = (x0, 0, 1)
    return list(forward_eval(*start, N * T)), list(start)  # circuits walk backward


@pytest.fixture(scope="module")
def proven():
    """The port's native-engine proof, debug mode on (every constraint of
    every synthesis checked, the product cache re-derived)."""
    pp = ivc_public_params(T, engine="native")
    z0, zn = _start()
    prover = RecursiveIVC(pp, z0, debug=True)
    for _ in range(N - 1):
        prover.prove_step()
    return pp, prover.proof(), z0, zn


@pytest.fixture(scope="module")
def jax_proven():
    """The JAX package's native-engine proof on the same (T, z0, N)."""
    pp = jax_ivc.ivc_public_params(T, engine="native")
    z0, _ = _start()
    prover = jax_ivc.RecursiveIVC(pp, z0)
    for _ in range(N - 1):
        prover.prove_step()
    return pp, prover.proof()


# -- tests/test_ivc.py's 13 cases on the port


class TestIVC:
    def test_z_chain_reaches_initial_state(self, proven):
        pp, proof, z0, zn = proven
        assert proof.z_i == zn

    def test_verifies(self, proven):
        pp, proof, z0, zn = proven
        assert ivc_verify(pp, proof, N, z0, zn)

    def test_wrong_num_steps_rejected(self, proven):
        pp, proof, z0, zn = proven
        assert not ivc_verify(pp, proof, N + 1, z0, zn)
        assert not ivc_verify(pp, proof, 0, z0, zn)

    def test_wrong_output_rejected(self, proven):
        pp, proof, z0, zn = proven
        assert not ivc_verify(pp, proof, N, z0, [1, 2, 3])

    def test_wrong_input_rejected(self, proven):
        pp, proof, z0, zn = proven
        assert not ivc_verify(pp, proof, N, [z0[0] + 1, z0[1], z0[2]], zn)

    def test_tampered_state_hash_rejected(self, proven):
        pp, proof, z0, zn = proven
        bad = copy.copy(proof)
        bad.l_u_secondary = dataclasses.replace(
            proof.l_u_secondary, X=[proof.l_u_secondary.X[0] ^ 1, proof.l_u_secondary.X[1]])
        assert not ivc_verify(pp, bad, N, z0, zn)

    def test_tampered_accumulator_rejected(self, proven):
        pp, proof, z0, zn = proven
        U = proof.r_U_primary
        bad = copy.copy(proof)
        bad.r_U_primary = HostRelaxedInstance(U.comm_w, U.comm_e, [U.X[0] + 1, U.X[1]], U.u)
        assert not ivc_verify(pp, bad, N, z0, zn)

    def test_tampered_witness_rejected(self, proven):
        pp, proof, z0, zn = proven
        bad = copy.copy(proof)
        w = list(proof.r_W_primary)
        w[0] = (w[0] + 1) % pp.primary.field.params.modulus
        bad.r_W_primary = w
        assert not ivc_verify(pp, bad, N, z0, zn)

    def test_forged_claim_rejected(self, proven):
        """Recomputing the hash over a forged z_n breaks the SAT of the
        dangling instance."""
        pp, proof, z0, zn = proven
        forged_zn = [7, 8, 9]
        bad = copy.copy(proof)
        bad.z_i = forged_zn
        h = state_hash("Fq", pp.digest, N, z0, forged_zn, proof.r_U_secondary)
        bad.l_u_secondary = dataclasses.replace(proof.l_u_secondary,
                                                X=[h, proof.l_u_secondary.X[1]])
        assert not ivc_verify(pp, bad, N, z0, forged_zn)

    def test_proof_is_constant_size(self, proven):
        pp, proof, z0, zn = proven
        assert isinstance(proof.r_U_primary, HostRelaxedInstance)
        assert len(dataclasses.asdict(proof)) == 11
        assert len(proof.r_W_primary) == pp.primary.shape.num_aux
        assert len(proof.r_W_secondary) == pp.secondary.shape.num_aux

    def test_single_step_chain(self):
        """n = 1: the base case only (no folds yet) verifies."""
        pp = ivc_public_params(T, engine="native")
        z0 = list(forward_eval(5, 6, 0, T))
        proof = RecursiveIVC(pp, z0).proof()
        assert proof.z_i == [5, 6, 0]
        assert ivc_verify(pp, proof, 1, z0, [5, 6, 0])


class TestAugmentedShape:
    def test_shapes_synthesize_consistently(self):
        pp = ivc_public_params(T, engine="native")
        assert pp.primary.shape.num_inputs == 2
        assert pp.secondary.shape.num_inputs == 2
        assert pp.primary.shape.num_aux > 0
        assert pp.digest == ivc_public_params(T, engine="native").digest

    def test_debug_synthesis_satisfied(self):
        pp = ivc_public_params(T, engine="native")
        prover = RecursiveIVC(pp, list(forward_eval(11, 22, 0, T)), debug=True)
        prover.prove_step()
        assert prover.i == 2


def test_resume_extends_the_chain(proven):
    """A prover rehydrated from the proof takes one more step, and the
    longer chain verifies from a start one step further back."""
    pp, proof, z0, zn = proven
    prover = RecursiveIVC.resume(pp, copy.deepcopy(proof), debug=True)
    prover.prove_step()
    longer = prover.proof()
    assert longer.i == N + 1 and ivc_verify(pp, longer, N + 1, z0, longer.z_i)
    assert ivc_verify(pp, proof, N, z0, zn)  # the original proof is untouched
    f = get_int_field("Fq")
    x, y, i = longer.z_i  # one inverse step of T rounds back from zn
    assert [v % f.p for v in forward_eval(x, y, i, T)] == zn


# -- the prover's spans

# The spans the benchmark's readers sum (perfbench/metrics/): ivc.synth_ms and
# ivc.fold_ms by prefix, the compress readers by suffix.  A span inside one
# of those must match none of them, or its time counts twice.
READER_PREFIXES = ("fold/", "synthesize/")
READER_SUFFIXES = ("/two IPAs", "/outer sumcheck", "/inner sumcheck", "/gamma-matvec")
SYNTH_PARTS = ("alloc", "h_in", "ro", "fold", "base", "stepf", "h_out")
FOLD_PARTS = ("commit", "read", "challenge", "instance", "witness")
STEP_SPANS = {"synthesize/Fq", "synthesize/Fp", "fold/primary", "fold/secondary",
              "commit/pallas", "commit/vesta"}


def _unread(names) -> bool:
    return not any(n.startswith(READER_PREFIXES) or n.endswith(READER_SUFFIXES) for n in names)


def test_chain_step_spans(proven):
    pp, proof, _, _ = proven
    prover = RecursiveIVC.resume(pp, copy.deepcopy(proof))
    syncs = []
    prover.timer.sync = lambda: syncs.append(1)
    prover.prove_step()  # the default timer: off
    assert syncs == [] and not prover.timer.totals and not prover.timer.counts
    prover.timer = t = type(prover.timer)(prover.timer.sync)
    prover.prove_step()
    sections = {f"synth.{part}/{fld}": fld for part in SYNTH_PARTS for fld in ("Fq", "Fp")}
    assert set(t.counts) - STEP_SPANS == set(sections) and _unread(sections)
    for name, fld in sections.items():
        assert t.counts[name] == 1 and t.parents[name] == f"synthesize/{fld}"
    assert set(t.under()) == set(t.counts) - set(sections)
    assert len(syncs) == 2 * sum(t.counts.values())


def test_deferred_synthesis_spans_its_encode(proven):
    """On the device engine the witness's encode after a synthesis is a span
    of its own, outside ``synthesize/*``."""
    pp, proof, z0, _ = proven
    prover = RecursiveIVC.resume(pp, copy.deepcopy(proof))
    prover.timer = t = PhaseTimer()
    dev = dataclasses.replace(pp.primary, engine="device", device=torch.device("cpu"))
    inp = AugmentedInputs(pp.digest, 0, z0, z0, HostRelaxedInstance.default(), None, None)
    u, w, _ = prover._synth(dev, inp)
    assert u.comm_w is None and isinstance(w, CanonicalWitness)
    assert t.counts["synth.encode/Fq"] == 1 and t.parents["synth.encode/Fq"] is None
    assert set(t.under()) == {"synthesize/Fq", "synth.encode/Fq"} and _unread(["synth.encode/Fq"])


def test_device_fold_spans(small_sides):
    """Each part of fold_cached once a fold, whether the strict witness's
    commit was deferred (fused with T's) or done (T's alone)."""
    dev, nat = small_sides
    f = get_field("Fq")
    (x1, w1), (x2, w2) = _strict_instances(2)
    t = PhaseTimer()
    U, W, E, _, _, zp = dev.fold_cached(
        1, HostRelaxedInstance.default(), dev.zero_w(), dev.zero_e(), HostInstance(None, x1),
        CanonicalWitness(f.encode_canonical(w1, "cpu")), None, timer=t)
    dev.fold_cached(1, U, W, E, HostInstance(nat.host_plane.commit(w2), x2),
                    dev._lift(f.encode_canonical(w2, "cpu")), zp, timer=t)
    assert dict(t.counts) == {f"fold.{part}/pallas": 2 for part in FOLD_PARTS}
    assert _unread(t.counts)


# -- the port against the JAX package


def test_native_proof_equals_jax_packages(proven, jax_proven):
    _, proof, _, _ = proven
    _, ref = jax_proven
    for f in dataclasses.fields(IVCProof):
        got, want = getattr(proof, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name


def test_each_package_verifies_the_others_proof(proven, jax_proven):
    pp, proof, z0, zn = proven
    jax_pp, ref = jax_proven
    mine = interop.ivc_proof_from_jax(ref, engine="native")
    assert ivc_verify(pp, mine, N, z0, zn)
    d = interop.ivc_proof_to_jax(proof)
    for name in ("r_U_primary", "r_U_secondary"):
        d[name] = jax_ivc.HostRelaxedInstance(**d[name])
    d["l_u_secondary"] = jax_ivc.HostInstance(**d["l_u_secondary"])
    theirs = jax_ivc.IVCProof(**d)
    assert jax_ivc.ivc_verify(jax_pp, theirs, N, z0, zn)
    theirs.r_W_primary = [theirs.r_W_primary[0] + 1] + theirs.r_W_primary[1:]
    assert not jax_ivc.ivc_verify(jax_pp, theirs, N, z0, zn)


def test_interop_witness_forms(proven):
    """Witness handles cross as int lists, as JAX limb arrays and as the
    port's Montgomery tensors, and come back the same."""
    _, proof, _, _ = proven
    as_limbs = interop.ivc_proof_to_jax(proof, engine="device")
    assert as_limbs["r_W_primary"].shape == (len(proof.r_W_primary), 17)
    on_cpu = interop.ivc_proof_from_jax(IVCProof(**{
        **{f.name: getattr(proof, f.name) for f in dataclasses.fields(IVCProof)},
        **{k: as_limbs[k] for k in interop._IVC_WITNESSES}}), device="cpu")
    assert on_cpu.r_W_primary.dtype == torch.int32 and on_cpu.r_W_primary.shape[1] == 8
    back = interop.ivc_proof_to_jax(on_cpu)
    assert all(back[k] == getattr(proof, k) for k in interop._IVC_WITNESSES)
    assert back["r_U_secondary"] == dataclasses.asdict(proof.r_U_secondary)


def test_device_engine_needs_a_card(monkeypatch):
    """No fallback: with no CUDA device the default engine raises, and only
    the native engine or device="cpu" runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KernelError, match="no CUDA device"):
        ivc_public_params(1)
    with pytest.raises(KernelError, match="no CUDA device"):
        ivc_public_params(1, engine="device")
    with pytest.raises(ValueError, match="engine"):
        ivc_public_params(1, engine="auto")
    assert ivc_public_params(1, engine="native").primary.engine == "native"
    assert ivc_public_params(1, device="cpu").primary.device == torch.device("cpu")


# -- the device engine's fold on a small shape, device="cpu"

SMALL_T = 2  # inverse rounds of the small circuit: 8 constraints, a key of 16


def _small_shape():
    """InverseMinRootCircuit(2) with z_x, z_y public and z_i a witness: two
    inputs, like an augmented circuit."""
    cs = ShapeCS(get_int_field("Fq").p)
    z = [AllocatedNum.alloc_input(cs, "z_x"), AllocatedNum.alloc_input(cs, "z_y"),
         AllocatedNum(cs.alloc("z_i"))]
    InverseMinRootCircuit(SMALL_T).synthesize(cs, z)
    return cs.shape()


def _small_witness(x: int, y: int, i: int) -> list[int]:
    cs = WitnessCS(get_int_field("Fq"), inputs=[x, y], check=True)
    z = [AllocatedNum(Variable("input", 1), x), AllocatedNum(Variable("input", 2), y),
         AllocatedNum(cs.alloc("z_i", value=i), i)]
    InverseMinRootCircuit(SMALL_T).synthesize(cs, z)
    assert not cs.failed
    return cs.aux


@pytest.fixture(scope="module")
def small_sides():
    shape = _small_shape()
    fq = get_field("Fq")
    dev = Side(None, shape, fq, "pallas", "Fp", "device", torch.device("cpu"))
    nat = Side(None, shape, fq, "pallas", "Fp", "native")
    # both engines commit against the same generators (the key's z = 1)
    assert dev.ck.n == 16 and list(zip(*(get_field("Fp").decode(v) for v in dev.ck.gens[:2]))) \
        == list(nat.host_plane.gens)
    return dev, nat


def _strict_instances(k: int):
    """k satisfying strict (x, w) pairs of the small circuit."""
    rng = XorShiftRng(TEST_SEED)
    out = []
    for _ in range(k):
        x, y, i = (field_random(rng, 1 << 250) for _ in range(3))
        out.append(([x, y], _small_witness(x, y, i)))
    return out


def _fold_both(dev: Side, nat: Side, folds: int, check_cache: bool = False):
    """Fold `folds` fresh instances into the default accumulator on both
    engines; yields each fold's outputs."""
    d = 0xD16E57
    U_d = U_n = HostRelaxedInstance.default()
    W_d, E_d, W_n, E_n = dev.zero_w(), dev.zero_e(), nat.zero_w(), nat.zero_e()
    zp = None
    f = get_field("Fq")
    for x, w in _strict_instances(folds):
        u_n = HostInstance(nat.host_plane.commit(w), list(x))
        u_d = HostInstance(None, list(x))
        w_d = CanonicalWitness(f.encode_canonical(w, "cpu"))
        t_n, comm_t_n = nat.host_plane.cross(W_n, list(U_n.X), U_n.u, w, list(x))
        U_n, W_n, E_n, ct_n, r_n = nat.fold(d, U_n, W_n, E_n, u_n, w)
        assert ct_n == comm_t_n
        U_d, W_d, E_d, ct_d, r_d, zp = dev.fold_cached(d, U_d, W_d, E_d, u_d, w_d, zp,
                                                       check_cache=check_cache)
        yield (u_d, u_n, t_n, (U_d, W_d, E_d, ct_d, r_d), (U_n, W_n, E_n, ct_n, r_n), zp)


def test_device_fold_equals_native_fold(small_sides):
    dev, nat = small_sides
    f = get_field("Fq")
    n = 0
    for u_d, u_n, t_n, got, want, zp in _fold_both(dev, nat, 3, check_cache=True):
        U_d, W_d, E_d, ct_d, r_d = got
        U_n, W_n, E_n, ct_n, r_n = want
        assert u_d.comm_w == u_n.comm_w  # the fused pass's commit of the strict witness
        assert (ct_d, r_d) == (ct_n, r_n)
        assert dataclasses.asdict(U_d) == dataclasses.asdict(U_n)
        assert f.decode(W_d) == W_n and f.decode(E_d) == E_n
        if n == 0:  # E' = 0 + r T on the first fold
            assert f.decode(E_d) == [r_n * v % f.params.modulus for v in t_n]
        n += 1
    assert n == 3


def test_check_sat_agrees(small_sides):
    dev, nat = small_sides
    f = get_field("Fq")
    *_, (_, _, _, got, want, _) = _fold_both(dev, nat, 3)
    U_d, W_d, E_d, _, _ = got
    U_n, W_n, E_n, _, _ = want
    assert dev.check_sat(U_d, W_d, E_d) and nat.check_sat(U_n, W_n, E_n)
    W_bad = W_d.clone()
    W_bad[1] = f.add(W_bad[1], f.one("cpu"))
    assert not dev.check_sat(U_d, W_bad, E_d)
    assert not nat.check_sat(U_n, f.decode(W_bad), E_n)
    E_bad = E_d.clone()
    E_bad[0] = f.add(E_bad[0], f.one("cpu"))
    assert not dev.check_sat(U_d, W_d, E_bad)
    assert not nat.check_sat(U_n, W_n, f.decode(E_bad))
    U_bad = dataclasses.replace(U_d, u=U_d.u + 1)
    assert not dev.check_sat(U_bad, W_d, E_d) and not nat.check_sat(U_bad, W_n, E_n)
    U_bad = dataclasses.replace(U_d, comm_e=U_d.comm_w)
    assert not dev.check_sat(U_bad, W_d, E_d) and not nat.check_sat(U_bad, W_n, E_n)
    # a strict instance: E = None
    (x, w), = _strict_instances(1)
    w_d = dev._lift(f.encode_canonical(w, "cpu"))
    u = HostInstance(nat.host_plane.commit(w), x)
    assert dev.check_sat(u, w_d, None) and nat.check_sat(u, w, None)
    assert not dev.check_sat(dataclasses.replace(u, X=[x[0] + 1, x[1]]), w_d, None)


def test_witness_domain_is_checked(small_sides):
    """fold_cached refuses a Montgomery handle whose instance defers its
    commit (comm_w=None), and a CanonicalWitness whose instance is
    committed."""
    dev, nat = small_sides
    f = get_field("Fq")
    (x, w), = _strict_instances(1)
    U = HostRelaxedInstance.default()
    mont = dev._lift(f.encode_canonical(w, "cpu"))
    with pytest.raises(NovaError, match="comm_w=None"):
        dev.fold_cached(1, U, dev.zero_w(), dev.zero_e(), HostInstance(None, x), mont, None)
    with pytest.raises(NovaError, match="CanonicalWitness"):
        dev.fold_cached(1, U, dev.zero_w(), dev.zero_e(),
                        HostInstance(nat.host_plane.commit(w), x),
                        CanonicalWitness(f.encode_canonical(w, "cpu")), None)
    with pytest.raises(NovaError, match="Montgomery tensor"):
        dev.check_sat(HostInstance(None, x), CanonicalWitness(f.encode_canonical(w, "cpu")), None)


def test_stale_product_cache_raises(small_sides):
    dev, nat = small_sides
    folds = _fold_both(dev, nat, 2)
    u_d, _, _, (U1, W1, E1, _, _), _, zp1 = next(folds)
    (x, w), = _strict_instances(1)
    f = get_field("Fq")
    stale = (zp1[1], zp1[0], zp1[2])  # another accumulator's products
    with pytest.raises(NovaError, match="stale z-product cache"):
        dev.fold_cached(2, U1, W1, E1, HostInstance(None, x),
                        CanonicalWitness(f.encode_canonical(w, "cpu")), stale,
                        check_cache=True)
    # the right cache passes the same check
    dev.fold_cached(2, U1, W1, E1, HostInstance(None, x),
                    CanonicalWitness(f.encode_canonical(w, "cpu")), zp1, check_cache=True)


# -- the instance fold: the native call against the IntCurve formula

# (circuit field, commitment curve, transcript field) of each side
SIDES = {"primary": ("Fq", "pallas", "Fp"), "secondary": ("Fp", "vesta", "Fq")}


def int_fold_instance(side: Side, U, u, comm_t, r: int) -> HostRelaxedInstance:
    """The oracle: both commitments base + r pt by double-and-add on IntCurve."""
    c = get_int_curve(side.curve_name)
    p = side.field.params.modulus

    def scaled_add(base, pt):
        return c.to_affine(c.add(c.from_affine(base), c.scalar_mul(c.from_affine(pt), r)))

    return HostRelaxedInstance(scaled_add(U.comm_w, u.comm_w), scaled_add(U.comm_e, comm_t),
                               [(U.X[k] + r * u.X[k]) % p for k in range(2)], U.u + r)


def _neg_scaled(curve: str, pt, r: int):
    c = get_int_curve(curve)
    return c.to_affine(c.neg(c.scalar_mul(c.from_affine(pt), r)))


def _counted():
    return dict(ivc_module.INSTANCE_FOLDS)


def _increments(before: dict) -> tuple[int, int]:
    after = _counted()
    return after["native"] - before["native"], after["int"] - before["int"]


# case -> (U.comm_w, U.comm_e, u.comm_w, comm_t) from four points a, b, q, t
# and r, and the (native, int) pairs it counts
FOLD_CASES = {
    "points": (lambda cv, a, b, q, t, r: (a, b, q, t), (2, 0)),
    "base_none": (lambda cv, a, b, q, t, r: (a, None, q, t), (1, 1)),
    "point_none": (lambda cv, a, b, q, t, r: (a, b, q, None), (1, 1)),
    "both_none": (lambda cv, a, b, q, t, r: (a, None, q, None), (1, 1)),
    "default_accumulator": (lambda cv, a, b, q, t, r: (None, None, q, t), (0, 2)),
    "identity_result": (lambda cv, a, b, q, t, r: (_neg_scaled(cv, q, r), b, q, t), (2, 0)),
}


@pytest.mark.parametrize("case", list(FOLD_CASES))
@pytest.mark.parametrize("side_name", list(SIDES))
def test_fold_instance_matches_int_curve(side_name, case):
    """Pairs of points fold in the native call, a pair with an identity
    operand on IntCurve; a result at the identity (base = -(r Q)) comes back
    None.  The whole instance and the counter's increments are checked."""
    field_name, curve, tr_field = SIDES[side_name]
    side = Side(None, None, get_field(field_name), curve, tr_field, "native")
    a, b, q, t = derive_generators(curve, 3)
    rng = XorShiftRng(TEST_SEED)
    r = field_random(rng, 1 << 128)
    p = side.field.params.modulus
    make, counts = FOLD_CASES[case]
    comm_w, comm_e, u_comm_w, comm_t = make(curve, a, b, q, t, r)
    U = HostRelaxedInstance(comm_w, comm_e, [field_random(rng, p) for _ in range(2)],
                            field_random(rng, 1 << 200))
    u = HostInstance(u_comm_w, [field_random(rng, p) for _ in range(2)])
    before = _counted()
    got = side.fold_instance(U, u, comm_t, r)
    assert _increments(before) == counts
    assert dataclasses.asdict(got) == dataclasses.asdict(int_fold_instance(side, U, u, comm_t, r))
    if case == "identity_result":
        assert got.comm_w is None and got.comm_e is not None
    if case == "both_none":
        assert got.comm_e is None


def test_device_chain_instances_equal_int_path(small_sides, monkeypatch):
    """A short fold chain of the device engine (and the native engine beside
    it): the running instance after each fold equals that of the same chain
    with the native call patched out, so that IntCurve folds every pair.
    On each engine the default accumulator's first fold takes IntCurve for
    both pairs; its cross term is 0 (T = 0 against a zero accumulator), so
    the second fold's E pair has the identity as its base and takes
    IntCurve too; every other pair takes the native call."""
    dev, nat = small_sides
    folds = 3
    before = _counted()
    native = [(got[0], want[0]) for *_, got, want, _ in _fold_both(dev, nat, folds)]
    assert _increments(before) == (2 * (2 * folds - 3), 2 * 3)
    monkeypatch.setattr(Side, "fold_instance", int_fold_instance)
    before = _counted()
    oracle = [(got[0], want[0]) for *_, got, want, _ in _fold_both(dev, nat, folds)]
    assert _increments(before) == (0, 0)
    assert len(native) == len(oracle) == folds
    for (U_d, U_n), (V_d, V_n) in zip(native, oracle):
        assert dataclasses.asdict(U_d) == dataclasses.asdict(V_d)
        assert dataclasses.asdict(U_n) == dataclasses.asdict(V_n)
    assert native[-1][0].comm_w is not None and native[-1][0].comm_e is not None


# -- the full shape on the CPU's plain kernels


@pytest.mark.slow
def test_device_engine_full_shape_equals_native():
    """T = 1, 2 steps: the device engine on the CPU (keys of 2^14, the
    plain K3-K7) gives the native engine's proof instance for instance and
    witness for witness, and both verify."""
    t, steps = 1, 2
    z0 = list(forward_eval(3, 4, 5, t * steps))
    proofs = {}
    for engine, device in (("native", None), ("device", "cpu")):
        pp = ivc_public_params(t, engine=engine, device=device)
        prover = RecursiveIVC(pp, z0, debug=True)
        for _ in range(steps - 1):
            prover.prove_step()
        proofs[engine] = (pp, prover.proof())
        assert ivc_verify(pp, proofs[engine][1], steps, z0, [3, 4, 5])
    (_, nat), (_, dev) = proofs["native"], proofs["device"]
    for name in ("r_U_primary", "r_U_secondary", "l_u_secondary"):
        assert dataclasses.asdict(getattr(dev, name)) == dataclasses.asdict(getattr(nat, name))
    assert dev.z_i == nat.z_i
    for name, field in interop._IVC_WITNESSES.items():
        assert isinstance(getattr(dev, name), torch.Tensor)
        assert get_field(field).decode(getattr(dev, name)) == getattr(nat, name), name
