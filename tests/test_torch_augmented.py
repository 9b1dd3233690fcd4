"""The port's augmented circuits (vdf_tpu_torch.nova.augmented, its gadgets
and r1cs.bits) against the JAX package's on the CPU: the params digests
frozen in tests/test_golden.py, both shapes and witnesses at t = 2, the host
<-> circuit transcript parity of tests/test_augmented.py, the bit gadgets,
the native witness emitters against the Python paths, and the value-only
pass's blocks against the check=True pass at t = 1, 2, 100 and 1000.  Equality is
exact everywhere (host ints, COO triples).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_golden import PP_DIGESTS
from vdf_tpu.fields.int_field import get_int_field as jax_int_field
from vdf_tpu.nova import augmented as jax_augmented
from vdf_tpu.nova import ivc as jax_ivc
from vdf_tpu.r1cs import bits as jax_bits
from vdf_tpu.r1cs.cs import ONE as JAX_ONE
from vdf_tpu.r1cs.cs import LinearCombination as JaxLC
from vdf_tpu.r1cs.cs import ShapeCS as JaxShapeCS
from vdf_tpu.r1cs.gadgets import Num as JaxNum
from vdf_tpu.r1cs.witness import WitnessCS as JaxWitnessCS
from vdf_tpu_torch.curves import get_int_curve, hash_to_curve_ints
from vdf_tpu_torch.fields import get_field, get_int_field
from vdf_tpu_torch.native import ec_fold_witness_native, poseidon_permute_native
from vdf_tpu_torch.nova import augmented, ivc
from vdf_tpu_torch.nova.augmented import CHALLENGE_BITS, HASH_BITS, _truncated_squeeze
from vdf_tpu_torch.nova.gadgets.ec import AllocatedPoint
from vdf_tpu_torch.nova.gadgets.instance import (
    AllocatedInstance,
    AllocatedRelaxedInstance,
    _alloc_num,
)
from vdf_tpu_torch.nova.gadgets.sponge import TranscriptGadget
from vdf_tpu_torch.nova.ivc import HostInstance, HostRelaxedInstance, fold_challenge, state_hash
from vdf_tpu_torch.poseidon.int_poseidon import _permute_ints_py, checked_native
from vdf_tpu_torch.r1cs import bits
from vdf_tpu_torch.r1cs.cs import ONE, LinearCombination, ShapeCS
from vdf_tpu_torch.r1cs.gadgets import Num
from vdf_tpu_torch.r1cs.witness import WitnessCS
from vdf_tpu_torch.utils import TEST_SEED, XorShiftRng, field_random

torch.set_num_threads(1)  # many small tensor ops; see tests/test_torch_commit.py

T = 2
# Each side's circuit field and the curve whose points it handles natively
# (the OTHER side's commitment curve).
SIDES = [("Fq", "vesta"), ("Fp", "pallas")]


@pytest.mark.parametrize("t", [1, 2])
def test_pp_digest_frozen(t):
    """The port's own shapes and _shapes_digest reproduce the frozen
    digests of the JAX package's augmented R1CS."""
    assert ivc.ivc_public_params(t, engine="native").digest == PP_DIGESTS[t]
    _, _, shape_p, shape_s, digest = ivc._shapes(t)
    assert ivc._shapes_digest(shape_p, shape_s) == digest == PP_DIGESTS[t]


@pytest.fixture(scope="module")
def shapes():
    port = ivc._shapes(T)
    pc, sc = jax_augmented.make_circuits(T)
    return {"primary": (port[2], pc.shape()), "secondary": (port[3], sc.shape())}


@pytest.mark.parametrize("side", ["primary", "secondary"])
def test_shapes_equal_reference(shapes, side):
    mine, ref = shapes[side]
    assert (mine.num_cons, mine.num_aux, mine.num_inputs) == (
        ref.num_cons, ref.num_aux, ref.num_inputs)
    for a, b in zip((mine.a_coo, mine.b_coo, mine.c_coo), (ref.a_coo, ref.b_coo, ref.c_coo)):
        for x, y in zip(a, b):
            assert [int(v) for v in x] == [int(v) for v in y]


def _seed(k: int) -> bytes:
    """The reference's TEST_SEED with its first byte moved by k."""
    return bytes([(TEST_SEED[0] + k) % 256]) + TEST_SEED[1:]


def _points(curve_name: str, k: int, seed: int):
    """k affine points: hash-derived bases times xorshift scalars (IntCurve)."""
    c = get_int_curve(curve_name)
    rng = XorShiftRng(_seed(seed))
    bases = hash_to_curve_ints(curve_name, k, domain=b"test_torch_augmented")
    return [c.to_affine(c.scalar_mul(c.from_affine(b), field_random(rng, c.order)))
            for b in bases]


def _inputs(pkg, aug, side: str, base: bool):
    """The same AugmentedInputs in one package (its ivc and augmented
    modules) for one side: the base step, or step 3 with a nontrivial
    running instance."""
    primary = side == "primary"
    field_name, curve_name = SIDES[0] if primary else SIDES[1]
    other = jax_int_field("Fp" if primary else "Fq").p
    rng = XorShiftRng(_seed(17))
    z0 = [field_random(rng, get_int_field(field_name).p) for _ in range(3 if primary else 1)]
    d = ivc.ivc_public_params(T, engine="native").digest
    if base:
        u = (None if primary else
             pkg.HostInstance(_points(curve_name, 1, 3)[0], [5, (1 << HASH_BITS) - 7]))
        return aug.AugmentedInputs(d, 0, z0, z0, pkg.HostRelaxedInstance.default(), u, None)
    pts = _points(curve_name, 4, 9)
    U = pkg.HostRelaxedInstance(pts[0], pts[1], [field_random(rng, other),
                                                 field_random(rng, other)], (1 << 200) + 77)
    u = pkg.HostInstance(pts[2], [field_random(rng, 1 << HASH_BITS),
                                  field_random(rng, 1 << HASH_BITS)])
    z_i = [field_random(rng, get_int_field(field_name).p) for _ in z0]
    return aug.AugmentedInputs(d, 3, z0, z_i, U, u, pts[3])


@pytest.mark.parametrize("side", ["primary", "secondary"])
@pytest.mark.parametrize("base", [True, False], ids=["base", "step"])
def test_witness_equals_reference(side, base):
    """AugmentedCircuit.witness over IntField: the same aux, inputs and z_next
    as the JAX package's on the same host inputs."""
    k = 0 if side == "primary" else 1
    mine = augmented.make_circuits(T)[k]
    ref = jax_augmented.make_circuits(T)[k]
    cs, z = mine.witness(_inputs(ivc, augmented, side, base))
    cs_ref, z_ref = ref.witness(_inputs(jax_ivc, jax_augmented, side, base))
    assert len(cs.aux) == ivc._shapes(T)[2 + k].num_aux
    assert cs.aux == cs_ref.aux
    assert cs.inputs == cs_ref.inputs
    assert z == z_ref


@pytest.mark.parametrize("side", ["primary", "secondary"])
def test_native_witness_equals_python_paths(side):
    """check=True takes the Python rounds of the sponge and the instance
    fold; check=False takes poseidon_permute_native's S-box triples and
    ec_fold_witness_native's point values: the same witness."""
    assert checked_native().poseidon_permute_native is poseidon_permute_native
    k = 0 if side == "primary" else 1
    circ = augmented.make_circuits(T)[k]
    inp = _inputs(ivc, augmented, side, base=False)
    fast, z_fast = circ.witness(inp, check=False)
    slow, z_slow = circ.witness(inp, check=True)
    assert fast.aux == slow.aux and fast.inputs == slow.inputs and z_fast == z_slow
    # the step's inputs are made up, so only the hash check may fail
    assert slow.failed and all("h_in" in name for name in slow.failed)


@pytest.mark.parametrize("field_name,width", [("Fq", 3), ("Fp", 5), ("Fq", 9)])
def test_poseidon_permute_native_equals_python(field_name, width):
    p = get_int_field(field_name).p
    rng = XorShiftRng(_seed(width))
    state = [field_random(rng, p) for _ in range(width)]
    out, triples = poseidon_permute_native(field_name, state, emit_triples=True)
    assert out == poseidon_permute_native(field_name, state) == _permute_ints_py(
        field_name, state, width)
    x = (state[0] + _constants_rc0(field_name, width)) % p  # the first S-box's input
    assert triples[:3] == [x * x % p, pow(x, 4, p), pow(x, 5, p)]


def test_native_poseidon_that_disagrees_raises(monkeypatch):
    """A native permutation that disagrees with the Python rounds raises at
    permute_ints and at the sponge's block path: no path falls back to the
    Python rounds."""
    from vdf_tpu_torch import native
    from vdf_tpu_torch.poseidon import int_poseidon

    real = native._poseidon
    monkeypatch.setattr(native, "_poseidon", lambda *a: [v ^ 1 for v in real(*a)])
    int_poseidon.checked_native.cache_clear()
    with pytest.raises(RuntimeError, match="disagrees"):
        int_poseidon.permute_ints("Fq", [0] * 5)
    cs = WitnessCS(get_int_field("Fq"), inputs=[])
    assert cs.blocks
    tr = TranscriptGadget(cs, "Fq", name="tr")
    tr.absorb(*(Num(LinearCombination(), v) for v in (1, 2, 3)))
    with pytest.raises(RuntimeError, match="disagrees"):
        tr.squeeze()
    assert cs.num_aux == 0


def _constants_rc0(field_name: str, width: int) -> int:
    from vdf_tpu_torch.poseidon.params import round_constants

    return round_constants(field_name, width)[0][0][0]


@pytest.mark.parametrize("field_name", ["Fp", "Fq"])
def test_native_minroot_and_point_folds_equal_reference(field_name):
    """The wrappers carried for modules still to port give the JAX package's
    values: MinRoot both ways (and a round trip), a batched a P + b Q."""
    from vdf_tpu import native as jax_native
    from vdf_tpu_torch import native

    p = get_int_field(field_name).p
    rng = XorShiftRng(_seed(3))
    s = tuple(field_random(rng, p) for _ in range(3))
    fwd = native.minroot_eval_native(field_name, *s, 5)
    assert fwd == jax_native.minroot_eval_native(field_name, *s, 5)
    assert native.minroot_inverse_native(field_name, *fwd, 5) == s
    curve = "pallas" if field_name == "Fp" else "vesta"
    pts = _points(curve, 4, 11)
    a, b = field_random(rng, 1 << 128), field_random(rng, 1 << 128)
    got = native.fold_points_native(curve, pts[:2], pts[2:], a, b)
    assert got == jax_native.fold_points_native(curve, pts[:2], pts[2:], a, b)
    c = get_int_curve(curve)
    assert got[0] == c.to_affine(c.add(c.scalar_mul(c.from_affine(pts[0]), a),
                                       c.scalar_mul(c.from_affine(pts[2]), b)))


@pytest.mark.parametrize("field_name,curve_name", SIDES)
def test_ec_fold_witness_native_result(field_name, curve_name):
    """The last four values are (inf, zinv, x, y) of base + r pt, which
    IntCurve computes independently."""
    c = get_int_curve(curve_name)
    base, pt = _points(curve_name, 2, 5)
    r = field_random(XorShiftRng(TEST_SEED), 1 << CHALLENGE_BITS)
    bits_msb = [int(b) for b in bin(r)[2:].zfill(CHALLENGE_BITS)]
    out = ec_fold_witness_native(field_name, (*base, 1), (*pt, 1), bits_msb)
    assert len(out) == CHALLENGE_BITS * 23 + 12 + 4
    want = c.to_affine(c.add(c.from_affine(base), c.scalar_mul(c.from_affine(pt), r)))
    assert out[-4] == 0 and out[-2:] == list(want)


# -- the three host <-> circuit transcript parity tests of
#    tests/test_augmented.py, on the port's copies


def _fixture_instances(curve_name: str, field_name: str):
    pts = hash_to_curve_ints(curve_name, 4, domain=b"test_augmented")
    p_other = get_int_field({"Fq": "Fp", "Fp": "Fq"}[field_name]).p
    U = HostRelaxedInstance(
        comm_w=pts[0],
        comm_e=pts[1],
        X=[0x1234567890ABCDEF << 100 | 0x77, (p_other - 5) % p_other],
        u=(1 << 200) + 12345,
    )
    u = HostInstance(comm_w=pts[2], X=[(1 << HASH_BITS) - 3, 0xDEADBEEF << 64])
    return U, u, pts[3]


@pytest.mark.parametrize("field_name,curve_name", SIDES)
def test_state_hash_parity(field_name, curve_name):
    """Host state_hash == the circuit's h_in transcript output."""
    f = get_int_field(field_name)
    U, _, _ = _fixture_instances(curve_name, field_name)
    d, i = 0xABCDEF0123456789, 7
    z0 = [3, 0, 0] if field_name == "Fq" else [0]
    z_i = [11, 22, 33] if field_name == "Fq" else [0]
    want = state_hash(field_name, d, i, z0, z_i, U)

    cs = WitnessCS(f, inputs=[], check=True)
    d_n = _alloc_num(cs, "params", d)
    i_n = _alloc_num(cs, "i", i)
    z0_n = [_alloc_num(cs, f"z0_{k}", v) for k, v in enumerate(z0)]
    zi_n = [_alloc_num(cs, f"zi_{k}", v) for k, v in enumerate(z_i)]
    U_g = AllocatedRelaxedInstance.alloc(cs, "U", U)
    tr = TranscriptGadget(cs, field_name, name="hin")
    tr.absorb(d_n, i_n, *z0_n, *zi_n, *U_g.parts().absorb_elements())
    h, _ = _truncated_squeeze(cs, tr, HASH_BITS, "hin")
    assert not cs.failed, cs.failed[:5]
    assert h.value == want


@pytest.mark.parametrize("field_name,curve_name", SIDES)
def test_fold_challenge_parity(field_name, curve_name):
    """Host fold_challenge == the circuit's RO transcript output."""
    f = get_int_field(field_name)
    U, u, comm_t = _fixture_instances(curve_name, field_name)
    d = 0x1122334455667788
    want = fold_challenge(field_name, d, U, u, comm_t)

    cs = WitnessCS(f, inputs=[], check=True)
    d_n = _alloc_num(cs, "params", d)
    U_g = AllocatedRelaxedInstance.alloc(cs, "U", U)
    u_g = AllocatedInstance.alloc(cs, "u", u)
    t_g = AllocatedPoint.alloc(cs, "comm_t", comm_t)
    tr = TranscriptGadget(cs, field_name, name="ro")
    tr.absorb(d_n, *U_g.parts().absorb_elements(), *u_g.absorb_elements(),
              *t_g.absorb_elements())
    r, r_bits = _truncated_squeeze(cs, tr, CHALLENGE_BITS, "r")
    assert not cs.failed, cs.failed[:5]
    assert r.value == want
    assert len(r_bits) == CHALLENGE_BITS


@pytest.mark.parametrize("field_name,curve_name", SIDES)
def test_identity_point_encoding_parity(field_name, curve_name):
    """None (identity) commitments hash identically host vs circuit."""
    f = get_int_field(field_name)
    U = HostRelaxedInstance.default()
    d, i = 99, 0
    z0 = [5] if field_name == "Fp" else [1, 2, 3]
    want = state_hash(field_name, d, i, z0, z0, U)

    cs = WitnessCS(f, inputs=[], check=True)
    d_n = _alloc_num(cs, "params", d)
    i_n = _alloc_num(cs, "i", i)
    z_n = [_alloc_num(cs, f"z_{k}", v) for k, v in enumerate(z0)]
    U_g = AllocatedRelaxedInstance.alloc(cs, "U", U)
    tr = TranscriptGadget(cs, field_name, name="hin")
    tr.absorb(d_n, i_n, *z_n, *z_n, *U_g.parts().absorb_elements())
    h, _ = _truncated_squeeze(cs, tr, HASH_BITS, "hin")
    assert not cs.failed, cs.failed[:5]
    assert h.value == want


# -- r1cs/bits.py against the JAX package's


def _bit_gadgets(pkg_bits, num_cls, cs, value):
    """Every gadget of bits.py once; returns the bit values (None in the
    shape pass)."""
    w = hasattr(cs, "aux")
    lc_cls, one = (LinearCombination, ONE) if num_cls is Num else (JaxLC, JAX_ONE)
    var = cs.alloc("x", value=value) if w else cs.alloc("x")
    x = num_cls(lc_cls.of(var, 1), value)
    low = pkg_bits.num_to_bits_le(cs, x, 64 if value is None or value < 1 << 64 else 255, "lo")
    strict = pkg_bits.num_to_bits_le_strict(cs, x, "st")
    both = strict[0].and_(cs, strict[1], "and01")
    sel = pkg_bits.num_select(cs, strict[2], x, num_cls(lc_cls.of(one, 1), 1 if w else None),
                              "sel")
    lc = pkg_bits.bits_to_lc(strict[:8])
    return ([b.value for b in low + strict] + [both.value, sel.value,
                                               pkg_bits.bits_value(strict, 16)],
            sorted((str(k), v) for k, v in lc.terms.items()))


@pytest.mark.parametrize("value", [0, 1, 0xFFFF_FFFF_FFFF, "p-1", "random"])
def test_bits_gadgets_equal_reference(value):
    f, f_ref = get_int_field("Fq"), jax_int_field("Fq")
    p = f.p
    if value == "p-1":
        value = p - 1
    elif value == "random":
        value = field_random(XorShiftRng(TEST_SEED), p)
    wit = WitnessCS(f, inputs=[], check=True)
    wit_ref = JaxWitnessCS(f_ref, inputs=[], check=True)
    got = _bit_gadgets(bits, Num, wit, value)
    want = _bit_gadgets(jax_bits, JaxNum, wit_ref, value)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert wit.aux == wit_ref.aux and not wit.failed and not wit_ref.failed
    shape = ShapeCS(p)
    shape_ref = JaxShapeCS(p)
    _bit_gadgets(bits, Num, shape, None if value >= 1 << 64 else value)
    _bit_gadgets(jax_bits, JaxNum, shape_ref, None if value >= 1 << 64 else value)
    mine, ref = shape.shape(), shape_ref.shape()
    assert (mine.num_cons, mine.num_aux) == (ref.num_cons, ref.num_aux)
    for a, b in zip((mine.a_coo, mine.b_coo, mine.c_coo), (ref.a_coo, ref.b_coo, ref.c_coo)):
        assert all(np.array_equal(np.asarray(x, dtype=object), np.asarray(y, dtype=object))
                   for x, y in zip(a, b))


def test_witness_cs_check_over_int_field():
    """WitnessCS(check=True) over IntField: a good witness passes, one broken
    constraint is named; an empty LC evaluates to the field's zero."""
    f = get_int_field("Fp")
    cs = WitnessCS(f, inputs=[], check=True)
    a = cs.alloc("a", value=6)
    b = cs.alloc("b", value=7)
    good = cs.alloc("good", value=42)
    bad = cs.alloc("bad", value=43)
    with cs.namespace("mul"):
        cs.enforce(LinearCombination.of(a, 1), LinearCombination.of(b, 1),
                   LinearCombination.of(good, 1), name="ok")
        cs.enforce(LinearCombination.of(a, 1), LinearCombination.of(b, 1),
                   LinearCombination.of(bad, 1), name="broken")
    cs.enforce(LinearCombination.of(a, 1), LinearCombination(), LinearCombination(), name="zero")
    assert cs.failed == ["mul/broken"]
    assert cs.eval_lc(LinearCombination()) == 0 and isinstance(cs.eval_lc(LinearCombination()),
                                                               int)


# -- the value-only pass's blocks (WitnessCS.blocks: the native emitters'
#    buffers and the bit decompositions as (k, 4) uint64 blocks)


def _chain_inputs(pkg, aug, t: int, side: str, step: int):
    """AugmentedInputs of one side in one package: the base step (0), or a
    later step (1, 2, 3) with a nontrivial running instance; step 2 folds an
    identity comm_T, step 3 an identity comm_T into a running instance whose
    comm_E is the identity."""
    primary = side == "primary"
    field_name, curve_name = SIDES[0] if primary else SIDES[1]
    p = get_int_field(field_name).p
    other = get_int_field("Fp" if primary else "Fq").p
    rng = XorShiftRng(_seed(40 + step + (0 if primary else 8)))
    d = field_random(rng, 1 << HASH_BITS)
    z0 = [field_random(rng, p) for _ in range(3 if primary else 1)]
    if step == 0:
        u = (None if primary else
             pkg.HostInstance(_points(curve_name, 1, 50)[0], [7, (1 << HASH_BITS) - 9]))
        return aug.AugmentedInputs(d, 0, z0, z0, pkg.HostRelaxedInstance.default(), u, None)
    pts = _points(curve_name, 4, 50 + step)
    comm_e = None if step == 3 else pts[1]
    comm_t = None if step >= 2 else pts[3]
    U = pkg.HostRelaxedInstance(pts[0], comm_e, [field_random(rng, other),
                                                 field_random(rng, other)],
                                field_random(rng, 1 << (128 + step)))
    u = pkg.HostInstance(pts[2], [field_random(rng, 1 << HASH_BITS),
                                  field_random(rng, 1 << HASH_BITS)])
    z_i = [field_random(rng, p) for _ in z0]
    return aug.AugmentedInputs(d, step, z0, z_i, U, u, comm_t)


@pytest.mark.parametrize("t", [1, 2, 100, 1000])
@pytest.mark.parametrize("side", ["primary", "secondary"])
@pytest.mark.parametrize("step", [0, 1, 2, 3])
def test_block_witness_equals_check_pass(t, side, step):
    """The value-only pass's aux_u64() is, byte for byte, encode_canonical of
    the check=True pass's ints (which takes no block path), and its limbs
    those bytes; at t = 2 the JAX package's witness gives the same bytes."""
    k = 0 if side == "primary" else 1
    circ = augmented.make_circuits(t)[k]
    inp = _chain_inputs(ivc, augmented, t, side, step)
    fast, z_fast = circ.witness(inp)
    slow, z_slow = circ.witness(inp, check=True)
    assert fast.blocks and not slow.blocks
    f = fast.field
    words = fast.aux_u64()
    want = get_field(circ.field_name).encode_canonical(slow.aux, "cpu")
    assert words.shape == (slow.num_aux, 4) == (fast.num_aux, 4)
    assert words.tobytes() == want.numpy().tobytes()
    assert torch.equal(get_field(circ.field_name).encode_canonical_u64(words, "cpu"), want)
    assert fast.aux == slow.aux and fast.inputs == slow.inputs and z_fast == z_slow
    assert all(0 <= v < f.p for v in fast.aux)
    # made-up inputs: only the input hash's check may fail
    assert all("h_in" in name for name in slow.failed)
    if t == 2:
        ref = jax_augmented.make_circuits(t)[k]
        cs_ref, z_ref = ref.witness(_chain_inputs(jax_ivc, jax_augmented, t, side, step))
        assert words.tobytes() == b"".join(int(v).to_bytes(32, "little") for v in cs_ref.aux)
        assert fast.inputs == cs_ref.inputs and z_fast == z_ref


def test_block_counter():
    """A value-only synthesis counts most of its elements as blocks; a
    check=True one counts none."""
    from vdf_tpu_torch.r1cs import witness

    circ = augmented.make_circuits(100)[0]
    inp = _chain_inputs(ivc, augmented, 100, "primary", 1)
    before = dict(witness.ELEMENTS)
    cs, _ = circ.witness(inp)
    mid = dict(witness.ELEMENTS)
    blocks, singles = mid["block"] - before["block"], mid["single"] - before["single"]
    assert blocks + singles == cs.num_aux
    assert blocks / cs.num_aux >= 0.9
    slow, _ = circ.witness(inp, check=True)
    after = dict(witness.ELEMENTS)
    assert after["block"] == mid["block"]
    assert after["single"] - mid["single"] == slow.num_aux


def _decompositions(cs, value: int, modulus: int):
    """Every bit decomposition of the value-only pass on one value, in one
    constraint system; -> the bits each returned."""
    from vdf_tpu_torch.nova.gadgets.bignat import BigNat

    x = Num(LinearCombination.of(cs.alloc("x", value=value), 1), value)
    outs = [bits.num_to_bits_le(cs, x, 255, "all"),
            bits.num_to_bits_le_strict(cs, x, "st"),
            BigNat.alloc(cs, "bn", value).limbs,
            bits.alloc_bits_le(cs, value, 128, "k")]
    if value < 1 << 250:
        outs.append(bits.num_to_bits_le(cs, x, 250, "x"))
    return outs


@pytest.mark.parametrize("field_name", ["Fp", "Fq"])
@pytest.mark.parametrize("value", [0, 1, "p-1", "2^250-1", "random"])
def test_bit_blocks_equal_per_element_bits(field_name, value):
    """num_to_bits_le, num_to_bits_le_strict (with its "equal so far" chain),
    BigNat.alloc and alloc_bits_le as one block each: the same aux values,
    bit values and variables as one AllocatedBit at a time."""
    f = get_int_field(field_name)
    value = {"p-1": f.p - 1, "2^250-1": (1 << 250) - 1,
             "random": field_random(XorShiftRng(_seed(60)), f.p)}.get(value, value)
    fast = WitnessCS(f, inputs=[])
    slow = WitnessCS(f, inputs=[], check=True)
    got = _decompositions(fast, value, f.p)
    want = _decompositions(slow, value, f.p)
    assert fast.num_aux == slow.num_aux and fast.aux == slow.aux
    assert fast.aux_u64().tobytes() == get_field(field_name).encode_canonical(
        slow.aux, "cpu").numpy().tobytes()
    for g, w in zip(got, want):
        if isinstance(g[0], Num):  # BigNat limbs
            assert [n.value for n in g] == [n.value for n in w]
            continue
        assert isinstance(g, bits.BitBlock) and len(g) == len(w)
        assert [b.value for b in g] == [b.value for b in w]
        assert [b.var for b in g] == [b.var for b in w]
        assert bits.bits_value(g) == bits.bits_value(w)
        assert bits.bits_value(g, 85) == bits.bits_value(w, 85)
        assert [b.value for b in g[3:90]] == [b.value for b in w[3:90]]
        assert list(g.msb_first()) == [b.value for b in reversed(w)]
    assert not slow.failed


def test_alloc_block_needs_a_value_only_pass():
    from vdf_tpu_torch.errors import SynthesisError

    cs = WitnessCS(get_int_field("Fq"), inputs=[], check=True)
    with pytest.raises(SynthesisError):
        cs.alloc_block(np.zeros((2, 4), dtype=np.uint64))


def test_block_counter_under_threads():
    """Syntheses on several threads (prove_interleaved's case) lose no count:
    16 threads on a short switch interval, each its own WitnessCS."""
    import sys
    import threading

    from vdf_tpu_torch.r1cs import witness

    f = get_int_field("Fq")

    def work():
        cs = WitnessCS(f, inputs=[])
        for k in range(400):
            cs.alloc("x", value=k)
            if k % 50 == 0:
                cs.alloc_block(np.zeros((3, 4), dtype=np.uint64))

    before = dict(witness.ELEMENTS)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert witness.ELEMENTS["single"] - before["single"] == 16 * 400
    assert witness.ELEMENTS["block"] - before["block"] == 16 * 8 * 3
