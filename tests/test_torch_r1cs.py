"""The port's R1CS tier (vdf_tpu_torch.r1cs, nova/circuit.py,
nova/r1cs_device.py) on the CPU against the JAX package and exact
integers: the step circuit's shape, its witness pass, and the device
matvec, cross term and relaxed check on seeded vectors.  Exact equality
at canonical integers.
"""

import numpy as np
import pytest
import torch

from vdf_tpu.fields import get_field as jax_get_field
from vdf_tpu.nova.circuit import InverseMinRootCircuit as JaxCircuit
from vdf_tpu.nova.r1cs_device import DeviceShape as JaxDeviceShape
from vdf_tpu_torch import interop, pallas_vdf
from vdf_tpu_torch.fields import get_field
from vdf_tpu_torch.nova import DeviceMatrix, DeviceShape, InverseMinRootCircuit
from vdf_tpu_torch.r1cs import ONE, AllocatedNum, LinearCombination, ShapeCS, WitnessCS

torch.set_num_threads(1)  # many small tensor ops; see tests/test_torch_commit.py


def seeded(field_name: str, n: int, seed: int) -> list[int]:
    p = get_field(field_name).params.modulus
    raw = np.random.default_rng(seed).bytes(32 * n)
    return [int.from_bytes(raw[32 * k : 32 * k + 32], "little") % p for k in range(n)]


def coo_lists(shape):
    return [(np.asarray(r).tolist(), np.asarray(c).tolist(), [int(k) for k in v])
            for r, c, v in (shape.a_coo, shape.b_coo, shape.c_coo)]


@pytest.mark.parametrize("field_name", ["Fq", "Fp"])
@pytest.mark.parametrize("t", [1, 2, 5])
def test_step_circuit_shape_matches_jax(field_name, t):
    p = get_field(field_name).params.modulus
    shape = InverseMinRootCircuit(t).shape(p).shape()
    want = JaxCircuit(t).shape(p).shape()
    assert (shape.num_cons, shape.num_aux, shape.num_inputs) == (3 * t + 5, 3 * t + 2, 6)
    assert (shape.num_cons, shape.num_aux, shape.num_inputs) == (
        want.num_cons, want.num_aux, want.num_inputs)
    assert coo_lists(shape) == coo_lists(want)


def test_witness_pass_satisfies_shape_and_walks_the_vdf_back():
    """The witness of t = 3 inverse rounds from a real MinRoot result
    satisfies the shape over exact ints, its outputs are the VDF's input
    state, and check=True reports a forged value."""
    t = 3
    vdf = pallas_vdf()
    f = vdf.field
    s0 = vdf.state_from_ints(424242, 17, 1, device="cpu")
    res = vdf.eval(s0, t)
    circ = InverseMinRootCircuit(t)
    cs, outs = circ.witness(f, list(res), check=True)
    assert cs.failed == []
    assert [f.decode(o) for o in outs] == list(vdf.state_to_ints(s0))
    shape = circ.shape(f.params.modulus).shape()
    w = f.decode(cs.witness())
    x = [f.decode(v) for v in res] + [f.decode(o) for o in outs]
    assert shape.is_satisfied(w, x)
    w[2] = (w[2] + 1) % f.params.modulus
    assert not shape.is_satisfied(w, x)

    bad = WitnessCS(f, inputs=[res.x], check=True)
    a = AllocatedNum(InverseMinRootCircuit._input_vars()[0], res.x)
    sq = a.square(bad)
    bad.enforce(a.lc(), a.lc(), sq.lc() + LinearCombination.of(ONE, 1), name="off by one")
    assert bad.failed == ["off by one"]


def test_forged_new_x_rejected():
    """The x-chain is bound by construction: a witness with an arbitrary
    new_x (satisfiable under the reference crate's free allocation) fails."""
    p = get_field("Fq").params.modulus
    shape = InverseMinRootCircuit(1).shape(p).shape()
    x, y, i = 12345, 67890, 7
    tmp1 = x * x % p
    tmp2 = tmp1 * tmp1 % p

    def assignment(new_x):
        new_y = (tmp2 * x - new_x) % p
        return ([tmp1, tmp2, new_y, new_x, (i - 1) % p],
                [x, y, i, new_x, new_y, (i - 1) % p])

    assert shape.is_satisfied(*assignment((y - (i - 1)) % p))
    assert not shape.is_satisfied(*assignment(999))


def test_shape_cs_and_lc_arithmetic():
    cs = ShapeCS(97)
    a = AllocatedNum.alloc_input(cs, "a")
    b = AllocatedNum(cs.alloc("b"))
    a.mul(cs, b, "ab")
    lc = a.lc() + b.lc(3) - a.lc()
    assert lc.terms[b.var] == 3 and lc.terms[a.var] == 0
    shape = cs.shape()
    assert (shape.num_cons, shape.num_aux, shape.num_inputs) == (1, 2, 1)
    assert shape.is_satisfied([5, 35], [7]) and not shape.is_satisfied([5, 36], [7])


@pytest.fixture(scope="module")
def shapes():
    f = get_field("Fq")
    shape = InverseMinRootCircuit(2).shape(f.params.modulus).shape()
    jshape = JaxCircuit(2).shape(f.params.modulus).shape()
    return (f, DeviceShape.build(f, shape, device="cpu"),
            jax_get_field("Fq"), JaxDeviceShape.build(jax_get_field("Fq"), jshape))


def test_matvec_cross_term_and_check_match_jax(shapes):
    f, dev, jf, jdev = shapes
    n = dev.shape.num_vars
    z1, z2 = seeded("Fq", n, seed=1), seeded("Fq", n, seed=2)
    tz1, tz2 = f.encode(z1, device="cpu"), f.encode(z2, device="cpu")
    jz1, jz2 = jf.encode(z1), jf.encode(z2)
    for m, jm, coo in ((dev.a, jdev.a, dev.shape.a_coo), (dev.b, jdev.b, dev.shape.b_coo),
                       (dev.c, jdev.c, dev.shape.c_coo)):
        got = f.decode(m.matvec(f, tz1))
        assert got == jf.decode(jm.matvec(jf, jz1))
        assert got == dev.shape.eval_lc_matrix(coo, z1)
    na = dev.shape.num_aux
    u1, u2 = z1[na], z2[na]
    got = dev.cross_term(f, tz1, tz1[na], tz2, tz2[na])
    want = jdev.cross_term(jf, jz1, jz1[na], jz2, jz2[na])
    assert f.decode(got) == jf.decode(want)
    assert torch.equal(got, interop.from_jax("Fq", np.asarray(want), device="cpu"))
    assert u1 != u2


def test_check_relaxed_on_a_real_witness_and_a_tampered_one(shapes):
    f, dev, jf, jdev = shapes
    vdf = pallas_vdf()
    s0 = vdf.state_from_ints(99, 3, 1, device="cpu")
    res = vdf.eval(s0, 2)
    cs, outs = InverseMinRootCircuit(2).witness(f, list(res))
    w = cs.witness()
    x = torch.stack(list(res) + outs)
    e = torch.zeros((dev.shape.num_cons, 8), dtype=torch.int32)
    one = f.one(device="cpu")
    assert dev.check_relaxed(f, w, e, x, one)
    jw, jx = (interop.to_jax("Fq", a) for a in (w, x))
    assert jdev.check_relaxed(jf, jw, interop.to_jax("Fq", e), jx, interop.to_jax("Fq", one))
    bad = w.clone()
    bad[1, 0] ^= 1
    assert not dev.check_relaxed(f, bad, e, x, one)
    assert not dev.check_relaxed(f, w, e, x, f.encode(2, device="cpu"))


@pytest.mark.parametrize("field_name", ["Fq", "Fp"])
def test_matvec_row_of_2_to_15_entries_of_p_minus_1(field_name):
    """A row's lazy digit sum at its largest: 2^15 entries, coefficient and
    variable both p - 1, so every product is 1 and every digit sum is the
    count; a second row sums 2^15 copies of p - 1 (a 270-bit value)."""
    f = get_field(field_name)
    p = f.params.modulus
    nnz = 1 << 15
    rows = torch.cat([torch.zeros(nnz, dtype=torch.int64), torch.ones(nnz, dtype=torch.int64)])
    cols = torch.cat([torch.zeros(nnz, dtype=torch.int64), torch.ones(nnz, dtype=torch.int64)])
    vals = f.encode(p - 1, device="cpu").expand(2 * nnz, 8).contiguous()
    m = DeviceMatrix(rows, cols, vals, num_rows=3)
    z = f.encode([p - 1, 1], device="cpu")
    assert f.decode(m.matvec(f, z)) == [nnz % p, nnz * (p - 1) % p, 0]
    with pytest.raises(ValueError):
        shape = InverseMinRootCircuit(1).shape(p).shape()
        wide = (np.zeros(nnz + 1, dtype=np.int32), np.zeros(nnz + 1, dtype=np.int32),
                [1] * (nnz + 1))
        shape.a_coo = wide
        DeviceShape.build(f, shape, device="cpu")
