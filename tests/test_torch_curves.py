"""Port curves (vdf_tpu_torch.curves) against the JAX package and ints.

The same points go to the port's ``Curve``, the JAX package's
``vdf_tpu.curves.point.Curve`` (carried across with ``interop``) and the
host-int ``IntCurve``.  All three run the same complete RCB15 formulas
over canonical values mod p, so add, double and neg agree as projective
integer triples, exactly; scalar multiplication by a different algorithm
(``IntCurve.scalar_mul``) agrees in affine.  The inputs cover identity +
P, P + P, P + (-P), the identity doubled and a point with z != 1.
"""

import numpy as np
import pytest
import torch

from vdf_tpu.curves import get_curve as jax_get_curve
from vdf_tpu.curves import hash_to_curve_ints as jax_hash_to_curve_ints
from vdf_tpu.curves.point import Point as JaxPoint
from vdf_tpu.nova.pedersen import commitment_key as jax_commitment_key
from vdf_tpu_torch import interop
from vdf_tpu_torch.curves import IDENTITY, Point, get_curve, get_int_curve, hash_to_curve_ints
from vdf_tpu_torch.fields import Field
from vdf_tpu_torch.nova import commitment_key

# The plain versions are many small tensor ops: one intra-op thread runs
# them fastest, and test workers sharing the cores do not oversubscribe
# them (with a thread pool per worker they ran ~10x slower under load).
torch.set_num_threads(1)

CURVES = ["pallas", "vesta"]


def triples(curve_name: str):
    """Projective int triples (x, y, z): hash-derived points, the
    identity, -P and 2P (z != 1)."""
    ic = get_int_curve(curve_name)
    pts = [ic.from_affine(a) for a in hash_to_curve_ints(curve_name, 4, domain=b"vdf_tpu/t")]
    return pts + [IDENTITY, ic.neg(pts[0]), ic.double(pts[1])]


def pairs(curve_name: str):
    """(P, Q) operand lists covering P + Q, O + P, P + P, P + (-P), O + O
    and a z != 1 operand."""
    t = triples(curve_name)
    ps = [t[0], t[4], t[0], t[0], t[4], t[6], t[2]]
    qs = [t[1], t[0], t[0], t[5], t[4], t[3], t[6]]
    return ps, qs


def port_point(curve_name: str, trips) -> Point:
    f = get_curve(curve_name).field
    return Point(*(f.encode([tr[k] for tr in trips], device="cpu") for k in range(3)))


def port_triples(curve_name: str, p: Point):
    f = get_curve(curve_name).field
    return list(zip(*(f.decode(a) for a in p)))


def jax_point(curve_name: str, trips) -> JaxPoint:
    import jax.numpy as jnp

    fname = get_curve(curve_name).params.base_field
    return JaxPoint(*(jnp.asarray(interop.ints_to_jax_limbs(fname, [tr[k] for tr in trips]))
                      for k in range(3)))


def jax_triples(curve_name: str, p: JaxPoint):
    fname = get_curve(curve_name).params.base_field
    return list(zip(*(interop.jax_limbs_to_ints(fname, np.asarray(a)) for a in p)))


@pytest.mark.parametrize("curve_name", CURVES)
def test_interop_round_trips_points(curve_name):
    t = triples(curve_name)
    jp = jax_point(curve_name, t)
    p = interop.point_from_jax(curve_name, jp, device="cpu")
    assert port_triples(curve_name, p) == t
    back = interop.point_to_jax(curve_name, p)
    assert jax_triples(curve_name, JaxPoint(*back)) == t


@pytest.mark.parametrize("curve_name", CURVES)
def test_add_double_neg_match_jax_and_ints(curve_name):
    c, jc, ic = get_curve(curve_name), jax_get_curve(curve_name), get_int_curve(curve_name)
    ps, qs = pairs(curve_name)
    p, q = port_point(curve_name, ps), port_point(curve_name, qs)
    jp, jq = interop.point_to_jax(curve_name, p), interop.point_to_jax(curve_name, q)
    jp, jq = JaxPoint(*jp), JaxPoint(*jq)

    want = [ic.add(a, b) for a, b in zip(ps, qs)]
    assert port_triples(curve_name, c.add(p, q)) == want
    assert jax_triples(curve_name, jc.add(jp, jq)) == want
    want = [ic.double(a) for a in ps]
    assert port_triples(curve_name, c.double(p)) == want
    assert jax_triples(curve_name, jc.double(jp)) == want
    want = [ic.neg(a) for a in ps]
    assert port_triples(curve_name, c.neg(p)) == want
    assert jax_triples(curve_name, jc.neg(jp)) == want


@pytest.mark.parametrize("curve_name", CURVES)
def test_edge_cases_and_predicates(curve_name):
    """O + P = P, P + (-P) = O, P + P = 2P, 2O = O; eq and is_identity
    agree with the JAX package and IntCurve."""
    c, jc, ic = get_curve(curve_name), jax_get_curve(curve_name), get_int_curve(curve_name)
    ps, qs = pairs(curve_name)
    p, q = port_point(curve_name, ps), port_point(curve_name, qs)
    jp, jq = JaxPoint(*interop.point_to_jax(curve_name, p)), JaxPoint(*interop.point_to_jax(curve_name, q))
    s = c.add(p, q)
    assert port_triples(curve_name, s)[1] == ic.add(IDENTITY, ps[0])  # O + P
    assert c.is_identity(s).tolist() == [ic.is_identity(ic.add(a, b)) for a, b in zip(ps, qs)]
    assert c.is_identity(s)[3] and c.is_identity(s)[4]  # P + (-P), O + O
    assert bool(c.eq(s, c.double(p))[2])  # P + P == 2P
    want_eq = [ic.eq(a, b) for a, b in zip(ps, qs)]
    assert c.eq(p, q).tolist() == want_eq
    assert np.asarray(jc.eq(jp, jq)).tolist() == want_eq
    assert c.eq(p, p).all()
    assert c.is_identity(c.double(c.identity((2,), device="cpu"))).all()
    sel = c.select(torch.tensor([True, False] * 3 + [True]), p, q)
    assert port_triples(curve_name, sel) == [a if k % 2 == 0 else b
                                             for k, (a, b) in enumerate(zip(ps, qs))]


@pytest.mark.parametrize("curve_name", CURVES)
def test_generator_and_affine_round_trip(curve_name):
    c = get_curve(curve_name)
    p = c.field.params.modulus
    assert c.to_affine_ints(c.generator((1,), device="cpu")) == [(p - 1, 2)]
    aff = hash_to_curve_ints(curve_name, 3, domain=b"vdf_tpu/t")
    assert c.to_affine_ints(c.from_affine_ints(aff, device="cpu")) == aff
    assert c.to_affine_ints(c.identity((2,), device="cpu")) == [None, None]


@pytest.mark.parametrize("curve_name", CURVES)
@pytest.mark.parametrize("batched", [False, True], ids=["(8,)", "(k, 8)"])
def test_to_affine_ints_decodes_in_one_read(curve_name, batched, monkeypatch):
    """to_affine_ints of each point as (8,) coordinates and of all as one
    (k, 8) batch, the identity and a z != 1 point among them: IntCurve's
    affine values, from exactly one Field.decode a call."""
    ic, c = get_int_curve(curve_name), get_curve(curve_name)
    trips = triples(curve_name)
    pt = port_point(curve_name, trips)
    pts = [pt] if batched else [Point(*(v[k] for v in pt)) for k in range(len(trips))]
    reads = []
    decode = Field.decode
    monkeypatch.setattr(Field, "decode", lambda self, a: reads.append(a.shape) or decode(self, a))
    got = []
    for p in pts:
        got += c.to_affine_ints(p)
    assert got == [ic.to_affine(t) for t in trips]
    assert None in got and len(reads) == len(pts)


@pytest.mark.parametrize("curve_name", CURVES)
def test_scalar_mul_bits_matches_jax_and_ints(curve_name):
    """The JAX package's own test shape (generator (1,), 64 bits), so its
    persistent compile cache serves the JAX side; the port also runs a
    batch of scalars against IntCurve."""
    import jax.numpy as jnp

    c, jc, ic = get_curve(curve_name), jax_get_curve(curve_name), get_int_curve(curve_name)
    k = 0xDEADBEEF12345
    jbits = jnp.asarray([[(k >> b) & 1] for b in range(64)], dtype=jnp.uint8)
    want = jax_triples(curve_name, jc.scalar_mul_bits(jc.generator((1,)), jbits))
    ks = [k, 0, 1, (1 << 64) - 1]
    bits = torch.tensor([[(v >> b) & 1 for v in ks] for b in range(64)], dtype=torch.uint8)
    got = c.scalar_mul_bits(c.generator((len(ks),), device="cpu"), bits)
    assert port_triples(curve_name, got)[:1] == want
    g = ic.from_affine(c.to_affine_ints(c.generator((1,), device="cpu"))[0])
    assert c.to_affine_ints(got) == [ic.to_affine(ic.scalar_mul(g, v)) for v in ks]


@pytest.mark.parametrize("curve_name", CURVES)
def test_hash_to_curve_and_key_generators_match_jax(curve_name):
    assert hash_to_curve_ints(curve_name, 8) == jax_hash_to_curve_ints(curve_name, 8)
    n = 5
    ck, jck = commitment_key(curve_name, n, device="cpu"), jax_commitment_key(curve_name, n)
    jc = jax_get_curve(curve_name)
    c = get_curve(curve_name)
    assert c.to_affine_ints(ck.gens) == jc.to_affine_ints(jck.gens)
    h = Point(*(v[None] for v in ck.h))
    assert c.to_affine_ints(h) == jc.to_affine_ints(JaxPoint(*(v[None] for v in jck.h)))
    carried = interop.commitment_key_from_jax(jck, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(carried.gens, ck.gens))
    assert all(torch.equal(a, b) for a, b in zip(carried.h, ck.h))


@pytest.mark.parametrize("field_name", ["Fp", "Fq"])
def test_sqrt_mod_matches_jax(field_name):
    """One exponentiation a candidate: the same root as the JAX package's
    Tonelli–Shanks, and None for exactly its non-residues."""
    from vdf_tpu.curves.point import sqrt_mod as jax_sqrt_mod
    from vdf_tpu_torch.curves import sqrt_mod
    from vdf_tpu_torch.fields import get_field

    p = get_field(field_name).params.modulus
    rng = np.random.default_rng(5)
    values = [0, 1, 4, 5, p - 1] + [int.from_bytes(rng.bytes(32), "little") % p
                                    for _ in range(200)]
    got = [sqrt_mod(a, p) for a in values]
    assert got == [jax_sqrt_mod(a, p) for a in values]
    assert None in got and all(r is None or r * r % p == a for r, a in zip(got, values))
