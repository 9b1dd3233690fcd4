"""Port field arithmetic (vdf_tpu_torch.fields) against the int oracle and JAX.

The same inputs, from ``XorShiftRng(TEST_SEED)`` and
``np.random.default_rng``, go through the port's tensor ``Field``, the
host-int ``IntField`` and the JAX package's ``Field``.  Tolerance is
exact equality: this is integer arithmetic.  Values are compared at the
canonical-integer boundary, since the two packages keep different
Montgomery forms (R = 2^256 here, 2^272 in JAX).
"""

import numpy as np
import pytest
import torch

from vdf_tpu.fields import get_field as jax_get_field
from vdf_tpu_torch import interop
from vdf_tpu_torch.fields import FP, FQ, get_field, get_int_field, limbs_to_int
from vdf_tpu_torch.fields.ops import from_digits, resolve, to_digits
from vdf_tpu_torch.utils import TEST_SEED, XorShiftRng, field_random

# The plain versions are many small tensor ops: one intra-op thread runs
# them fastest, and test workers sharing the cores do not oversubscribe
# them (with a thread pool per worker they ran ~10x slower under load).
torch.set_num_threads(1)

FIELDS = [("Fq", FQ), ("Fp", FP)]
N = 24


def corner_values(p: int) -> list[int]:
    return [0, 1, p - 1, (1 << 256) % p]


def inputs(p: int, seed: int) -> tuple[list[int], list[int]]:
    """Corner values, xorshift values and numpy-drawn values, twice."""
    rng = XorShiftRng(TEST_SEED)
    nrng = np.random.default_rng(seed)

    def np_vals(n):
        limbs = nrng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
        return [limbs_to_int(row.astype(np.uint32)) % p for row in limbs]

    a = corner_values(p) + [field_random(rng, p) for _ in range(N)] + np_vals(N)
    b = corner_values(p)[::-1] + [field_random(rng, p) for _ in range(N)] + np_vals(N)
    return a, b


@pytest.fixture(params=FIELDS, ids=[n for n, _ in FIELDS])
def fields(request):
    name, params = request.param
    return name, params, get_field(name), get_int_field(name)


def _canonical_rows(t: torch.Tensor, p: int) -> bool:
    return all(limbs_to_int(row) < p for row in t.numpy())


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_vs_int_oracle_and_jax(fields, op):
    name, P, f, fi = fields
    a, b = inputs(P.modulus, seed=1)
    got_t = getattr(f, op)(f.encode(a), f.encode(b))
    assert _canonical_rows(got_t, P.modulus)
    got = f.decode(got_t)
    assert got == [getattr(fi, op)(x, y) for x, y in zip(a, b)]
    jf = jax_get_field(name)
    assert jf.decode(getattr(jf, op)(jf.encode(a), jf.encode(b))) == got


def test_sqr_pow_vs_int_oracle_and_jax(fields):
    name, P, f, fi = fields
    a, _ = inputs(P.modulus, seed=2)
    ta = f.encode(a)
    jf = jax_get_field(name)
    sq = f.decode(f.sqr(ta))
    assert sq == [fi.sqr(x) for x in a] == jf.decode(jf.sqr(jf.encode(a)))
    few = a[:6]
    assert f.decode(f.pow(f.encode(few), P.inv_alpha)) == [
        pow(x, P.inv_alpha, P.modulus) for x in few
    ]


def test_corner_values(fields):
    """0, 1, p-1 and R mod p through every op, all pairs."""
    _, P, f, fi = fields
    c = corner_values(P.modulus)
    a = [x for x in c for _ in c]
    b = [y for _ in c for y in c]
    ta, tb = f.encode(a), f.encode(b)
    for op in ("add", "sub", "mul"):
        out = getattr(f, op)(ta, tb)
        assert _canonical_rows(out, P.modulus)
        assert f.decode(out) == [getattr(fi, op)(x, y) for x, y in zip(a, b)], op
    assert f.decode(f.sqr(ta)) == [fi.sqr(x) for x in a]


def test_encode_decode_montgomery_limbs(fields):
    """encode gives the u32 limbs of a * 2^256 mod p as int32 bit patterns."""
    _, P, f, _ = fields
    a, _ = inputs(P.modulus, seed=3)
    t = f.encode(a)
    assert t.dtype == torch.int32 and t.shape == (len(a), 8)
    assert [limbs_to_int(r) for r in t.numpy()] == [(v << 256) % P.modulus for v in a]
    assert f.decode(t) == a
    one = f.encode(a[1])  # an int gives one (8,) element
    assert one.shape == (8,) and f.decode(one) == a[1]


def test_canon_and_eq_on_noncanonical_limbs(fields):
    """canon takes any 256-bit pattern (< 4p) to < p; eq compares values."""
    _, P, f, _ = fields
    p = P.modulus
    raw = [(1 << 256) - 1, p, 2 * p + 5, 3 * p, p - 1]
    t = torch.from_numpy(
        np.stack([np.frombuffer(v.to_bytes(32, "little"), "<u4") for v in raw]).view(np.int32)
    )
    assert [limbs_to_int(r) for r in f.canon(t).numpy()] == [v % p for v in raw]
    shifted = f.canon(t)
    assert bool(f.eq(t, shifted).all())
    assert not bool(f.eq(t, f.add(shifted, f.one().expand_as(shifted))).any())


def test_resolve_matches_integer_carry():
    nrng = np.random.default_rng(7)
    v = nrng.integers(0, 1 << 40, size=(64, 33), dtype=np.int64)
    v[0] = (1 << 16) - 1  # a full ripple of carries
    v[0, 0] = 1 << 16
    got = resolve(torch.from_numpy(v))
    for row, out in zip(v.tolist(), got.tolist()):
        want = sum(d << (16 * k) for k, d in enumerate(row)) % (1 << (16 * 33))
        assert sum(d << (16 * k) for k, d in enumerate(out)) == want
        assert max(out) < 1 << 16


def test_digit_round_trip():
    nrng = np.random.default_rng(11)
    limbs = torch.from_numpy(nrng.integers(-(1 << 31), 1 << 31, size=(32, 8), dtype=np.int32))
    assert torch.equal(from_digits(to_digits(limbs)), limbs)


def test_interop_round_trip(fields):
    """JAX Field.encode limbs -> port State -> back: identical arrays."""
    name, P, f, _ = fields
    a, b = inputs(P.modulus, seed=4)
    jf = jax_get_field(name)
    jx, jy, ji = (np.asarray(jf.encode(v)) for v in (a, b, a[::-1]))
    s = interop.state_from_jax(name, jx, jy, ji)
    assert f.decode(s.x) == a and f.decode(s.y) == b
    assert torch.equal(s.x, f.encode(a))
    for got, want in zip(interop.state_to_jax(name, s), (jx, jy, ji)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    one = interop.from_jax(name, np.asarray(jf.encode(a[5])))
    assert one.shape == (8,) and f.decode(one) == a[5]
