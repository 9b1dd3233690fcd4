"""The port's variable-base MSM (curves/msm.py) and its Horner step K9
(curves/kernels.py::horner) on the CPU, against IntCurve, the native C++
Pippengers and the JAX package.

On CPU tensors every kernel wrapper runs its plain version, so these tests
hold the MSM's algorithm and layout: K3's window-row keys, the sort, K4 run
sums over the unshifted points with K = 22 batch rows, K5, K6 and K9.  The
kernel bodies are held against the plain versions by
tests/test_torch_msm_kernel_host.py and, on the card, by the ``gpu`` tests
and chip_smoke.py.  Inputs are made with numpy from fixed seeds; results
are compared in affine at canonical integers, exactly.
"""

import numpy as np
import pytest
import torch

from vdf_tpu.curves import get_curve as jax_get_curve
from vdf_tpu.curves.msm import msm as jax_msm
from vdf_tpu.native import msm_native as jax_msm_native
from vdf_tpu_torch import interop
from vdf_tpu_torch.curves import (
    Point,
    get_curve,
    get_int_curve,
    hash_to_curve_ints,
    msm,
    stack_point,
)
from vdf_tpu_torch.curves import kernels as CK
from vdf_tpu_torch.curves.bucket_msm import ROWS
from vdf_tpu_torch.curves.msm import msm_layout
from vdf_tpu_torch.native import msm_native_affine

# The plain versions are many small tensor ops: one intra-op thread runs
# them fastest, and test workers sharing the cores do not oversubscribe
# them (with a thread pool per worker they ran ~10x slower under load).
torch.set_num_threads(1)

CURVES = ["pallas", "vesta"]


def random_scalars(curve_name: str, n: int, seed: int) -> list[int]:
    q = get_curve(curve_name).scalar.params.modulus
    raw = np.random.default_rng(seed).bytes(32 * n)
    return [int.from_bytes(raw[32 * k : 32 * k + 32], "little") % q for k in range(n)]


def jacobian_to_affine(curve_name: str, jac):
    if jac is None:
        return None
    mod = get_curve(curve_name).field.params.modulus
    x, y, z = jac
    zi = pow(z, -1, mod)
    return x * zi * zi % mod, y * zi * zi % mod * zi % mod


def affine_of(curve_name: str, pt: Point):
    return get_curve(curve_name).to_affine_ints(Point(*(v[None] for v in pt)))[0]


def int_msm(curve_name: str, points, scalars):
    """sum_i s_i P_i by IntCurve over projective int triples, in affine."""
    ic = get_int_curve(curve_name)
    acc = (0, 1, 0)
    for p, s in zip(points, scalars):
        acc = ic.add(acc, ic.scalar_mul(p, s))
    return ic.to_affine(acc)


@pytest.mark.parametrize("n", [1, 23, 64, 300])
@pytest.mark.parametrize("curve_name", CURVES)
def test_msm_matches_native_and_intcurve(curve_name, n):
    """n = 1 and 23 are one column and two (the second all padding but one
    item), 64 is three ragged columns, 300 has runs that cross columns."""
    c, ic = get_curve(curve_name), get_int_curve(curve_name)
    pts = hash_to_curve_ints(curve_name, n, domain=b"vdf_tpu/t")
    q = c.scalar.params.modulus
    vals = random_scalars(curve_name, n, seed=n)
    vals[: min(n, 3)] = [q - 1, 0, 1][: min(n, 3)]
    got = affine_of(curve_name, msm(c, c.from_affine_ints(pts, device="cpu"),
                                    c.scalar.encode(vals, device="cpu")))
    assert got == msm_native_affine(curve_name, pts, vals)
    assert got == jacobian_to_affine(curve_name, jax_msm_native(curve_name, pts, vals))
    if n <= 64:
        assert got == int_msm(curve_name, [ic.from_affine(p) for p in pts], vals)


@pytest.mark.parametrize("curve_name", CURVES)
def test_msm_edge_vector(curve_name):
    """P and -P with equal scalars cancel, the identity as an input point,
    a repeated point, zero scalars, and a point in projective form (z != 1)."""
    c, ic = get_curve(curve_name), get_int_curve(curve_name)
    f = c.field
    a, b, d = (ic.from_affine(p) for p in hash_to_curve_ints(curve_name, 3, domain=b"vdf_tpu/t"))
    pts = [a, ic.neg(a), (0, 1, 0), b, b, d, ic.double(d), (0, 1, 0)]
    q = c.scalar.params.modulus
    r = random_scalars(curve_name, 4, seed=77)
    vals = [r[0], r[0], r[1], r[2], q - r[2] + 5, 0, r[3], 0]
    points = Point(*(f.encode([p[k] for p in pts], device="cpu") for k in range(3)))
    got = affine_of(curve_name, msm(c, points, c.scalar.encode(vals, device="cpu")))
    assert got == int_msm(curve_name, pts, vals)
    assert got == ic.to_affine(ic.add(ic.scalar_mul(b, 5), ic.scalar_mul(d, 2 * r[3])))
    with pytest.raises(ValueError):
        msm(c, points, c.scalar.encode(vals[:3], device="cpu"))


def test_msm_cancelling_and_zero_scalars_give_identity():
    curve_name = "vesta"  # the edge vector above runs on both curves
    c = get_curve(curve_name)
    pts = hash_to_curve_ints(curve_name, 2, domain=b"vdf_tpu/t")
    x, y = pts[0]
    mod, q = c.field.params.modulus, c.scalar.params.modulus
    points = c.from_affine_ints([pts[0], (x, -y % mod), pts[1]], device="cpu")
    vals = [q - 1, q - 1, 0]
    assert affine_of(curve_name, msm(c, points, c.scalar.encode(vals, device="cpu"))) is None


@pytest.mark.parametrize("curve_name", CURVES)
def test_msm_matches_jax_msm(curve_name):
    """The slice as a whole against the JAX package: the same seed-made
    points and scalars through ``vdf_tpu.curves.msm.msm`` (n = 5, the shape
    tests/test_curves.py compiles) and, carried across with interop, through
    the port's ``msm``; equal in affine."""
    n = 5
    c, jc = get_curve(curve_name), jax_get_curve(curve_name)
    pts = hash_to_curve_ints(curve_name, n, domain=b"vdf_tpu/t")
    vals = random_scalars(curve_name, n, seed=61)
    jpts, js = jc.from_affine_ints(pts), jc.scalar.encode(vals)
    want = jc.to_affine_ints(jax_msm(jc, jpts, js))[0]
    points = interop.point_from_jax(curve_name, tuple(np.asarray(a) for a in jpts), device="cpu")
    scalars = interop.from_jax(c.params.scalar_field, np.asarray(js), device="cpu")
    got = affine_of(curve_name, msm(c, points, scalars))
    assert got == want and got is not None


@pytest.mark.parametrize("key_bits", [32, 64])
@pytest.mark.parametrize("curve_name", CURVES)
def test_window_row_keys(curve_name, key_bits):
    """K3's second layout: row w holds the key of (digit_w(s_i), i) for
    i < n and the padding key (digit 0, item 0) beyond, for any 256-bit limb
    pattern, in either width (int64 digit << 32 | i; int32
    ((digit << 20) | i) ^ 2^31)."""
    c, n = get_curve(curve_name), 23
    q = c.scalar.params.modulus
    vals = random_scalars(curve_name, n, seed=41)
    vals[:2] = [0, q - 1]
    s = c.scalar.encode(vals, device="cpu")
    s[2] = -1
    vals[2] = ((1 << 256) - 1) * pow(c.scalar.params.r, -1, q) % q
    cols, m_pad = msm_layout(n)
    assert (cols, m_pad) == (2, 44) and msm_layout(1) == (1, 22) and msm_layout(22) == (1, 22)
    keys = CK.canon_digits(c.params.scalar_field, s[None], m_pad, window_rows=True,
                           key_bits=key_bits)
    assert keys.shape == (1, CK.WINDOWS, m_pad)
    assert keys.dtype == (torch.int32 if key_bits == 32 else torch.int64)

    def key(digit, item):
        return (digit << 32) | item if key_bits == 64 else ((digit << 20) | item) - (1 << 31)

    for w in range(CK.WINDOWS):
        row = keys[0, w].tolist()
        assert row[:n] == [key((v >> (12 * w)) & 0xFFF, i) for i, v in enumerate(vals)]
        assert row[n:] == [key(0, 0)] * (m_pad - n)


@pytest.mark.parametrize("curve_name", CURVES)
def test_horner_matches_intcurve(curve_name):
    """K9's plain version: sum_w 2^(12 w) S_w over B = 2 rows of window
    sums (multiples of a base point in projective form, the identity among
    them), as IntCurve sums it; and the triple it returns is the one the
    chain of 12 doublings and an add a window gives, limb for limb."""
    c, ic = get_curve(curve_name), get_int_curve(curve_name)
    f = c.field
    g = ic.from_affine(hash_to_curve_ints(curve_name, 1, domain=b"vdf_tpu/t")[0])
    ks = [int(v) for v in np.random.default_rng(5).integers(0, 1 << 40, size=2 * CK.WINDOWS)]
    ks[3], ks[CK.WINDOWS + 21] = 0, 0  # identity window sums, the top window among them
    rows = [[ic.scalar_mul(g, k) for k in ks[b * CK.WINDOWS : (b + 1) * CK.WINDOWS]]
            for b in range(2)]
    flat = [p for row in rows for p in row]
    sums = torch.stack([f.encode([p[k] for p in flat], device="cpu") for k in range(3)], dim=1)
    out = CK.horner(c.params.base_field, sums.reshape(2, CK.WINDOWS, 3, 8).contiguous())
    assert out.shape == (2, 3, 8)
    got = list(zip(*(f.decode(out[:, k]) for k in range(3))))
    for b, row in enumerate(rows):
        acc = (0, 1, 0)
        for w in range(CK.WINDOWS - 1, -1, -1):
            for _ in range(CK.WINDOW_BITS):
                acc = ic.double(acc)
            acc = ic.add(acc, row[w])
        assert got[b] == acc
        total = sum(k << (12 * w) for w, k in enumerate(ks[b * CK.WINDOWS : (b + 1) * CK.WINDOWS]))
        assert ic.to_affine(acc) == ic.to_affine(ic.scalar_mul(g, total))


@pytest.mark.parametrize("curve_name", CURVES)
def test_msm_same_limbs_in_both_key_widths(curve_name):
    """msm at n = 50 (32-bit keys) == the same stages with the keys forced
    to int64, in projective limbs."""
    c = get_curve(curve_name)
    bf, sf = c.params.base_field, c.params.scalar_field
    n = 50
    pts = c.from_affine_ints(hash_to_curve_ints(curve_name, n, domain=b"vdf_tpu/t"), device="cpu")
    s = c.scalar.encode(random_scalars(curve_name, n, seed=53), device="cpu")
    got = msm(c, pts, s)
    _, m_pad = msm_layout(n)
    keys = CK.canon_digits(sf, s[None], m_pad, window_rows=True, key_bits=64)[0]
    scan = CK.bucket_scan(bf, stack_point(pts).contiguous(), torch.sort(keys, -1).values, ROWS)
    sums = CK.bucket_sums(bf, scan[0], scan[1], CK.column_carries(bf, scan[2], scan[3]))
    want = CK.horner(bf, sums[None])[0]
    assert torch.equal(stack_point(got), want)
