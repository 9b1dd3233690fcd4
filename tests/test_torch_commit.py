"""The port's fixed-base Pedersen commit (curves/bucket_msm.py,
nova/pedersen.py) on the CPU, against the native C++ Pippenger, IntCurve
and the JAX package.

On CPU tensors every kernel wrapper (curves/kernels.py) runs its plain
version, so these tests hold the commit's algorithm: K3 window digits,
the key sort, K4 run sums, K5 column carries, K6 bucket sums and the K7
pre-shifted table.  The kernels themselves are held against the plain
versions by tests/test_torch_msm_kernel_host.py (bodies compiled as host
code) and, on the card, by the ``gpu`` tests and chip_smoke.py.  Scalars
are made with numpy from fixed seeds; commitments from different
algorithms are compared in affine, exactly.
"""

import numpy as np
import pytest
import torch

from vdf_tpu.curves import get_curve as jax_get_curve
from vdf_tpu.curves.point import Point as JaxPoint
from vdf_tpu.native import msm_native as jax_msm_native
from vdf_tpu.nova.pedersen import commitment_key as jax_commitment_key
from vdf_tpu_torch import interop
from vdf_tpu_torch.curves import (
    Point,
    commit_fixed,
    commit_fixed_batch,
    digits_of_scalars,
    get_curve,
    get_int_curve,
    stack_point,
)
from vdf_tpu_torch.curves import kernels as CK
from vdf_tpu_torch.curves.bucket_msm import layout
from vdf_tpu_torch.native import msm_native_affine
from vdf_tpu_torch.nova import commitment_key, derive_generators

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
    """The JAX package's msm_native output (Jacobian, or None) in affine."""
    if jac is None:
        return None
    mod = get_curve(curve_name).field.params.modulus
    x, y, z = jac
    zi = pow(z, -1, mod)
    return x * zi * zi % mod, y * zi * zi % mod * zi % mod


def generators(curve_name: str, n: int) -> list[tuple[int, int]]:
    return list(derive_generators(curve_name, n)[:n])


def commit_rows(curve_name: str, n: int, rows: list[list[int]]):
    """The rows committed as one batch, in affine, each checked against
    both native Pippengers."""
    c = get_curve(curve_name)
    s = c.scalar.encode([v for r in rows for v in r], device="cpu").reshape(len(rows), n, 8)
    got = c.to_affine_ints(commitment_key(curve_name, n, device="cpu").commit_batch(s))
    gens = generators(curve_name, n)
    for row, g in zip(rows, got):
        assert g == msm_native_affine(curve_name, gens, row)
        assert g == jacobian_to_affine(curve_name, jax_msm_native(curve_name, gens, row))
    return got


@pytest.mark.parametrize("n", [8, 100, 256])
@pytest.mark.parametrize("curve_name", CURVES)
def test_commit_matches_native(curve_name, n):
    """A K = 2 batch: random scalars with 0, 1 and q - 1 among them, and
    all-equal scalars (runs of equal digits that cross columns, so K5's
    carries matter)."""
    q = get_curve(curve_name).scalar.params.modulus
    rnd = random_scalars(curve_name, n, seed=n)
    rnd[1:4] = [0, 1, q - 1]
    commit_rows(curve_name, n, [rnd, [rnd[0]] * n])


@pytest.mark.parametrize("curve_name", CURVES)
def test_commit_special_vectors(curve_name):
    """Zero gives the identity, e_0 gives G_0, (q - 1) e_{n-1} gives
    -G_{n-1}; all ones and all q - 1 match the native Pippengers."""
    c, n = get_curve(curve_name), 8
    q, mod = c.scalar.params.modulus, c.field.params.modulus
    rows = [[0] * n, [1] + [0] * (n - 1), [0] * (n - 1) + [q - 1], [1] * n, [q - 1] * n]
    got = commit_rows(curve_name, n, rows)
    gens = generators(curve_name, n)
    assert got[0] is None
    assert got[1] == gens[0]
    assert got[2] == (gens[-1][0], -gens[-1][1] % mod)


@pytest.mark.parametrize("curve_name", CURVES)
def test_batch_rows_equal_single_commits(curve_name):
    """The K = 2 batch (the fused fold's witness + cross term) equals two
    single commits limb for limb: row 0 through commit_fixed, which also
    returns the canonical limbs, and row 1, whose last three scalars are
    zero, through CommitmentKey.commit of the unpadded five."""
    c, n = get_curve(curve_name), 8
    s = c.scalar.encode(random_scalars(curve_name, 2 * n, seed=21), device="cpu").reshape(2, n, 8)
    s[1, 5:] = 0
    batch = stack_point(commit_fixed_batch(curve_name, s))
    pt, canon = commit_fixed(curve_name, s[0])
    assert torch.equal(stack_point(pt), batch[0])
    assert torch.equal(canon, c.field.from_mont(batch[0]))
    canon_ints = [int.from_bytes(r.numpy().astype("<u4").tobytes(), "little") for r in canon]
    assert canon_ints == c.field.decode(batch[0])
    ck = commitment_key(curve_name, n, device="cpu")
    assert torch.equal(stack_point(ck.commit(s[1, :5])), batch[1])
    with pytest.raises(ValueError):
        ck.commit(torch.zeros(n + 1, 8, dtype=torch.int32))


@pytest.mark.parametrize("curve_name", CURVES)
def test_commit_with_blind_matches_intcurve(curve_name):
    c, ic, n = get_curve(curve_name), get_int_curve(curve_name), 8
    ck = commitment_key(curve_name, n, device="cpu")
    vals = random_scalars(curve_name, n + 1, seed=31)
    got = ck.commit(c.scalar.encode(vals[:n], device="cpu"), blind=c.scalar.encode(vals[n], device="cpu"))
    pts = derive_generators(curve_name, n)  # n generators, then h
    want = ic.scalar_mul(ic.from_affine(pts[n]), vals[n])
    for g, v in zip(pts[:n], vals):
        want = ic.add(want, ic.scalar_mul(ic.from_affine(g), v))
    assert c.to_affine_ints(Point(*(v[None] for v in got))) == [ic.to_affine(want)]


@pytest.mark.parametrize("curve_name", CURVES)
def test_shifted_table_matches_intcurve_doubling_chain(curve_name):
    """K7's plain version: item w n + i = 2^(12 w) G_i, the same
    projective triple as 12 w IntCurve doublings."""
    c, ic, n = get_curve(curve_name), get_int_curve(curve_name), 8
    table = commitment_key(curve_name, n, device="cpu").table
    assert table.shape == (CK.WINDOWS * n, 3, 8)
    got = list(zip(*(c.field.decode(table[:, k]) for k in range(3))))
    for i, g in enumerate(generators(curve_name, n)):
        p = ic.from_affine(g)
        for w in range(CK.WINDOWS):
            assert got[w * n + i] == p
            for _ in range(CK.WINDOW_BITS):
                p = ic.double(p)


@pytest.mark.parametrize("curve_name", CURVES)
def test_window_digits_match_ints(curve_name):
    """K3 mode 0's plain version: digit w is bits [12 w, 12 w + 12) of the
    canonical scalar; keys are digit << 32 | item, window-major, zero past
    W n; any 256-bit limb pattern counts as its value mod q."""
    c, n = get_curve(curve_name), 6
    q = c.scalar.params.modulus
    vals = random_scalars(curve_name, n, seed=41)
    vals[:2] = [0, q - 1]
    s = c.scalar.encode(vals, device="cpu")
    s[2] = -1  # limbs 2^256 - 1: the scalar (2^256 - 1) / R mod q
    vals[2] = ((1 << 256) - 1) * pow(c.scalar.params.r, -1, q) % q
    want = [[(v >> (12 * w)) & 0xFFF for w in range(CK.WINDOWS)] for v in vals]
    assert digits_of_scalars(curve_name, s).tolist() == want
    _, m_pad = layout(n)
    keys = CK.canon_digits(c.params.scalar_field, s[None], m_pad)[0].tolist()
    assert keys[: CK.WINDOWS * n] == [(want[i][w] << 32) | (w * n + i)
                                      for w in range(CK.WINDOWS) for i in range(n)]
    assert keys[CK.WINDOWS * n :] == [0] * (m_pad - CK.WINDOWS * n)


@pytest.mark.parametrize("curve_name", CURVES)
def test_commit_matches_jax_commitment_key(curve_name):
    """The slice as a whole: the JAX package's key carried across with
    interop, and the port's commit equal to ``CommitmentKey.commit`` of
    the JAX package on the same scalars, in affine (n = 5, the shape
    tests/test_curves.py compiles)."""
    n = 5
    jck = jax_commitment_key(curve_name, n)
    ck = interop.commitment_key_from_jax(jck, device="cpu")
    c, jc = get_curve(curve_name), jax_get_curve(curve_name)
    vals = random_scalars(curve_name, n, seed=51)
    want = jc.to_affine_ints(JaxPoint(*(v[None] for v in jck.commit(jc.scalar.encode(vals)))))
    got = c.to_affine_ints(Point(*(v[None] for v in ck.commit(c.scalar.encode(vals, device="cpu")))))
    assert got == want
    assert got[0] is not None
