"""The port's Spartan+IPA (vdf_tpu_torch.spartan) on the CPU.

  * The multilinear tables and the sumcheck of the device tier (tensors
    with device="cpu") against the JAX package's and against the host-int
    twins: the same values, messages and challenges.
  * The host-int tier on tests/test_spartan.py::TestHostTier's tiny relaxed
    R1CS: field by field the JAX package's ``host_spartan_prove``; it
    verifies and rejects tampering.
  * The device tier on that instance: its proof is the host tier's, the
    device verifier accepts it and rejects a changed vA, X, sumcheck
    message, L point and a_final.
  * The inner-product argument's prover, which commits against the
    original generators with per-round weights where the JAX package folds
    them: at n = 16 on Python ints and ``IntCurve`` its L and R are the
    generator-fold L and R round by round, and on tensors its proof is
    ``ipa_prove_ints``'s.

The device verifier's opening checks are one ``msm`` each (~27 s on one CPU
core: the plain K6 over 22 window rows), so it runs three times in all.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from vdf_tpu.fields import get_field as jax_get_field
from vdf_tpu.nova.ivc import HostRelaxedInstance as JaxHostRelaxedInstance
from vdf_tpu.nova.ivc import Side as JaxSide
from vdf_tpu.poseidon.int_poseidon import IntTranscript as JaxIntTranscript
from vdf_tpu.r1cs.cs import R1CSShape as JaxR1CSShape
from vdf_tpu.spartan import host as jax_host
from vdf_tpu.spartan import multilinear as jax_ml
from vdf_tpu_torch.curves import get_int_curve
from vdf_tpu_torch.fields import get_field
from vdf_tpu_torch.nova.ivc import HostRelaxedInstance, Side
from vdf_tpu_torch.nova.nifs import RelaxedWitness
from vdf_tpu_torch.nova.pedersen import commitment_key
from vdf_tpu_torch.poseidon.int_poseidon import IntTranscript
from vdf_tpu_torch.r1cs.cs import R1CSShape
from vdf_tpu_torch.spartan import (
    eq_table,
    eval_univariate,
    evaluate,
    fold_top,
    ipa_prove,
    pad_to_pow2,
    spartan_prove,
    spartan_verify,
    sumcheck_prove,
    sumcheck_verify,
)
from vdf_tpu_torch.spartan import host
from vdf_tpu_torch.spartan.snark import (
    SpartanCtx,
    _eval_gamma_matrix,
    _gamma_matrix_vector,
)
from vdf_tpu_torch.utils.profiling import PhaseTimer

torch.set_num_threads(1)  # many small tensor ops; see tests/test_torch_commit.py

SEED = 20240917
CPU = "cpu"


@pytest.fixture
def f():
    return get_field("Fq")


def _ints(rng, k: int, modulus: int) -> list[int]:
    """k uniform residues from numpy's generator (four 64-bit words each)."""
    words = rng.integers(0, 1 << 63, size=(k, 4), dtype=np.int64).tolist()
    return [sum(w << (63 * j) for j, w in enumerate(row)) % modulus for row in words]


# -- multilinear tables, against the JAX package


@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_multilinear_equals_jax_packages(f, n):
    jf = jax_get_field("Fq")
    p = f.params.modulus
    rng = np.random.default_rng(SEED + n)
    m = (n - 1).bit_length()
    rs, vals = _ints(rng, m, p), _ints(rng, n, p)
    rs_t, vals_t = f.encode(rs, CPU), f.encode(vals, CPU)
    rs_j = [jf.encode(r) for r in rs]

    got = f.decode(eq_table(f, rs_t))
    assert got == jf.decode(jax_ml.eq_table(jf, rs_j))
    assert got == host.eq_table_ints(p, rs)
    assert f.decode(evaluate(f, vals_t, rs_t)) == jf.decode(
        jax_ml.evaluate(jf, jf.encode(vals), rs_j)[None])[0]
    if n > 1:
        assert f.decode(fold_top(f, vals_t, rs_t[0])) == jf.decode(
            jax_ml.fold_top(jf, jf.encode(vals), rs_j[0]))
    short = vals_t[: max(1, n - 1)]
    assert f.decode(pad_to_pow2(f, short)) == jf.decode(
        jax_ml.pad_to_pow2(jf, jf.encode(f.decode(short))))


# -- sumcheck, against the host twins of both packages


def test_eval_univariate_batched(f):
    p = f.params.modulus
    rng = np.random.default_rng(SEED)
    for degree in (2, 3):
        evals = [_ints(rng, 5, p) for _ in range(degree + 1)]
        rs = _ints(rng, 5, p)
        got = f.decode(eval_univariate(f, [f.encode(e, CPU) for e in evals], f.encode(rs, CPU)))
        assert got == [host.eval_univariate_ints(p, [e[k] for e in evals], rs[k])
                       for k in range(5)]


@pytest.mark.parametrize("comb_key", ["product", "spartan_outer"])
def test_sumcheck_equals_host_twins(f, comb_key):
    p = f.params.modulus
    rng = np.random.default_rng(SEED + len(comb_key))
    n, k = 8, (2 if comb_key == "product" else 5)
    polys = [_ints(rng, n, p) for _ in range(k)]
    u = _ints(rng, 1, p)[0]
    if comb_key == "product":
        degree, aux, comb = 2, (), lambda m_, z_: m_ * z_
    else:
        degree, aux = 3, (f.encode(u, CPU),)
        comb = lambda e, a, b, c, ev: e * (a * b - u * c - ev)  # noqa: E731
    claim = sum(comb(*vals) for vals in zip(*polys)) % p

    def tr(cls):
        t = cls("Fq")
        t.absorb(7)
        return t

    rs, finals, msgs = sumcheck_prove(f, tr(IntTranscript), [f.encode(v, CPU) for v in polys],
                                      degree, comb_key, aux=aux)
    msgs_int = [[f.decode(e) for e in m] for m in msgs]
    for twin in (host.sumcheck_prove_ints, jax_host.sumcheck_prove_ints):
        t = tr(JaxIntTranscript if twin is jax_host.sumcheck_prove_ints else IntTranscript)
        want_rs, want_finals, want_msgs = twin(p, t, polys, degree, comb)
        assert rs == want_rs and msgs_int == want_msgs
        assert f.decode(finals) == want_finals

    rs_v, final, ok = sumcheck_verify(f, tr(IntTranscript), msgs, f.encode(claim, CPU), degree)
    assert bool(ok) and rs_v == rs
    assert f.decode(final) == comb(*f.decode(finals)) % p
    _, _, ok = sumcheck_verify(f, tr(IntTranscript), msgs, f.encode(claim + 1, CPU), degree)
    assert not bool(ok)
    _, _, ok = sumcheck_verify(f, tr(IntTranscript), [m[:-1] for m in msgs],
                               f.encode(claim, CPU), degree)
    assert not bool(ok)


# -- Spartan on the tiny relaxed R1CS of tests/test_spartan.py::TestHostTier

A_COO = (np.array([0, 1, 1, 2]), np.array([0, 1, 2, 5]), [1, 1, 2, 1])
B_COO = (np.array([0, 1, 2]), np.array([1, 4, 3]), [1, 1, 3])
C_COO = (np.array([0, 1, 2]), np.array([6, 0, 2]), [1, 5, 1])


@pytest.fixture(scope="module")
def tiny():
    """3 constraints over 4 aux + u + 2 inputs (z = W | u | X), a device
    side on the CPU; E := Az o Bz - u Cz satisfies the relaxed relation."""
    f = get_field("Fq")
    p = f.params.modulus
    shape = R1CSShape(3, 4, 2, p, A_COO, B_COO, C_COO)
    side = Side(None, shape, f, "pallas", "Fp", "device", torch.device(CPU))
    rng = random.Random(17)
    W = [rng.randrange(p) for _ in range(4)]
    X = [rng.randrange(p) for _ in range(2)]
    u = rng.randrange(1 << 128)
    az, bz, cz = side.host_plane._matvecs(W + [u % p] + X)
    E = [(a * b - u * c) % p for a, b, c in zip(az, bz, cz)]
    gens, _ = host.host_ck("pallas", side._commit_pad)
    U = HostRelaxedInstance(host._msm_aff("pallas", list(gens[:4]), W, p),
                            host._msm_aff("pallas", list(gens[:3]), E, p), X, u)
    hp = host.host_spartan_prove(side, U, W, E, IntTranscript("Fq"))
    ctx = SpartanCtx(f, "pallas", side.dev_shape, side.ck)
    dp = spartan_prove(ctx, U, RelaxedWitness(f.encode(W, CPU), f.encode(E, CPU)),
                       IntTranscript("Fq"))
    return side, ctx, U, W, E, hp, dp


def test_host_tier_equals_jax_packages(tiny):
    side, _, U, W, E, hp, _ = tiny
    p = side.field.params.modulus
    jside = JaxSide(None, JaxR1CSShape(3, 4, 2, p, A_COO, B_COO, C_COO),
                    jax_get_field("Fq"), "pallas", "Fp", "native")
    jU = JaxHostRelaxedInstance(U.comm_w, U.comm_e, list(U.X), U.u)
    want = jax_host.host_spartan_prove(jside, jU, W, E, JaxIntTranscript("Fq"))
    for name, got, ref in zip(hp._fields, hp, want):
        assert tuple(got) == tuple(ref) if isinstance(ref, tuple) else got == ref, name


def test_host_tier_verifies_and_rejects(tiny):
    side, _, U, _, _, hp, _ = tiny
    p = side.field.params.modulus
    assert host.host_spartan_verify(side, U, hp, IntTranscript("Fq"))
    assert not host.host_spartan_verify(side, U, hp._replace(vA=(hp.vA + 1) % p),
                                        IntTranscript("Fq"))
    U_bad = HostRelaxedInstance(U.comm_w, U.comm_e, [(U.X[0] + 1) % p, U.X[1]], U.u)
    assert not host.host_spartan_verify(side, U_bad, hp, IntTranscript("Fq"))


def test_gamma_matrix_equals_host_twin(tiny):
    side, ctx, *_ = tiny
    f, p = side.field, side.field.params.modulus
    rng = np.random.default_rng(SEED)
    eq_rx, eq_ry = _ints(rng, 4, p), _ints(rng, 8, p)
    gamma = _ints(rng, 1, p)[0]
    got = _gamma_matrix_vector(f, ctx.dev_shape, f.encode(eq_rx, CPU), gamma, 8)
    assert f.decode(got) == host._gamma_mvec_ints(p, side.host_plane.coo, eq_rx, gamma, 8)
    got = _eval_gamma_matrix(f, ctx.dev_shape, f.encode(eq_rx, CPU), f.encode(eq_ry, CPU), gamma)
    assert f.decode(got) == host._gamma_eval_ints(p, side.host_plane.coo, eq_rx, eq_ry, gamma)


def test_device_tier_proof_is_the_host_tiers(tiny):
    _, ctx, _, _, _, hp, dp = tiny
    assert host.spartan_from_device(ctx, dp) == hp
    assert host.spartan_from_device(ctx, host.spartan_to_device(ctx, hp)) == hp


def test_device_tier_verifies(tiny):
    _, ctx, U, _, _, hp, _ = tiny
    assert spartan_verify(ctx, U, host.spartan_to_device(ctx, hp), IntTranscript("Fq"))


def _bump(f, v):
    return f.add(v, f.one(CPU))


@pytest.mark.parametrize("tamper", ["vA + 1", "changed X", "changed sumcheck message",
                                    "swapped L point", "a_final + 1"])
def test_device_tier_rejects(tiny, tamper):
    _, ctx, U, _, _, _, dp = tiny
    f = ctx.field
    if tamper == "vA + 1":
        dp = dp._replace(vA=_bump(f, dp.vA))
    elif tamper == "changed X":
        U = HostRelaxedInstance(U.comm_w, U.comm_e, [U.X[0] + 1, U.X[1]], U.u)
    elif tamper == "changed sumcheck message":
        first = dp.sc1_messages[0]
        dp = dp._replace(sc1_messages=((_bump(f, first[0]), *first[1:]), *dp.sc1_messages[1:]))
    elif tamper == "swapped L point":
        e = dp.ipa_e
        dp = dp._replace(ipa_e=e._replace(ls=(e.rs[0], *e.ls[1:]), rs=(e.ls[0], *e.rs[1:])))
    else:
        dp = dp._replace(ipa_e=dp.ipa_e._replace(a_final=_bump(f, dp.ipa_e.a_final)))
    assert not spartan_verify(ctx, U, dp, IntTranscript("Fq"))


# -- the inner-product argument without generator folds

IPA_N = 16


def test_commit_based_rounds_equal_generator_folds():
    """G(j)_i = sum over k = i mod n_j of w_k G_k: the weighted commits give
    the generator-fold L and R in every round (IntCurve, Python ints)."""
    ic = get_int_curve("pallas")
    q = ic.order
    gens, h = host.host_ck("pallas", IPA_N)
    G = [ic.from_affine(g) for g in gens]
    H = ic.from_affine(h)
    rng = np.random.default_rng(SEED)
    a, b, xs = _ints(rng, IPA_N, q), _ints(rng, IPA_N, q), _ints(rng, 4, q)

    def lin(scalars, points):
        acc = (0, 1, 0)
        for s, pt in zip(scalars, points):
            acc = ic.add(acc, ic.scalar_mul(pt, s % q))
        return acc

    g, w = list(G), [1] * IPA_N
    nj = IPA_N
    for x in xs:
        half = nj // 2
        c_l = sum(u * v for u, v in zip(a[:half], b[half:])) % q
        c_r = sum(u * v for u, v in zip(a[half:], b[:half])) % q
        fold_l = lin(a[:half] + [c_l], g[half:] + [H])
        fold_r = lin(a[half:] + [c_r], g[:half] + [H])
        sig_l = [a[k % nj - half] * w[k] if k % nj >= half else 0 for k in range(IPA_N)]
        sig_r = [a[half + k % nj] * w[k] if k % nj < half else 0 for k in range(IPA_N)]
        assert ic.eq(lin(sig_l + [c_l], G + [H]), fold_l)
        assert ic.eq(lin(sig_r + [c_r], G + [H]), fold_r)
        xi = pow(x, -1, q)
        a = [(u * x + v * xi) % q for u, v in zip(a[:half], a[half:])]
        b = [(u * xi + v * x) % q for u, v in zip(b[:half], b[half:])]
        g = [ic.add(ic.scalar_mul(u, xi), ic.scalar_mul(v, x)) for u, v in zip(g[:half], g[half:])]
        w = [wk * (x if k % nj >= half else xi) % q for k, wk in enumerate(w)]
        nj = half


def test_ipa_prove_equals_host_tier(f):
    q = f.params.modulus
    rng = np.random.default_rng(SEED + 1)
    a, b = _ints(rng, IPA_N, q), _ints(rng, IPA_N, q)
    ck = commitment_key("pallas", IPA_N, device=CPU)
    timer = PhaseTimer()
    got = ipa_prove(f, ck, f.encode(a, CPU), f.encode(b, CPU), IntTranscript("Fq"), timer)
    # four spans a round, none ending as the benchmark's compress readers' do
    rounds = IPA_N.bit_length() - 1
    assert dict(timer.counts) == {f"pallas/ipa.{part}": rounds
                                  for part in ("commit", "read", "transcript", "fold")}
    assert not any(n.endswith(("/two IPAs", "/outer sumcheck", "/inner sumcheck",
                               "/gamma-matvec")) for n in timer.counts)
    gens, h = host.host_ck("pallas", IPA_N)
    want = host.ipa_prove_ints("pallas", q, gens, h, a, b, IntTranscript("Fq"))
    c = ck.curve
    assert [c.to_affine_ints(type(p_)(*(v[None] for v in p_)))[0] for p_ in got.ls] == list(want.ls)
    assert [c.to_affine_ints(type(p_)(*(v[None] for v in p_)))[0] for p_ in got.rs] == list(want.rs)
    assert f.decode(got.a_final) == want.a_final
