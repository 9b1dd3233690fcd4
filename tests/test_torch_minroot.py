"""Port MinRoot (vdf_tpu_torch.minroot) against the JAX package and ints.

On the CPU the port's main path runs the plain versions of the kernels
(fields/kernels.py); the JAX reference runs its plain XLA path
(``vdf.eval`` / ``vdf.inverse_eval``), since the Pallas kernels cannot
run at a useful size in interpret mode here.  The same TEST_SEED inputs
go to both packages through ``interop``; tolerance is exact equality.
Mirrors tests/test_minroot.py (eval t=10, append n=3 x t=4, a tampered
result, a wrong original).
"""

import numpy as np
import pytest
import torch

from vdf_tpu.minroot import Evaluation as JaxEvaluation
from vdf_tpu.minroot import pallas_vdf as jax_pallas_vdf
from vdf_tpu.minroot import vesta_vdf as jax_vesta_vdf
from vdf_tpu_torch import interop
from vdf_tpu_torch.fields import FP, FQ
from vdf_tpu_torch.fields.kernels import (
    LAUNCHES,
    minroot_eval_plain,
    minroot_inverse_plain,
)
from vdf_tpu_torch.minroot import (
    EvalMode,
    Evaluation,
    State,
    eval_fused,
    inverse_eval_fused,
    pallas_vdf,
    vesta_vdf,
)
from vdf_tpu_torch.utils import TEST_SEED, XorShiftRng, field_random

# The plain versions are many small tensor ops: one intra-op thread runs
# them fastest, and test workers sharing the cores do not oversubscribe
# them (with a thread pool per worker they ran ~10x slower under load).
torch.set_num_threads(1)

VDFS = [
    ("pallas", pallas_vdf, jax_pallas_vdf, FQ),
    ("vesta", vesta_vdf, jax_vesta_vdf, FP),
]


def oracle_eval(p, inv_alpha, s, t):
    x, y, i = s
    for _ in range(t):
        x, y, i = pow((x + y) % p, inv_alpha, p), (x + i) % p, (i + 1) % p
    return x, y, i


@pytest.fixture(params=VDFS, ids=[v[0] for v in VDFS])
def vdfs(request):
    _, mk, jax_mk, P = request.param
    return mk(), jax_mk(), P


def seeded_lanes(P, lanes: int, seed: int):
    """Lanes of (x, y, i): x, y from the reference xorshift stream, i from
    numpy, so the counter starts anywhere in the field."""
    rng = XorShiftRng(TEST_SEED)
    nrng = np.random.default_rng(seed)
    xs = [field_random(rng, P.modulus) for _ in range(lanes)]
    ys = [field_random(rng, P.modulus) for _ in range(lanes)]
    is_ = [int(v) for v in nrng.integers(0, 1 << 62, size=lanes)]
    return xs, ys, is_


def test_plain_kernels_match_jax_eval(vdfs):
    """minroot_eval_plain / minroot_inverse_plain vs the JAX vdf.eval /
    vdf.inverse_eval, 16 lanes, t=3, states crossing through interop."""
    vdf, jvdf, P = vdfs
    name = P.name
    xs, ys, is_ = seeded_lanes(P, 16, seed=5)
    js = jvdf.state_from_ints(xs, ys, is_)
    s = interop.state_from_jax(name, *(np.asarray(a) for a in js), device="cpu")
    t = 3
    got = minroot_eval_plain(name, *s, t)
    jr = jvdf.eval(js, t)
    assert [vdf.field.decode(a) for a in got] == [jvdf.field.decode(a) for a in jr]
    lane0 = oracle_eval(P.modulus, P.inv_alpha, (xs[0], ys[0], is_[0] % P.modulus), t)
    assert tuple(vdf.field.decode(a)[0] for a in got) == lane0

    back = minroot_inverse_plain(name, *got, t)
    jback = jvdf.inverse_eval(jr, t)
    assert [vdf.field.decode(a) for a in back] == [jvdf.field.decode(a) for a in jback]
    assert all(torch.equal(a, b) for a, b in zip(back, s))
    assert LAUNCHES == {"minroot_eval": 0, "minroot_inverse": 0}


def test_round_and_inverse_round_match_plain_kernels(vdfs):
    vdf, _, P = vdfs
    xs, ys, is_ = seeded_lanes(P, 4, seed=6)
    s = vdf.state_from_ints(xs, ys, is_, device="cpu")
    one = vdf.round(s)
    assert all(torch.equal(a, b) for a, b in zip(one, minroot_eval_plain(P.name, *s, 1)))
    assert all(torch.equal(a, b) for a, b in zip(vdf.inverse_round(one), s))
    x = vdf.field.encode(xs, device="cpu")
    assert torch.equal(vdf.inverse_step(vdf.forward_step(x)), x)


def test_eval_roundtrip_matches_jax_t10():
    """Mirrors test_eval (src/minroot.rs:479-510): t=10 on TEST_SEED
    inputs, three states as three lanes; eval, inverse_eval and check."""
    vdf, jvdf, P = pallas_vdf(), jax_pallas_vdf(), FQ
    rng = XorShiftRng(TEST_SEED)
    pairs = [(field_random(rng, P.modulus), field_random(rng, P.modulus)) for _ in range(3)]
    xs, ys = [x for x, _ in pairs], [y for _, y in pairs]
    t = 10
    s = vdf.state_from_ints(xs, ys, [0] * 3, device="cpu")
    z0, proof = Evaluation.eval(vdf, s, t)
    jz0, jproof = JaxEvaluation.eval(jvdf, jvdf.state_from_ints(xs, ys, [0] * 3), t)
    assert [vdf.field.decode(a) for a in z0] == [jvdf.field.decode(a) for a in jz0]
    assert vdf.state_to_ints(proof.result) == jvdf.state_to_ints(jproof.result)
    assert proof.t == jproof.t == t and proof.field_name == jproof.field_name == "Fq"
    assert vdf.state_to_ints(vdf.inverse_eval(proof.result, t)) == (xs, ys, [0] * 3)
    assert bool(vdf.check(proof.result, t, s).all())
    assert proof.verify(s)


def test_append_chain_matches_jax(vdfs):
    """Mirrors test_vanilla_proof (src/minroot.rs:512-542): n=3 proofs of
    t=4 chained; final i == n*t; verify passes; same result as JAX."""
    vdf, jvdf, P = vdfs
    rng = XorShiftRng(TEST_SEED)
    x = field_random(rng, P.modulus)
    s0 = vdf.state_from_ints(x, 0, 0, device="cpu")
    t, n = 4, 3
    _, acc = Evaluation.eval(vdf, s0, t)
    for _ in range(1, n):
        _, nxt = Evaluation.eval(vdf, acc.result, t)
        acc = acc.append(nxt)
        assert acc is not None
    assert acc.t == n * t
    assert vdf.field.decode(acc.result.i) == n * t
    assert acc.verify(s0)

    js0 = jvdf.state_from_ints(x, 0, 0)
    _, jacc = JaxEvaluation.eval(jvdf, js0, n * t)
    assert vdf.state_to_ints(acc.result) == jvdf.state_to_ints(jacc.result)
    assert vdf.state_to_ints(acc.result) == oracle_eval(P.modulus, P.inv_alpha, (x, 0, 0), n * t)


def test_append_rejects_tampered_result(vdfs):
    vdf, _, _ = vdfs
    s0 = vdf.state_from_ints(777, 0, 0, device="cpu")
    _, proof = Evaluation.eval(vdf, s0, 4)
    bogus = Evaluation(
        result=vdf.state_from_ints(1, 2, 3, device="cpu"), t=4, field_name=proof.field_name, mode=proof.mode
    )
    assert proof.append(bogus) is None
    flipped = proof.result.x.clone()
    flipped[0] ^= 1
    tampered = Evaluation(State(flipped, proof.result.y, proof.result.i), 4, proof.field_name)
    assert not tampered.verify(s0)
    assert proof.verify(s0)


def test_verify_rejects_wrong_original(vdfs):
    vdf, jvdf, _ = vdfs
    s0 = vdf.state_from_ints(777, 0, 0, device="cpu")
    _, proof = Evaluation.eval(vdf, s0, 4)
    assert not proof.verify(vdf.state_from_ints(778, 0, 0, device="cpu"))
    _, jproof = JaxEvaluation.eval(jvdf, jvdf.state_from_ints(777, 0, 0), 4)
    assert not jproof.verify(jvdf.state_from_ints(778, 0, 0))


def test_modes_label_one_trace():
    """Every EvalMode labels the same trace (one kernel schedule)."""
    vdf = pallas_vdf()
    s = vdf.state_from_ints(99999, 12345, 0, device="cpu")
    results = {m: Evaluation.eval_with_mode(m, vdf, s, 1) for m in EvalMode.all()}
    ints = {vdf.state_to_ints(e.result) for e in results.values()}
    assert len(ints) == 1
    assert [e.mode for e in results.values()] == [m.value for m in EvalMode.all()]
    assert ints.pop() == oracle_eval(FQ.modulus, FQ.inv_alpha, (99999, 12345, 0), 1)


def test_fused_keeps_leading_shape():
    vdf = vesta_vdf()
    xs = [[3, 4], [5, 6]]
    s = State(*(vdf.field.encode(sum(xs, []), device="cpu").reshape(2, 2, 8) for _ in range(3)))
    out = eval_fused(vdf, s, 1)
    assert out.x.shape == (2, 2, 8)
    assert all(torch.equal(a, b) for a, b in zip(inverse_eval_fused(vdf, out, 1), s))
