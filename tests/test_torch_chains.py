"""The port's addition chains and EvalMode schedules against the JAX package.

  * Every mode's program and cost (vdf_tpu_torch.fields.chains) equal to
    vdf_tpu.fields.chains's, op for op, for both fields' inv_alpha and for
    generic exponents.
  * pow_fixed, forward_step and forward_step_unrolled in each mode equal to
    the JAX package's on the same seeded inputs (numpy default_rng), on
    both fields, and to Python-int pow.
  * tests/test_fields.py::TestPow's and tests/test_minroot.py::TestEval's
    mode cases on the port, with device="cpu".

Equality is exact (canonical ints).
"""

import random

import numpy as np
import pytest
import torch

from vdf_tpu.fields import chains as jax_chains
from vdf_tpu.fields import get_field as jax_get_field
from vdf_tpu.minroot import MinRootVDF as JaxMinRootVDF
from vdf_tpu.minroot import EvalMode as JaxEvalMode
from vdf_tpu_torch.fields import FP, FQ, chains, get_field
from vdf_tpu_torch.fields.kernels import minroot_eval_plain
from vdf_tpu_torch.minroot import EvalMode, MinRootVDF, pallas_vdf
from vdf_tpu_torch.utils import TEST_SEED, XorShiftRng, field_random

torch.set_num_threads(1)  # many small tensor ops; see tests/test_torch_minroot.py

MODES = [m.value for m in EvalMode]
FIELDS = [("Fq", FQ), ("Fp", FP)]
GENERIC = [1, 2, 3, 5, 31, 65537, (1 << 64) - 59,
           int.from_bytes(b"\x33" * 16, "little") << 128 | 0x1234567,  # the Pasta byte structure
           int.from_bytes(b"\x5a" * 15, "little") << 128 | 1]  # another repeating byte


def rand_ints(p, n, seed=1234):
    rng = random.Random(seed)
    return [rng.randrange(p) for _ in range(n)]


def seeded(p: int, n: int) -> list[int]:
    rng = np.random.default_rng(int.from_bytes(TEST_SEED, "little"))
    return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]


# -- programs and costs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,params", FIELDS, ids=[f[0] for f in FIELDS])
def test_inv_alpha_program_equals_jax(name, params, mode):
    e = params.inv_alpha
    assert chains.get_program(e, mode) == jax_chains.get_program(e, mode)
    assert chains.program_cost(e, mode) == jax_chains.program_cost(e, mode)


@pytest.mark.parametrize("mode", MODES)
def test_generic_programs_equal_jax(mode):
    for e in GENERIC:
        assert chains.get_program(e, mode) == jax_chains.get_program(e, mode), e
        assert chains.program_cost(e, mode) == jax_chains.program_cost(e, mode), e
    for w in (1, 4, 5):
        assert chains.gen_sliding_window(GENERIC[6], w) == jax_chains.gen_sliding_window(
            GENERIC[6], w)


def test_program_checks():
    with pytest.raises(ValueError):
        chains.get_program(0, "ltr_sequential")
    ops, out = chains.gen_ltr_sequential(13)
    with pytest.raises(AssertionError, match="x\\^"):
        chains._check_program(ops, out, 14)  # the check sees a wrong exponent


def test_chain_costs_documented():
    """The structured LTR chain stays near the reference's 254 + 33."""
    sq, mul = chains.program_cost(FQ.inv_alpha, "ltr_add_chain")
    assert sq <= 254 and mul <= 60


# -- executors against the JAX package


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,params", FIELDS, ids=[f[0] for f in FIELDS])
def test_pow_fixed_equals_jax(name, params, mode):
    p = params.modulus
    xs = seeded(p, 6) + [0, 1, p - 1]
    f, jf = get_field(name), jax_get_field(name)
    got = f.decode(chains.pow_fixed(f, f.encode(xs, "cpu"), params.inv_alpha, mode))
    want = jf.decode(jax_chains.pow_fixed(jf, jf.encode(xs), params.inv_alpha, mode))
    assert got == want == [pow(x, params.inv_alpha, p) for x in xs]


@pytest.mark.parametrize("mode", list(EvalMode), ids=MODES)
@pytest.mark.parametrize("name,params", FIELDS, ids=[f[0] for f in FIELDS])
def test_forward_step_equals_jax(name, params, mode):
    """forward_step (the mode's uniform schedule) and forward_step_unrolled
    (its program) equal the JAX package's on the same inputs."""
    p = params.modulus
    xs = seeded(p, 5)
    vdf, jvdf = MinRootVDF(get_field(name), mode), JaxMinRootVDF(jax_get_field(name),
                                                                 JaxEvalMode(mode.value))
    x, jx = vdf.field.encode(xs, "cpu"), jvdf.field.encode(xs)
    want = [pow(v, params.inv_alpha, p) for v in xs]
    assert vdf.field.decode(vdf.forward_step(x)) == jvdf.field.decode(jvdf.forward_step(jx)) == want
    assert vdf.field.decode(vdf.forward_step_unrolled(x)) == jvdf.field.decode(
        jvdf.forward_step_unrolled(jx)) == want


@pytest.mark.parametrize("name,params", FIELDS, ids=[f[0] for f in FIELDS])
def test_schedules_on_generic_exponents(name, params):
    """pow_window (w = 1, 4, 5), pow_rtl and every mode's pow_fixed on
    exponents without the Pasta structure (mirrors TestPow's generic case)."""
    f = get_field(name)
    p = params.modulus
    a = rand_ints(p, 2, seed=11)
    x = f.encode(a, "cpu")
    for e in GENERIC:
        want = [pow(v, e, p) for v in a]
        for w in (1, 4, 5):
            assert f.decode(chains.pow_window(f, x, e, w)) == want, (e, w)
        assert f.decode(chains.pow_rtl(f, x, e)) == want, e
        for mode in MODES:
            assert f.decode(chains.pow_fixed(f, x, e, mode)) == want, (e, mode)
    assert f.decode(chains.pow_fixed(f, x, 0, "ltr_sequential")) == [1, 1]


# -- tests/test_fields.py::TestPow and tests/test_minroot.py::TestEval on the port


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,params", FIELDS, ids=[f[0] for f in FIELDS])
def test_invalpha_all_modes(name, params, mode):
    f = get_field(name)
    a = rand_ints(params.modulus, 4, seed=10)
    got = f.decode(chains.pow_fixed(f, f.encode(a, "cpu"), params.inv_alpha, mode))
    assert got == [pow(x, params.inv_alpha, params.modulus) for x in a]


@pytest.mark.parametrize("mode", list(EvalMode), ids=MODES)
def test_forward_inverse_roundtrip(mode):
    """inverse_step(forward_step(x)) == x on TEST_SEED inputs in each mode
    (test_steps, src/minroot.rs:460-477)."""
    vdf = pallas_vdf(mode)
    rng = XorShiftRng(TEST_SEED)
    xs = [field_random(rng, FQ.modulus) for _ in range(20)]
    x = vdf.field.encode(xs, "cpu")
    assert vdf.field.decode(vdf.inverse_step(vdf.forward_step(x))) == xs


@pytest.mark.parametrize("mode", list(EvalMode), ids=MODES)
def test_eval_roundtrip_all_modes(mode):
    """eval then inverse_eval returns the input and check() passes, in each
    mode (test_eval, src/minroot.rs:479-510, t = 10; the three samples as
    three lanes)."""
    vdf = pallas_vdf(mode)
    rng = XorShiftRng(TEST_SEED)
    t = 10
    xs, ys = zip(*((field_random(rng, FQ.modulus), field_random(rng, FQ.modulus))
                   for _ in range(3)))
    s = vdf.state_from_ints(list(xs), list(ys), [0, 0, 0], device="cpu")
    result = vdf.eval(s, t)
    again = vdf.inverse_eval(result, t)
    assert vdf.state_to_ints(again) == (list(xs), list(ys), [0, 0, 0])
    assert bool(vdf.check(result, t, s).all())


def test_modes_agree():
    """All four schedules compute the identical trace: the rounds by each
    mode's forward_step, and K1's plain version (one w = 4 schedule for
    every mode)."""
    s0 = (99999, 12345, 0)
    results = []
    for mode in EvalMode.all():
        vdf = pallas_vdf(mode)
        s = vdf.state_from_ints(*s0, device="cpu")
        for _ in range(3):
            s = vdf.round(s)
        results.append(vdf.state_to_ints(s))
        assert vdf.state_to_ints(vdf.eval(vdf.state_from_ints(*s0, device="cpu"), 3)) == results[-1]
    assert all(r == results[0] for r in results)


@pytest.mark.parametrize("mode", list(EvalMode), ids=MODES)
def test_round_equals_kernel_plain(mode):
    """One round by the mode's schedule equals K1's plain version at t = 1 on
    seeded lanes."""
    vdf = pallas_vdf(mode)
    f = vdf.field
    xs, ys, is_ = (seeded(FQ.modulus, 4 + k) for k in range(3))
    s = vdf.state_from_ints(xs[:4], ys[:4], is_[:4], device="cpu")
    got = vdf.round(s)
    want = minroot_eval_plain("Fq", *s, 1)
    assert all(f.decode(a) == f.decode(b) for a, b in zip(got, want))
