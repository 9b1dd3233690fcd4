"""The reference against the program's plain CPU path at small sizes, and
the work functions against the counts PERF.md states."""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from perfbench.reference import curve as C
from perfbench.reference import ivc as ref_ivc
from perfbench.reference import minroot as ref_minroot
from perfbench.reference.limbs import mont_to_ints
from perfbench.work import k1

torch.set_num_threads(1)


@pytest.mark.parametrize("field", ["Fq", "Fp"])
@pytest.mark.parametrize("t", [2, 5, 8])
def test_minroot_equals_the_programs_plain_path(field, t):
    from vdf_tpu_torch.fields import get_field
    from vdf_tpu_torch.minroot import MinRootVDF

    p = ref_minroot.MODULI[field]
    rng = random.Random(t)
    starts = [(rng.randrange(p), rng.randrange(p), rng.randrange(p)) for _ in range(3)]
    vdf = MinRootVDF(get_field(field))
    s = vdf.state_from_ints(*map(list, zip(*starts)), device="cpu")
    out = vdf.eval(s, t)
    got = list(zip(*(mont_to_ints(c.numpy(), p) for c in out)))
    want = [ref_minroot.forward(st, t, p) for st in starts]
    assert got == want
    assert [ref_minroot.back(w, t, p) for w in want] == starts


def test_k1_work_is_perf_mds_count():
    """PERF.md §6: a forward round is 259 squarings and 68 products on Fq (64
    on Fp), a product 2 (64 + 24) and a squaring 2 (36 + 24) 32-bit
    multiply-adds; K1's bound at t = 2^16 on 8,192 lanes is 1,381.7 ms."""
    assert k1.round_counts("Fq") == (259, 68)
    assert k1.round_counts("Fp") == (259, 64)
    assert k1.mad32_per_round("Fq") == 43048
    assert round(k1.least_seconds("Fq", 8192, 1 << 16) * 1e3, 1) == 1381.7
    # one lane is far under the bytes bound's crossover: still the operations
    assert k1.least_seconds("Fq", 1, 10000) == pytest.approx(43048 * 10000 / k1.INT32_MAD_PER_S)


def test_frozen_shapes_and_digest_are_the_programs():
    from vdf_tpu_torch.nova.ivc import _shapes

    sp, ss, d = ref_ivc.shapes(1)
    _, _, qp, qs, qd = _shapes(1)
    assert d == qd
    for a, b in ((sp, qp), (ss, qs)):
        assert (a.num_cons, a.num_aux, a.num_inputs) == (b.num_cons, b.num_aux, b.num_inputs)
        for x, y in zip((a.a_coo, a.b_coo, a.c_coo), (b.a_coo, b.b_coo, b.c_coo)):
            assert np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
            assert [int(v) for v in x[2]] == [int(v) for v in y[2]]


@pytest.mark.parametrize("curve", ["pallas", "vesta"])
def test_generators_are_the_programs(curve):
    from vdf_tpu_torch.nova.pedersen import derive_generators

    gens, h = ref_ivc.generators(curve, 8)
    want = derive_generators(curve, 8)
    assert list(gens) == list(want[:8]) and h == want[8]


@pytest.mark.parametrize("curve", ["pallas", "vesta"])
def test_msm_equals_the_native_pippenger(curve):
    from vdf_tpu_torch.native import msm_native_affine

    gens, _ = ref_ivc.generators(curve, 64)
    q = C.CURVES[curve][1]
    rng = random.Random(3)
    for n, scal in ((1, [5]), (3, [0, 1, q - 1]), (64, [rng.randrange(q) for _ in range(64)])):
        assert C.msm(curve, gens[:n], scal) == msm_native_affine(curve, list(gens[:n]), scal)
    assert C.msm(curve, gens[:2], [0, 0]) is None


def test_mont_limbs_are_read_as_the_program_writes_them():
    from vdf_tpu_torch.fields import get_field

    f = get_field("Fq")
    vals = [0, 1, ref_minroot.MODULI["Fq"] - 1, 123456789 << 200]
    assert mont_to_ints(f.encode(vals, "cpu").numpy(), f.params.modulus) == vals
