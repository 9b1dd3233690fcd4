"""Non-native field arithmetic for cross-curve instance folding.

The primary augmented circuit (over Fq) folds secondary R1CS instances
whose public IO lives in Fp: it must compute X' = (X + r·x) mod p with
p ≠ q.  This is the one place the Pasta cycle forces non-native math
(nova-snark solves it with bellman-bignat; SURVEY.md §2 D3).

Representation: a cross-field element is 3 limbs of 85 bits
(little-endian, value = l0 + l1·2^85 + l2·2^170 < 2^255), each limb a
free linear combination of range-checked bits.  The canonical limb
split of the host-side integer is what transcripts absorb, so host and
circuit hash identical sequences.

The fold X' = (X + r·x) mod p is proven with an allocated quotient k
and a signed-carry chain over 85-bit limb columns; every linear
identity is between values < 2^214, far below both Pasta moduli, so
field equality implies integer equality (soundness) — see fold_mod.

A copy of ``vdf_tpu.nova.gadgets.bignat`` (host-integer code; the port cannot import that
package, which pulls in jax), its imports re-pointed at the port.
"""

from __future__ import annotations

from ...r1cs.bits import AllocatedBit, alloc_bits_le, bits_to_lc, bits_value, num_to_bits_le
from ...r1cs.cs import ONE, LinearCombination
from ...r1cs.gadgets import Num, _is_witness

LIMB_BITS = 85
N_LIMBS = 3  # 255 bits total


def _bits_limbs(cs, bits: list[AllocatedBit]) -> list[Num]:
    """Group little-endian bits into 85-bit limb Nums (free LCs)."""
    limbs = []
    for i in range(N_LIMBS):
        chunk = bits[i * LIMB_BITS : (i + 1) * LIMB_BITS]
        if not chunk:
            limbs.append(Num(LinearCombination(), 0 if _is_witness(cs) else None))
            continue
        value = bits_value(chunk) if _is_witness(cs) else None
        limbs.append(Num(bits_to_lc(chunk), value))
    return limbs


class BigNat:
    """A < 2^255 integer as 3 bit-backed 85-bit limbs."""

    def __init__(self, limbs: list[Num]):
        assert len(limbs) == N_LIMBS
        self.limbs = limbs

    @classmethod
    def alloc(cls, cs, name: str, value: int | None = None) -> "BigNat":
        """Allocate from 255 fresh range-checked bits."""
        return cls(_bits_limbs(cs, alloc_bits_le(cs, value, N_LIMBS * LIMB_BITS, f"{name}_b")))

    @classmethod
    def from_bits(cls, cs, bits: list[AllocatedBit]) -> "BigNat":
        assert len(bits) <= N_LIMBS * LIMB_BITS
        return cls(_bits_limbs(cs, bits))

    def value_int(self) -> int | None:
        if any(l.value is None for l in self.limbs):
            return None
        return sum(int(l.value) << (LIMB_BITS * i) for i, l in enumerate(self.limbs))

    def absorb_elements(self) -> list[Num]:
        """Canonical transcript encoding: the 3 limbs, low to high."""
        return list(self.limbs)

    @classmethod
    def constant(cls, cs, v: int) -> "BigNat":
        """A constant BigNat (limbs are ONE-column LCs, no allocations)."""
        limbs = []
        for i, lv in enumerate(int_to_limbs(v)):
            value = lv if _is_witness(cs) else None
            lc = LinearCombination.of(ONE, lv) if lv else LinearCombination()
            limbs.append(Num(lc, value))
        return cls(limbs)

    def select(self, cs, cond: AllocatedBit, other: "BigNat", name: str = "bnsel") -> "BigNat":
        from ...r1cs.bits import num_select

        return BigNat(
            [
                Num.from_alloc(
                    num_select(cs, cond, a, b, f"{name}_{i}")
                )
                for i, (a, b) in enumerate(zip(self.limbs, other.limbs))
            ]
        )


def int_to_limbs(v: int) -> list[int]:
    """Host-side canonical limb split (the transcript encoding)."""
    mask = (1 << LIMB_BITS) - 1
    return [(v >> (LIMB_BITS * i)) & mask for i in range(N_LIMBS)]


def fold_mod(
    cs,
    X: BigNat,
    r_bits: list[AllocatedBit],
    x_num,
    p_other: int,
    name: str = "nnfold",
    x_bits: list[AllocatedBit] | None = None,
) -> BigNat:
    """X' = (X + r·x) mod p_other, with r a 128-bit challenge and x a
    native-field value < 2^250 (a truncated state hash).

    Proof sketch: write r = rl + 2^85·rh, x = x0 + x1·2^85 + x2·2^170
    (bit-backed), form column sums c_i of X + r·x, allocate the result
    limbs X' (255 bits) and quotient k (126 bits: X + r·x < 2^379, so
    k < 2^379 / p < 2^126), and enforce the integer identity
        Σ c_i 2^{85i} − Σ X'_i 2^{85i} − k·p = 0
    with a signed carry chain: γ1 = d0/2^85, γ2 = (d1+γ1)/2^85,
    γ3 = (d2+γ2)/2^85, d3+γ3 = 0, where d_i = c_i − X'_i − k·p_i.  Each
    carry is allocated with a 2^127/2^128/2^129 offset and range-checked,
    keeping every identity's terms < 2^214 << q so that field equality
    implies integer equality.
    """
    from .ec import num_mul

    assert len(r_bits) == 128
    # x decomposed to 250 bits (doubles as the range proof x < 2^250);
    # callers that already decomposed x pass the bits in to share them.
    if x_bits is None:
        x_bits = num_to_bits_le(cs, x_num, 250, f"{name}_xb")
    assert len(x_bits) == 250
    xl = _bits_limbs(cs, x_bits)  # x0, x1: 85 bits; x2: 80 bits

    rl = Num(bits_to_lc(r_bits[:LIMB_BITS]), bits_value(r_bits[:LIMB_BITS]) if _is_witness(cs) else None)
    rh = Num(bits_to_lc(r_bits[LIMB_BITS:]), bits_value(r_bits[LIMB_BITS:]) if _is_witness(cs) else None)

    # 6 cross products (each operand < 2^85 / < 2^43, products < 2^170).
    prods = {}
    for ri, rnum in (("l", rl), ("h", rh)):
        for xi in range(N_LIMBS):
            prods[(ri, xi)] = num_mul(cs, rnum, xl[xi], f"{name}_r{ri}x{xi}")

    def lc_of(num_like):
        return num_like.lc()

    # Column sums of X + r·x over 85-bit positions.
    c_lcs = [
        X.limbs[0].lc() + prods[("l", 0)].lc(),
        X.limbs[1].lc() + prods[("l", 1)].lc() + prods[("h", 0)].lc(),
        X.limbs[2].lc() + prods[("l", 2)].lc() + prods[("h", 1)].lc(),
        prods[("h", 2)].lc(),
    ]

    if _is_witness(cs):
        x_int = int(x_num.value)
        r_int = bits_value(r_bits)
        X_int = X.value_int()
        total = X_int + r_int * x_int
        out_v = total % p_other
        k_v = (total - out_v) // p_other
    else:
        out_v = k_v = None

    out = BigNat.alloc(cs, f"{name}_out", out_v)
    k_bits = alloc_bits_le(cs, k_v, 126, f"{name}_k")
    k = Num(bits_to_lc(k_bits), bits_value(k_bits) if _is_witness(cs) else None)

    pl = int_to_limbs(p_other)
    kp = [num_mul(cs, k, Num(LinearCombination.of(ONE, pl[i]), pl[i] if _is_witness(cs) else None), f"{name}_kp{i}") for i in range(N_LIMBS)]

    # d_i = c_i - out_i - k·p_i; carry chain with offsets.
    d_lcs = [
        c_lcs[0] - out.limbs[0].lc() - kp[0].lc(),
        c_lcs[1] - out.limbs[1].lc() - kp[1].lc(),
        c_lcs[2] - out.limbs[2].lc() - kp[2].lc(),
        c_lcs[3],
    ]
    offsets = [127, 128, 129]  # carry offset exponents
    widths = [128, 130, 131]  # carry range-check widths

    def alloc_carry(i: int, value: int | None) -> Num:
        bits = alloc_bits_le(cs, value, widths[i], f"{name}_g{i}b")
        return Num(bits_to_lc(bits), bits_value(bits) if _is_witness(cs) else None)

    if _is_witness(cs):
        # exact integer carries, recomputed from the true limb values
        c_vals = [
            X_int % (1 << LIMB_BITS) + (r_int % (1 << LIMB_BITS)) * (x_int % (1 << LIMB_BITS)),
        ]
        # easier: recompute d values directly from integers
        xs = int_to_limbs(x_int)
        rl_v, rh_v = r_int & ((1 << LIMB_BITS) - 1), r_int >> LIMB_BITS
        Xl = [int(l.value) for l in X.limbs]
        outl = int_to_limbs(out_v)
        kpl = [k_v * pl[i] for i in range(N_LIMBS)]
        c0 = Xl[0] + rl_v * xs[0]
        c1 = Xl[1] + rl_v * xs[1] + rh_v * xs[0]
        c2 = Xl[2] + rl_v * xs[2] + rh_v * xs[1]
        c3 = rh_v * xs[2]
        d0 = c0 - outl[0] - kpl[0]
        g1 = d0 >> LIMB_BITS
        assert d0 == g1 << LIMB_BITS
        d1 = c1 - outl[1] - kpl[1] + g1
        g2 = d1 >> LIMB_BITS
        assert d1 == g2 << LIMB_BITS
        d2 = c2 - outl[2] - kpl[2] + g2
        g3 = d2 >> LIMB_BITS
        assert d2 == g3 << LIMB_BITS
        assert c3 + g3 == 0
        g_shift = [g1 + (1 << offsets[0]), g2 + (1 << offsets[1]), g3 + (1 << offsets[2])]
        assert all(g >= 0 for g in g_shift)
    else:
        g_shift = [None, None, None]

    g = [alloc_carry(i, g_shift[i]) for i in range(3)]
    one = LinearCombination.of(ONE, 1)
    zero = LinearCombination()
    # d0 + OFF0·2^85 = g1s·2^85
    cs.enforce(
        d_lcs[0] + LinearCombination.of(ONE, 1 << (offsets[0] + LIMB_BITS)),
        one,
        g[0].lc(1 << LIMB_BITS),
        name=f"{name}_carry0",
    )
    # d1 + (g1s - OFF0) + OFF1·2^85 = g2s·2^85
    cs.enforce(
        d_lcs[1]
        + g[0].lc()
        - LinearCombination.of(ONE, 1 << offsets[0])
        + LinearCombination.of(ONE, 1 << (offsets[1] + LIMB_BITS)),
        one,
        g[1].lc(1 << LIMB_BITS),
        name=f"{name}_carry1",
    )
    cs.enforce(
        d_lcs[2]
        + g[1].lc()
        - LinearCombination.of(ONE, 1 << offsets[1])
        + LinearCombination.of(ONE, 1 << (offsets[2] + LIMB_BITS)),
        one,
        g[2].lc(1 << LIMB_BITS),
        name=f"{name}_carry2",
    )
    cs.enforce(
        d_lcs[3] + g[2].lc() - LinearCombination.of(ONE, 1 << offsets[2]),
        one,
        zero,
        name=f"{name}_carry3",
    )
    return out
