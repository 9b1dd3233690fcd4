"""Boolean / bit-decomposition gadgets (bellperson's Boolean tier).

Used by the Nova augmented circuit (nova/augmented.py) for:
  * binding the 128-bit fold challenge squeezed from the in-circuit
    random oracle to scalar-multiplication bits,
  * truncating Poseidon outputs to 250 bits so state hashes fit in both
    Pasta fields,
  * range checks underpinning the non-native (cross-field) instance
    folds (nova/gadgets/bignat.py).

Reference role: bellperson ``Boolean`` / ``field_into_bits_le_strict``
(SURVEY.md §2 D6; the reference circuit itself never needs bits, but
nova-snark's augmented circuit does — proof.rs:232-237 synthesizes it).

Witness-mode values here are host ints (the IVC control plane runs on
``IntField``); the batched device witness path is not used for the
augmented circuit.

A copy of ``vdf_tpu.r1cs.bits`` (host-integer code; the port cannot import that
package, which pulls in jax), its imports re-pointed at the port.
"""

from __future__ import annotations

from .cs import ONE, LinearCombination, Variable
from .gadgets import AllocatedNum, Num, _is_witness


class AllocatedBit:
    """A variable constrained to {0, 1}."""

    def __init__(self, var: Variable, value: int | None = None):
        self.var = var
        self.value = value

    def lc(self, coeff: int = 1) -> LinearCombination:
        return LinearCombination.of(self.var, coeff)

    def not_lc(self) -> LinearCombination:
        """LC of (1 - b)."""
        return LinearCombination.of(ONE, 1) - self.lc()

    @classmethod
    def alloc(cls, cs, name: str, value: int | None = None) -> "AllocatedBit":
        if _is_witness(cs):
            assert value in (0, 1)
            bit = cls(cs.alloc(name, value=value), value)
        else:
            bit = cls(cs.alloc(name))
        # booleanity: b * (1 - b) = 0
        cs.enforce(bit.lc(), bit.not_lc(), LinearCombination(), name=f"{name} bool")
        return bit

    def and_(self, cs, other: "AllocatedBit", name: str = "and") -> "AllocatedBit":
        value = None
        if _is_witness(cs):
            value = self.value & other.value
            out = AllocatedBit(cs.alloc(name, value=value), value)
        else:
            out = AllocatedBit(cs.alloc(name))
        cs.enforce(self.lc(), other.lc(), out.lc(), name=name)
        return out


def bits_to_lc(bits: list[AllocatedBit], n: int | None = None) -> LinearCombination:
    """Little-endian recombination sum(2^i * b_i) as a free LC."""
    from .cs import _LC_DISABLED, NULL_LC

    if _LC_DISABLED.get():
        return NULL_LC
    lc = LinearCombination()
    for i, b in enumerate(bits[: n if n is not None else len(bits)]):
        lc = lc + b.lc(1 << i)
    return lc


def bits_value(bits: list[AllocatedBit], n: int | None = None) -> int | None:
    if any(b.value is None for b in bits):
        return None
    return sum(b.value << i for i, b in enumerate(bits[: n or len(bits)]))


def num_to_bits_le(cs, num, n_bits: int, name: str = "bits") -> list[AllocatedBit]:
    """Decompose ``num`` (Num/AllocatedNum) into ``n_bits`` little-endian
    bits and enforce the recombination equals ``num``.

    For ``n_bits <= 253`` (strictly below the modulus bit length) the
    recombination sum cannot wrap mod p, so the constraint doubles as a
    range proof ``value < 2^n_bits`` and the decomposition is unique.
    For full-width (255-bit) decompositions use
    ``num_to_bits_le_strict``, which additionally pins the canonical
    representative.
    """
    bits = []
    for i in range(n_bits):
        v = None
        if _is_witness(cs):
            v = (int(num.value) >> i) & 1
        bits.append(AllocatedBit.alloc(cs, f"{name}_{i}", v))
    cs.enforce(
        bits_to_lc(bits),
        LinearCombination.of(ONE, 1),
        num.lc(),
        name=f"{name} recombine",
    )
    return bits


def num_to_bits_le_strict(cs, num, name: str = "sbits") -> list[AllocatedBit]:
    """Full-width decomposition with the canonical-representative check:
    the bit string is enforced <= p - 1, so exactly one decomposition of
    the field element exists (bellperson field_into_bits_le_strict
    semantics).  255 bits for both Pasta primes."""
    p = cs.modulus if hasattr(cs, "modulus") else cs.field.params.modulus
    n_bits = p.bit_length()
    bits = []
    for i in range(n_bits):
        v = None
        if _is_witness(cs):
            v = (int(num.value) >> i) & 1
        bits.append(AllocatedBit.alloc(cs, f"{name}_{i}", v))
    cs.enforce(
        bits_to_lc(bits),
        LinearCombination.of(ONE, 1),
        num.lc(),
        name=f"{name} recombine",
    )

    # Enforce bits <= (p-1) scanning MSB -> LSB with an "equal so far"
    # indicator over the 1-bits of p-1: at any 0-bit of p-1, if every
    # higher 1-bit of p-1 was matched, the witness bit must be 0.
    m = p - 1
    eq: AllocatedBit | None = None  # None == constant True
    for i in range(n_bits - 1, -1, -1):
        if (m >> i) & 1:
            if eq is None:
                # eq' = bits[i] (AND with constant True)
                eq = bits[i]
            else:
                eq = eq.and_(cs, bits[i], name=f"{name}_eq_{i}")
        else:
            if eq is None:
                # all higher modulus bits are 1s matched by definition:
                # bit must be 0 outright (only if m's top run starts with
                # zeros — cannot happen since bit_length matches, but
                # keep it correct).
                cs.enforce(
                    bits[i].lc(),
                    LinearCombination.of(ONE, 1),
                    LinearCombination(),
                    name=f"{name}_lt_{i}",
                )
            else:
                cs.enforce(
                    eq.lc(), bits[i].lc(), LinearCombination(), name=f"{name}_lt_{i}"
                )
    return bits


def num_select(cs, cond: AllocatedBit, a, b, name: str = "sel"):
    """cond ? a : b for Num/AllocatedNum operands: one constraint
    cond * (a - b) = out - b."""
    value = None
    if _is_witness(cs):
        value = a.value if cond.value else b.value
        out = AllocatedNum(cs.alloc(name, value=value), value)
    else:
        out = AllocatedNum(cs.alloc(name))
    cs.enforce(cond.lc(), a.lc() - b.lc(), out.lc() - b.lc(), name=name)
    return out
