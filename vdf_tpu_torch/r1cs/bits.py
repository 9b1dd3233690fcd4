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
augmented circuit.  In the value-only pass (``WitnessCS.blocks``) a
decomposition allocates its bits as one block and returns a ``BitBlock``.

A copy of ``vdf_tpu.r1cs.bits`` (host-integer code; the port cannot import that
package, which pulls in jax), its imports re-pointed at the port.
"""

from __future__ import annotations

import functools

import numpy as np

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


class BitBlock:
    """Bits allocated as one block of a value-only witness: the ``n``
    little-endian bits of ``value``, the first at aux index ``first``.  A
    sequence of AllocatedBit (an item is built when read); ``value`` is what
    ``bits_value`` reads."""

    __slots__ = ("first", "value", "n")

    def __init__(self, first: int, value: int, n: int):
        self.first, self.value, self.n = first, value, n

    @classmethod
    def alloc(cls, cs, value: int, n_bits: int) -> "BitBlock":
        value &= (1 << n_bits) - 1
        return cls(cs.alloc_bits(_le_bits(value, n_bits)), value, n_bits)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, k):
        if isinstance(k, slice):
            start, stop, step = k.indices(self.n)
            if step != 1:
                return [self[i] for i in range(start, stop, step)]
            n = max(stop - start, 0)
            return BitBlock(self.first + start, (self.value >> start) & ((1 << n) - 1), n)
        if k < 0:
            k += self.n
        if not 0 <= k < self.n:
            raise IndexError(k)
        return AllocatedBit(Variable("aux", self.first + k), (self.value >> k) & 1)

    def msb_first(self) -> np.ndarray:
        """The bits, most significant first, as uint64."""
        return _le_bits(self.value, self.n)[::-1].astype(np.uint64)


def _le_bits(value: int, n_bits: int) -> np.ndarray:
    """The low ``n_bits`` bits of a non-negative int, little-endian, uint8."""
    raw = np.frombuffer(value.to_bytes((n_bits + 7) // 8, "little"), dtype=np.uint8)
    return np.unpackbits(raw, bitorder="little")[:n_bits]


def alloc_bits_le(cs, value: int | None, n_bits: int, name: str):
    """``n_bits`` fresh boolean bits of ``value``, little-endian, named
    ``<name><i>``: one block in the value-only pass, else one AllocatedBit
    each."""
    if getattr(cs, "blocks", False):
        return BitBlock.alloc(cs, int(value), n_bits)
    w = _is_witness(cs)
    return [AllocatedBit.alloc(cs, f"{name}{i}", ((int(value) >> i) & 1) if w else None)
            for i in range(n_bits)]


def bits_value(bits: list[AllocatedBit], n: int | None = None) -> int | None:
    if isinstance(bits, BitBlock):
        return bits[: n or len(bits)].value
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
    bits = alloc_bits_le(cs, num.value, n_bits, f"{name}_")
    if isinstance(bits, BitBlock):
        return bits  # value-only: no constraint is read
    cs.enforce(
        bits_to_lc(bits),
        LinearCombination.of(ONE, 1),
        num.lc(),
        name=f"{name} recombine",
    )
    return bits


@functools.lru_cache(maxsize=4)
def _strict_chain(p: int) -> np.ndarray:
    """The positions of the 1-bits of p - 1, descending: the strict check's
    "equal so far" chain starts at the first and ANDs in each later one."""
    m = p - 1
    return np.array([i for i in range(m.bit_length() - 1, -1, -1) if (m >> i) & 1],
                    dtype=np.intp)


def num_to_bits_le_strict(cs, num, name: str = "sbits") -> list[AllocatedBit]:
    """Full-width decomposition with the canonical-representative check:
    the bit string is enforced <= p - 1, so exactly one decomposition of
    the field element exists (bellperson field_into_bits_le_strict
    semantics).  255 bits for both Pasta primes."""
    p = cs.modulus if hasattr(cs, "modulus") else cs.field.params.modulus
    n_bits = p.bit_length()
    if getattr(cs, "blocks", False):
        # one block: the bits, then the chain's AND values in their order
        value = int(num.value)
        bits = _le_bits(value, n_bits)
        chain = np.logical_and.accumulate(bits[_strict_chain(p)])[1:]
        first = cs.alloc_bits(np.concatenate([bits, chain]))
        return BitBlock(first, value, n_bits)
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
