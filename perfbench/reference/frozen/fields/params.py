"""Pasta field parameters and the port's 8 x 32-bit Montgomery constants.

The primes and inverse-alpha exponents are those of
``vdf_tpu.fields.params`` (pasta_curves 0.4), derived and checked the same
way.  The representation is the port's own:

  * a field element is ``(..., 8)`` ``torch.int32`` holding the bit
    patterns of 8 little-endian unsigned 32-bit limbs;
  * values are in Montgomery form with ``R = 2^256``;
  * both primes are ``2^254 + c`` with a 126-bit ``c``, so ``3p < R``
    but ``4p > R``: a Montgomery product of two inputs below ``p`` is
    below ``2p`` before its final conditional subtraction, and a lazy sum
    below ``3p`` fits in 256 bits (a sum up to ``4p`` would not);
  * values are canonical (``< p``) at every module boundary.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LIMB_BITS = 32
NLIMBS = 8
MONT_BITS = LIMB_BITS * NLIMBS  # 256
WINDOW = 4  # fixed window of the forward exponentiation

# The Pasta primes (pasta_curves 0.4).
P_FP = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
P_FQ = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001

# e = 5^{-1} mod (p - 1), so that (x^5)^e == x for all x.
FP_INVALPHA = pow(5, -1, P_FP - 1)
FQ_INVALPHA = pow(5, -1, P_FQ - 1)
assert (5 * FP_INVALPHA) % (P_FP - 1) == 1
assert (5 * FQ_INVALPHA) % (P_FQ - 1) == 1


def int_to_limbs(v: int, n: int = NLIMBS) -> np.ndarray:
    """Little-endian 32-bit limbs of ``v`` as uint32."""
    if v < 0 or v >> (LIMB_BITS * n):
        raise ValueError(f"value does not fit in {n} unsigned 32-bit limbs")
    return np.frombuffer(v.to_bytes(4 * n, "little"), dtype="<u4").astype(np.uint32)


def limbs_to_int(limbs) -> int:
    """Inverse of :func:`int_to_limbs` (takes uint32 or int32 bit patterns)."""
    return int.from_bytes(np.asarray(limbs).astype("<u4").tobytes(), "little")


def window_digits(e: int, window: int = WINDOW) -> list[int]:
    """Most-significant-first base-2^window digits of ``e``; the first
    digit is nonzero and seeds the exponentiation's accumulator."""
    digits = []
    while e:
        digits.append(e & ((1 << window) - 1))
        e >>= window
    return digits[::-1]


@dataclasses.dataclass(frozen=True)
class FieldParams:
    """Host-side description of one Pasta prime field."""

    name: str
    modulus: int
    inv_alpha: int  # 5^{-1} mod (p-1): the slow-direction exponent

    r: int = dataclasses.field(init=False)  # R = 2^256
    r_inv: int = dataclasses.field(init=False)  # R^{-1} mod p
    pinv: int = dataclasses.field(init=False)  # -p^{-1} mod R
    pinv32: int = dataclasses.field(init=False)  # -p^{-1} mod 2^32 (CIOS)
    mont_one: int = dataclasses.field(init=False)  # R mod p

    def __post_init__(self):
        p = self.modulus
        assert 3 * p < 1 << MONT_BITS < 4 * p
        R = 1 << MONT_BITS
        object.__setattr__(self, "r", R)
        object.__setattr__(self, "r_inv", pow(R, -1, p))
        object.__setattr__(self, "pinv", (-pow(p, -1, R)) % R)
        object.__setattr__(self, "pinv32", (-pow(p, -1, 1 << 32)) % (1 << 32))
        object.__setattr__(self, "mont_one", R % p)

    @property
    def inv_alpha_digits(self) -> list[int]:
        return window_digits(self.inv_alpha)

    def to_mont(self, v: int) -> int:
        return (v * self.r) % self.modulus


FP = FieldParams("Fp", P_FP, FP_INVALPHA)
FQ = FieldParams("Fq", P_FQ, FQ_INVALPHA)
FIELDS = {"Fp": FP, "Fq": FQ}
