"""Poseidon parameter generation over the Pasta fields (a copy of
``vdf_tpu.poseidon.params``, which the port cannot import: that package
pulls in jax).

Plays the role of ``neptune`` in the reference stack (SURVEY.md §2 D4):
Nova 0.8 uses Poseidon as its Fiat–Shamir random oracle, natively and
in-circuit.  The reference does not vendor neptune's sources, so this
module *generates* parameters with the well-specified public algorithms
from the Poseidon paper (GKRRS19) reference implementation:

  * Round constants from the Grain LFSR stream, seeded with the field /
    S-box / width / round-count descriptor (§"Grain" of the paper's
    reference code).
  * MDS matrix as the Cauchy matrix 1/(x_i + y_j) with x = 0..t-1,
    y = t..2t-1.
  * alpha = 5 (valid S-box for both Pasta primes: gcd(5, p-1) = 1).
  * R_F = 8 full rounds; R_P partial rounds per the 128-bit security
    tables of the paper for alpha=5, 255-bit primes.

All generation is exact host-side integer math; results are cached per
(field, width).
"""

from __future__ import annotations

import functools

import numpy as np

from ..fields.params import FieldParams

ALPHA = 5
FULL_ROUNDS = 8

# Partial rounds for 128-bit security, alpha=5, ~255-bit prime (Poseidon
# paper Table 2 / reference script output, incl. the +7.5% security
# margin the reference implementation applies).
_PARTIAL_ROUNDS = {
    2: 55, 3: 55, 4: 56, 5: 56, 6: 56, 7: 56, 8: 57, 9: 57, 10: 57,
    11: 57, 12: 57, 13: 57, 14: 57, 15: 59, 16: 59, 17: 59, 18: 59,
    19: 59, 20: 59, 21: 59, 22: 59, 23: 59, 24: 59, 25: 59, 26: 59,
    27: 59, 28: 59, 29: 59, 30: 60, 31: 60, 32: 60, 33: 60, 34: 60,
    35: 60, 36: 60, 37: 60,
}


def partial_rounds(width: int) -> int:
    return _PARTIAL_ROUNDS[width]


class GrainLFSR:
    """80-bit Grain LFSR bit/field-element stream (Poseidon reference)."""

    def __init__(self, prime_bits: int, width: int, r_f: int, r_p: int):
        bits = []
        # Seed layout per the reference implementation:
        # 2b field type (1=prime), 4b sbox (0 => x^alpha), 12b field size,
        # 12b width, 10b R_F, 10b R_P, 30 ones.
        for val, n in [(1, 2), (0, 4), (prime_bits, 12), (width, 12),
                       (r_f, 10), (r_p, 10), ((1 << 30) - 1, 30)]:
            bits.extend((val >> (n - 1 - k)) & 1 for k in range(n))
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):  # warm-up, discard
            self._next_bit()

    def _next_bit(self) -> int:
        # Grain-for-Poseidon feedback taps {0,13,23,38,51,62} (oldest=0).
        s = self.state
        new = s[0] ^ s[13] ^ s[23] ^ s[38] ^ s[51] ^ s[62]
        self.state = s[1:] + [new]
        return new

    def next_filtered_bit(self) -> int:
        # Self-shrinking: emit a bit only when the preceding bit is 1.
        while True:
            b1 = self._next_bit()
            b2 = self._next_bit()
            if b1:
                return b2

    def next_field_element(self, modulus: int, n_bits: int) -> int:
        while True:
            v = 0
            for _ in range(n_bits):
                v = (v << 1) | self.next_filtered_bit()
            if v < modulus:
                return v


@functools.lru_cache(maxsize=64)
def generate_constants(field_name: str, width: int):
    """(round_constants [(R_F+R_P)*width], mds [width,width]) as int tuples."""
    from ..fields.params import FP, FQ

    P = {"Fp": FP, "Fq": FQ}[field_name]
    p = P.modulus
    r_p = partial_rounds(width)
    n_bits = p.bit_length()
    grain = GrainLFSR(n_bits, width, FULL_ROUNDS, r_p)
    n_consts = (FULL_ROUNDS + r_p) * width
    rc = tuple(grain.next_field_element(p, n_bits) for _ in range(n_consts))

    # Cauchy MDS: M[i][j] = 1 / (x_i + y_j), x = 0..t-1, y = t..2t-1.
    mds = tuple(
        tuple(pow((i + width + j) % p, -1, p) for j in range(width))
        for i in range(width)
    )
    return rc, mds


@functools.lru_cache(maxsize=64)
def round_constants(field_name: str, width: int):
    """``generate_constants`` as the host rounds read it: (rc, mds), rc a
    list of (R_F+R_P) rows of ``width`` constants, one a round."""
    rc, mds = generate_constants(field_name, width)
    n_rounds = FULL_ROUNDS + partial_rounds(width)
    return [rc[r * width : (r + 1) * width] for r in range(n_rounds)], mds
