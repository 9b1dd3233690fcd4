"""The work of kernel K1 (t forward MinRoot rounds a lane) and its least
time on one NVIDIA H100 SXM, from the shapes alone.

A round raises (x + y) to e = 5^-1 mod (p - 1) with a 4-bit fixed window:
a table of base^k for k < 16 (base^(2k) a squaring of base^k, base^(2k+1)
a product: 7 squarings and 7 products), then four squarings a digit of e
after the first and one product a nonzero digit.  The count follows from
the modulus and e, whatever code computes it: 259 squarings and 68
products a round on Fq.  On 8 x 32-bit limbs a product is 64 + 24 and a
squaring 36 + 24 wide multiply-adds (the product, then the reduction by
the primes' shape 1 + c 2^32 + 2^254), each two 32-bit multiply-adds
(low and high halves): 43,048 32-bit multiply-adds a round on Fq.

Peak: 64 INT32 lanes an SM (NVIDIA H100 Tensor Core GPU Architecture
whitepaper) x 132 SMs x 1,980 MHz, at the card's 700 W limit.  Bytes: the
state (3 x 32 bytes a lane) read once and written once, at 3.35 TB/s.
"""

from __future__ import annotations

from perfbench.reference.frozen.fields.params import FIELDS, WINDOW, window_digits

MAD32_PER_PRODUCT = 2 * (64 + 24)
MAD32_PER_SQUARING = 2 * (36 + 24)
INT32_MAD_PER_S = 64 * 132 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
STATE_BYTES = 3 * 32


def round_counts(field: str) -> tuple[int, int]:
    """(squarings, products) of one forward round."""
    digits = window_digits(FIELDS[field].inv_alpha, WINDOW)
    half = (1 << WINDOW) // 2 - 1
    squarings = half + WINDOW * (len(digits) - 1)
    products = half + sum(1 for d in digits[1:] if d)
    return squarings, products


def mad32_per_round(field: str) -> int:
    squarings, products = round_counts(field)
    return squarings * MAD32_PER_SQUARING + products * MAD32_PER_PRODUCT


def least_seconds(field: str, lanes: int, rounds: int, launches: int = 1) -> float:
    """The larger of the operations bound and the bytes bound for ``launches``
    launches that together run ``rounds`` rounds on each of ``lanes`` lanes."""
    ops = mad32_per_round(field) * lanes * rounds / INT32_MAD_PER_S
    data = 2 * STATE_BYTES * lanes * launches / HBM_BYTES_PER_S
    return max(ops, data)
