"""Replication of the reference test RNG for bit-exact test vectors.

The reference seeds ``rand_xorshift::XorShiftRng`` with
``TEST_SEED = [42u8; 16]`` (reference src/lib.rs:4) and draws field
elements via ``Field::random`` (reference src/minroot.rs:446-447,
467, 492; reference src/nova/proof.rs:412).  Reproducing that
sequence lets our tests evaluate the *exact same inputs* the Rust test
suite uses, so MinRoot traces are comparable bit-for-bit.

Algorithms (public, stable):

  * xorshift128 (Marsaglia 2003), as implemented by the ``rand_xorshift``
    crate: four u32 words of state; ``next_u64`` = two ``next_u32`` calls,
    low word first.
  * ``pasta_curves`` ``Field::random``: draw 512 bits little-endian (8
    u64s) and reduce modulo the field prime ("from_u512").
"""

from __future__ import annotations

MASK32 = 0xFFFFFFFF


class XorShiftRng:
    """xorshift128 as in rand_xorshift 0.3 (seeded from 16 LE bytes)."""

    def __init__(self, seed: bytes):
        assert len(seed) == 16
        self.x = int.from_bytes(seed[0:4], "little")
        self.y = int.from_bytes(seed[4:8], "little")
        self.z = int.from_bytes(seed[8:12], "little")
        self.w = int.from_bytes(seed[12:16], "little")

    def next_u32(self) -> int:
        t = (self.x ^ ((self.x << 11) & MASK32)) & MASK32
        self.x, self.y, self.z = self.y, self.z, self.w
        self.w = (self.w ^ (self.w >> 19)) ^ (t ^ (t >> 8))
        self.w &= MASK32
        return self.w

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return (hi << 32) | lo


TEST_SEED = bytes([42] * 16)  # reference src/lib.rs:4


def field_random(rng: XorShiftRng, modulus: int) -> int:
    """``Field::random``: 512 little-endian bits reduced mod the prime."""
    v = 0
    for k in range(8):
        v |= rng.next_u64() << (64 * k)
    return v % modulus
