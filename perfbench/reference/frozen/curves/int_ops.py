"""Host-integer Pasta point ops (control-plane twin of curves/point.py).

A copy of ``vdf_tpu.curves.int_ops``, which the port cannot import (that
package pulls in jax).  The Nova IVC control plane folds *instances* (a
handful of points) on the host with Python ints; the device twin handles
the batched vectors.  Formulas are the same complete RCB15 a=0 add/double
as the tensor and CUDA implementations, so results agree exactly (locked
by tests/test_torch_curves.py).

A point is a tuple ``(x, y, z)`` of canonical ints, projective,
identity ``(0, 1, 0)``.
"""

from __future__ import annotations

import functools

from ..fields import get_field
from .point import B_COEFF, B3, PALLAS, VESTA

IntPoint = tuple[int, int, int]

IDENTITY: IntPoint = (0, 1, 0)


class IntCurve:
    def __init__(self, name: str):
        self.name = name
        params = {"pallas": PALLAS, "vesta": VESTA}[name]
        self.params = params
        self.p = get_field(params.base_field).params.modulus
        self.order = get_field(params.scalar_field).params.modulus

    # -- group law (complete; mirrors curves/point.py:88-129) -----------

    def add(self, P: IntPoint, Q: IntPoint) -> IntPoint:
        p = self.p
        x1, y1, z1 = P
        x2, y2, z2 = Q
        t0 = x1 * x2 % p
        t1 = y1 * y2 % p
        t2 = z1 * z2 % p
        t3 = ((x1 + y1) * (x2 + y2) - t0 - t1) % p
        t4 = ((y1 + z1) * (y2 + z2) - t1 - t2) % p
        y3 = ((x1 + z1) * (x2 + z2) - t0 - t2) % p
        x3 = 3 * t0 % p
        t2b = B3 * t2 % p
        z3 = (t1 + t2b) % p
        t1 = (t1 - t2b) % p
        y3 = B3 * y3 % p
        x3_out = (t3 * t1 - t4 * y3) % p
        y3_out = (t1 * z3 + y3 * x3) % p
        z3_out = (z3 * t4 + x3 * t3) % p
        return (x3_out, y3_out, z3_out)

    def double(self, P: IntPoint) -> IntPoint:
        p = self.p
        x, y, z = P
        t0 = y * y % p
        z3 = 8 * t0 % p
        t1 = y * z % p
        t2 = B3 * z % p * z % p
        x3 = t2 * z3 % p
        y3 = (t0 + t2) % p
        z3 = t1 * z3 % p
        t1 = 3 * t2 % p
        t0 = (t0 - t1) % p
        y3 = (t0 * y3 + x3) % p
        x3 = 2 * x % p * y % p * t0 % p
        return (x3, y3, z3)

    def neg(self, P: IntPoint) -> IntPoint:
        x, y, z = P
        return (x, (-y) % self.p, z)

    def scalar_mul(self, P: IntPoint, k: int) -> IntPoint:
        """Left-to-right double-and-add (host control plane only)."""
        acc = IDENTITY
        for bit in bin(k % self.order)[2:]:
            acc = self.double(acc)
            if bit == "1":
                acc = self.add(acc, P)
        return acc

    # -- predicates / conversions ---------------------------------------

    def is_identity(self, P: IntPoint) -> bool:
        return P[2] % self.p == 0

    def eq(self, P: IntPoint, Q: IntPoint) -> bool:
        p = self.p
        if self.is_identity(P) or self.is_identity(Q):
            return self.is_identity(P) and self.is_identity(Q)
        return (P[0] * Q[2] - Q[0] * P[2]) % p == 0 and (
            P[1] * Q[2] - Q[1] * P[2]
        ) % p == 0

    def to_affine(self, P: IntPoint) -> tuple[int, int] | None:
        """(x, y) canonical ints, or None for the identity."""
        if self.is_identity(P):
            return None
        zi = pow(P[2], -1, self.p)
        return (P[0] * zi % self.p, P[1] * zi % self.p)

    def from_affine(self, a: tuple[int, int] | None) -> IntPoint:
        if a is None:
            return IDENTITY
        return (a[0] % self.p, a[1] % self.p, 1)

    def on_curve(self, P: IntPoint) -> bool:
        """Projective curve membership: Y^2 Z == X^3 + b Z^3."""
        p = self.p
        x, y, z = P
        return (y * y % p * z - (x * x % p * x + B_COEFF * z * z % p * z)) % p == 0


@functools.cache
def get_int_curve(name: str) -> IntCurve:
    return IntCurve(name)
