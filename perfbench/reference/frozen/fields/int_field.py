"""Host-integer implementation of the Field op surface.

An IntField element is a canonical Python int in [0, p).  It mirrors the
method surface of ``fields.ops.Field`` so code written against that
surface can run on host integers, and it is the exact oracle the
tensor field and the MinRoot kernels are tested against.  There is no
Montgomery form on the host: ``to_mont``/``from_mont`` are identity and
``partial_reduce`` is a plain ``% p``.
"""

from __future__ import annotations

import functools

from .params import FieldParams


class IntField:
    """Field-op surface over canonical Python ints."""

    def __init__(self, params: FieldParams):
        self.params = params
        self.p = params.modulus
        self.zero = 0
        self.one = 1

    # -- basic ops (signatures match fields.ops.Field) ------------------

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def sqr(self, a: int) -> int:
        return (a * a) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def inv(self, a: int) -> int:
        return pow(a, -1, self.p) if a % self.p else 0

    def partial_reduce(self, v: int, k_max: int = 7) -> int:
        return v % self.p

    def canon(self, v: int) -> int:
        return v % self.p

    def eq(self, a: int, b: int) -> bool:
        return (a - b) % self.p == 0

    def is_zero(self, a: int) -> bool:
        return a % self.p == 0

    # -- conversions ----------------------------------------------------

    def to_mont(self, x: int) -> int:
        return x % self.p

    def from_mont(self, a: int) -> int:
        return a % self.p

    def encode(self, values):
        if isinstance(values, int):
            return values % self.p
        return [int(v) % self.p for v in values]

    def decode(self, a):
        if isinstance(a, int):
            return a % self.p
        return [int(v) % self.p for v in a]

    # -- field-agnostic helpers (shared surface with Field) --------------

    def const_like(self, like: int, k: int) -> int:
        return k % self.p

    def zero_like(self, like: int) -> int:
        return 0

    def one_like(self, like: int) -> int:
        return 1


@functools.cache
def get_int_field(name: str) -> IntField:
    from . import params as P

    return IntField({"Fp": P.FP, "Fq": P.FQ}[name])
