"""Circuit gadgets: AllocatedNum / Num (bellperson-equivalent surface).

Mirrors the gadget API the reference circuit uses
(src/nova/proof.rs:3-9: AllocatedNum, Num, Boolean) in a
mode-polymorphic way: the same gadget code runs against ShapeCS (no
values, builds matrices) and WitnessCS (tensor values, builds W).  A copy
of ``vdf_tpu.r1cs.gadgets``; the port's field values are canonical, so the
JAX package's ``partial_reduce`` calls have no counterpart.
"""

from __future__ import annotations

from .cs import ONE, LinearCombination, Variable
from .witness import WitnessCS


def _is_witness(cs) -> bool:
    return isinstance(cs, WitnessCS)


class AllocatedNum:
    """A variable plus (in witness mode) its value."""

    def __init__(self, var: Variable, value=None):
        self.var = var
        self.value = value

    @classmethod
    def alloc(cls, cs, name: str, value_fn=None) -> "AllocatedNum":
        if _is_witness(cs):
            value = value_fn()
            return cls(cs.alloc(name, value=value), value)
        return cls(cs.alloc(name))

    @classmethod
    def alloc_input(cls, cs, name: str, value_fn=None) -> "AllocatedNum":
        if _is_witness(cs):
            raise NotImplementedError("inputs are pre-bound in witness mode")
        return cls(cs.alloc_input(name))

    def lc(self, coeff: int = 1) -> LinearCombination:
        return LinearCombination.of(self.var, coeff)

    def square(self, cs, name: str = "square") -> "AllocatedNum":
        """Allocate s = self^2 with constraint self * self = s."""
        if _is_witness(cs):
            value = cs.field.sqr(self.value)
            out = AllocatedNum(cs.alloc(name, value=value), value)
        else:
            out = AllocatedNum(cs.alloc(name))
        cs.enforce(self.lc(), self.lc(), out.lc(), name=name)
        return out

    def mul(self, cs, other: "AllocatedNum", name: str = "mul") -> "AllocatedNum":
        if _is_witness(cs):
            value = cs.field.mul(self.value, other.value)
            out = AllocatedNum(cs.alloc(name, value=value), value)
        else:
            out = AllocatedNum(cs.alloc(name))
        cs.enforce(self.lc(), other.lc(), out.lc(), name=name)
        return out


class Num:
    """A linear combination with (optionally) its value — used for values
    that never need their own witness column (e.g. the round counter,
    reference src/nova/proof.rs:101,162-164)."""

    def __init__(self, lc: LinearCombination, value=None):
        self.lc_ = lc
        self.value = value

    @classmethod
    def from_alloc(cls, num: AllocatedNum) -> "Num":
        return cls(num.lc(), num.value)

    def lc(self, coeff: int = 1) -> LinearCombination:
        return self.lc_ if coeff == 1 else self.lc_.scale(coeff)

    def square(self, cs, name: str = "square") -> "AllocatedNum":
        """Allocate s = self^2 with constraint self * self = s (works on
        any linear combination, not just single allocations)."""
        if _is_witness(cs):
            value = cs.field.sqr(self.value)
            out = AllocatedNum(cs.alloc(name, value=value), value)
        else:
            out = AllocatedNum(cs.alloc(name))
        cs.enforce(self.lc(), self.lc(), out.lc(), name=name)
        return out

    def add_constant(self, cs, k: int) -> "Num":
        """self + k (k an integer constant; uses the u/ONE column)."""
        value = None
        if self.value is not None:
            f = cs.field
            value = f.add(self.value, f.const_like(self.value, k))
        return Num(self.lc_.add(ONE, k), value)
