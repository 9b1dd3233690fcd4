"""Witness-generation constraint system (tensor-valued synthesis pass).

Port of ``vdf_tpu.r1cs.witness``.  The same circuit code that built the
shape runs again with concrete values.  Like the reference's, the pass is
generic over the field's op surface: with ``fields.Field`` allocations
carry ``(..., 8)`` Montgomery tensors (batched over lanes) and ``witness()``
stacks them on the values' device, one small torch op after another; with
``fields.IntField`` they are canonical Python ints (the two-curve IVC's
augmented circuit, nova/augmented.py).

``check=True`` additionally verifies each enforced constraint against
the values (TestConstraintSystem behavior, reference
src/nova/proof.rs:319-340).
"""

from __future__ import annotations

import torch

from ..errors import SynthesisError
from ..fields import Field
from .cs import ONE, LinearCombination, Variable


class WitnessCS:
    """Value-carrying pass.  Must allocate in the same order as ShapeCS."""

    def __init__(self, field: Field, inputs: list[torch.Tensor], check: bool = False):
        self.field = field
        self.aux: list[torch.Tensor] = []
        self.inputs: list[torch.Tensor] = list(inputs)  # X values (no ONE)
        self.check = check
        self.failed: list[str] = []
        self._ns: list[str] = []

    class _Namespace:
        def __init__(self, cs, name):
            self.cs, self.name = cs, name

        def __enter__(self):
            self.cs._ns.append(self.name)
            return self.cs

        def __exit__(self, *a):
            self.cs._ns.pop()

    def namespace(self, name: str):
        return self._Namespace(self, name)

    def value_of(self, var: Variable) -> torch.Tensor:
        if var.kind == "aux":
            return self.aux[var.index]
        if var.index == 0:
            ref = self.aux[0] if self.aux else self.inputs[0]
            return self.field.const_like(ref, 1)
        return self.inputs[var.index - 1]

    def alloc(self, name: str = "aux", value=None) -> Variable:
        if value is None:
            raise SynthesisError("witness pass requires a value")
        v = Variable("aux", len(self.aux))
        self.aux.append(value)
        return v

    def alloc_input(self, name: str = "input", value=None) -> Variable:
        """Append a public input computed *during* synthesis (used by the
        augmented circuit, whose IO hashes are outputs of the synthesis
        itself).  Pre-bound inputs passed to __init__ keep lower indices."""
        if value is None:
            raise SynthesisError("witness pass requires a value")
        v = Variable("input", len(self.inputs) + 1)  # ONE is input 0
        self.inputs.append(value)
        return v

    def eval_lc(self, lc: LinearCombination) -> torch.Tensor:
        f = self.field
        acc = None
        for var, coeff in lc.terms.items():
            coeff = coeff % f.params.modulus
            if coeff == 0:
                continue
            val = self.value_of(var)
            if coeff != 1:
                val = f.mul(val, f.const_like(val, coeff))
            acc = val if acc is None else f.add(acc, val)
        if acc is None:
            ref = self.aux[0] if self.aux else self.inputs[0]
            return f.zero_like(ref)
        return acc

    def enforce(self, a, b, c, name: str = "") -> None:
        if not self.check:
            return
        f = self.field
        lhs = f.mul(self.eval_lc(a), self.eval_lc(b))
        rhs = self.eval_lc(c)
        ok = f.eq(lhs, rhs)  # a bool over ints, a bool tensor over lanes
        if not bool(ok.all() if isinstance(ok, torch.Tensor) else ok):
            self.failed.append("/".join(self._ns + [name]))

    def witness(self) -> torch.Tensor:
        """Stacked W: (num_aux, ..., 8)."""
        return torch.stack(self.aux)
