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

The value-only pass over host ints (``check=False`` over an ``IntField``,
``cs.blocks``) keeps the aux vector as an ordered list of segments: runs of
Python ints allocated one at a time, and ``(k, 4)`` little-endian uint64
blocks of canonical values that a gadget allocates at once
(``alloc_block``, ``alloc_bits``: the native emitters' buffers, bit
decompositions).  ``aux_u64()`` gives the whole vector in that form for the
device; ``aux`` builds the int list on demand.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..errors import SynthesisError
from ..fields import Field
from ..fields.int_field import IntField
from ..native import ints_of_u64, pack_scalars_u64
from .cs import ONE, LinearCombination, Variable

# How each witness element of every WitnessCS of the process arrived: in a
# block (alloc_block, alloc_bits) or one at a time (alloc).  Never reset;
# syntheses on several threads (prove_interleaved) count under the lock.
ELEMENTS = {"block": 0, "single": 0}
_COUNT_LOCK = threading.Lock()


class WitnessCS:
    """Value-carrying pass.  Must allocate in the same order as ShapeCS."""

    def __init__(self, field: Field, inputs: list[torch.Tensor], check: bool = False):
        self.field = field
        self.inputs: list[torch.Tensor] = list(inputs)  # X values (no ONE)
        self.check = check
        self.failed: list[str] = []
        self._ns: list[str] = []
        # gadgets may allocate in blocks: a value-only pass over host ints
        self.blocks = not check and isinstance(field, IntField)
        self.num_aux = 0
        self._segs: list = []  # closed segments: int lists, (k, 4) uint64 blocks
        self._run: list = []  # the open run of single values

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

    @property
    def aux(self) -> list:
        """The witness values in allocation order; with blocks, a list built
        here (the blocks' values as ints)."""
        if not self._segs:
            return self._run
        out: list = []
        for seg in self._segs:
            out.extend(seg if isinstance(seg, list) else ints_of_u64(seg))
        out.extend(self._run)
        return out

    def aux_u64(self) -> np.ndarray:
        """The whole aux vector of a pass over host ints as one ``(n, 4)``
        little-endian uint64 array: the blocks as they are, the runs of
        single ints encoded."""
        parts = [seg if isinstance(seg, np.ndarray) else pack_scalars_u64(seg).reshape(-1, 4)
                 for seg in [*self._segs, self._run] if len(seg)]
        if not parts:
            return np.zeros((0, 4), dtype=np.uint64)
        return np.concatenate(parts)

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
        v = Variable("aux", self.num_aux)
        self.num_aux += 1
        self._run.append(value)
        with _COUNT_LOCK:
            ELEMENTS["single"] += 1
        return v

    def alloc_block(self, words: np.ndarray) -> int:
        """Allocate k values given as ``(k, 4)`` little-endian uint64
        canonical words, in order; -> the aux index of the first.  Only where
        ``blocks`` holds."""
        if not self.blocks:
            raise SynthesisError("alloc_block needs a value-only pass over host ints")
        if self._run:
            self._segs.append(self._run)
            self._run = []
        self._segs.append(words)
        first = self.num_aux
        self.num_aux += len(words)
        with _COUNT_LOCK:
            ELEMENTS["block"] += len(words)
        return first

    def alloc_bits(self, bits: np.ndarray) -> int:
        """Allocate k bit values (0/1 in any integer dtype) as one block;
        -> the aux index of the first."""
        block = np.zeros((len(bits), 4), dtype=np.uint64)
        block[:, 0] = bits
        return self.alloc_block(block)

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
