"""The inverse-MinRoot step circuit (Nova StepCircuit equivalent; port of
``vdf_tpu.nova.circuit``).

Mirrors the reference circuit semantics
(src/nova/proof.rs:58-230): arity 3 (z = [x, y, i]); each
of the t in-circuit rounds runs the VDF *inverse* direction with 3
constraints and 3 allocations:

    new_i = i - 1                  (linear only — lives in a Num)
    new_x = y - new_i              (linear only — lives in a Num)
    tmp1  = x^2                    (1 constraint)
    tmp2  = tmp1^2                 (1 constraint)
    new_y = tmp2*x - new_x         (allocation)
    enforce tmp2 * x = new_y + y - i + 1   (1 constraint)

plus final allocations binding the x/i chain outputs
(src/nova/proof.rs:122-133).

Soundness note (deviation from the reference): the reference *allocates*
new_x and only debug-asserts its relation to y - new_i
(proof.rs:166-176, 194-217), leaving the allocation unconstrained — a
forged witness can then satisfy the extracted R1CS for any claimed
output, because every field element has a 5th root.  Here new_x is a
``Num`` (a linear combination ``y - i + 1`` of already-bound variables),
so the x-chain is bound *by construction* with the same constraint
count; the step output x is bound into an allocation at segment end.

The value-only pass over host ints (``WitnessCS.blocks``) computes the
rounds' values in one loop and allocates them as one block; the shape pass
and the checking pass (``check=True``) run the gadgets above.
"""

from __future__ import annotations

import dataclasses

import torch

from ..fields import Field
from ..native import pack_scalars_u64
from ..r1cs.cs import LinearCombination, ONE, ShapeCS, Variable
from ..r1cs.gadgets import AllocatedNum, Num, _is_witness
from ..r1cs.witness import WitnessCS


def inverse_round_gadget(cs, i_num: Num, x, y):
    """One in-circuit inverse MinRoot round (3 constraints).

    ``x`` may be an AllocatedNum (segment input) or a Num (later rounds);
    ``y`` must carry a value in witness mode.
    """
    new_i = i_num.add_constant(cs, -1)

    # new_x = y - new_i: purely linear, so it lives in a Num — bound by
    # construction (no free allocation; see module docstring).
    if _is_witness(cs):
        f = cs.field
        new_x_val = f.sub(y.value, new_i.value)
    else:
        new_x_val = None
    new_x = Num(y.lc() - new_i.lc(), new_x_val)

    tmp1 = x.square(cs, "tmp1")
    tmp2 = tmp1.square(cs, "tmp2")

    if _is_witness(cs):
        f = cs.field
        new_y_val = f.sub(f.mul(tmp2.value, x.value), new_x.value)
        new_y = AllocatedNum(cs.alloc("new_y", value=new_y_val), new_y_val)
    else:
        new_y = AllocatedNum(cs.alloc("new_y"))

    # tmp2 * x = new_y + y - i + 1  ⇔  new_y = x^5 - new_x, with new_x
    # the linear combination above (reference round-closing constraint,
    # src/nova/proof.rs:219-227).
    cs.enforce(
        tmp2.lc(),
        x.lc(),
        new_y.lc() + y.lc() - i_num.lc() + LinearCombination.of(ONE, 1),
        name="round",
    )
    return new_i, new_x, new_y


@dataclasses.dataclass
class InverseMinRootCircuit:
    """Step circuit: t inverse rounds, arity 3.

    ``result``/``input`` States are carried for witness generation (the
    circuit consumes the segment *result* and walks back to its input),
    mirroring src/nova/proof.rs:58-77.
    """

    t: int
    inverse_exponent: int = 5
    result: object | None = None  # State (segment output) — witness only
    input: object | None = None  # State (segment input) — witness only

    def arity(self) -> int:
        return 3

    def synthesize(self, cs, z: list[AllocatedNum]) -> list[AllocatedNum]:
        assert len(z) == 3
        if getattr(cs, "blocks", False):
            return self._synthesize_block(cs, z)
        x, y = Num.from_alloc(z[0]), z[1]
        i_num = Num.from_alloc(z[2])

        for j in range(self.t):
            with cs.namespace(f"inverse_round_{j}"):
                i_num, x, y = inverse_round_gadget(cs, i_num, x, y)

        # Bind the final x and i LCs into their own allocations (the step
        # outputs must be AllocatedNums, not bare LCs).
        def bind(num: Num, name: str) -> AllocatedNum:
            if _is_witness(cs):
                out = AllocatedNum(cs.alloc(name, value=num.value), num.value)
            else:
                out = AllocatedNum(cs.alloc(name))
            cs.enforce(
                out.lc(),
                LinearCombination.of(ONE, 1),
                num.lc(),
                name=f"{name} matches its num",
            )
            return out

        return [bind(x, "final_x"), y, bind(i_num, "final_i")]

    def _synthesize_block(self, cs, z: list[AllocatedNum]) -> list[AllocatedNum]:
        """The value-only pass over host ints (``cs.blocks``): the t rounds
        on Python ints, allocated as one block in the per-element order
        (tmp1, tmp2, new_y a round, then final_x, final_i).  Its enforces
        would be no-ops, so none is made; the variables and values are the
        per-element path's."""
        q = cs.field.p
        x, y, i = z[0].value, z[1].value, z[2].value
        vals = []
        for _ in range(self.t):
            i = (i - 1) % q
            new_x = (y - i) % q
            tmp1 = x * x % q
            tmp2 = tmp1 * tmp1 % q
            y = (tmp2 * x - new_x) % q
            vals += (tmp1, tmp2, y)
            x = new_x
        vals += (x, i)
        first = cs.alloc_block(pack_scalars_u64(vals).reshape(-1, 4))
        end = first + 3 * self.t

        def aux(k: int, value) -> AllocatedNum:
            return AllocatedNum(Variable("aux", k), value)

        y_out = aux(end - 1, y) if self.t else z[1]
        return [aux(end, x), y_out, aux(end + 1, i)]

    # -- host conveniences ---------------------------------------------

    def shape(self, modulus: int) -> "ShapeCS":
        cs = ShapeCS(modulus)
        z = [AllocatedNum.alloc_input(cs, n) for n in ("z_x", "z_y", "z_i")]
        outs = self.synthesize(cs, z)
        # Step outputs become public IO as well (standalone mode; under
        # Nova's augmented circuit the folding verifier consumes them).
        for k, o in enumerate(outs):
            cs.enforce(
                o.lc(),
                LinearCombination.of(ONE, 1),
                LinearCombination.of(cs.alloc_input(f"out_{k}"), 1),
                name=f"bind_out_{k}",
            )
        return cs

    def witness(self, field: Field, z_values: list[torch.Tensor], check: bool = False):
        """Generate (W, outputs) for batched z values (each (..., 8))."""
        cs = WitnessCS(field, inputs=list(z_values), check=check)
        z = [AllocatedNum(v, val) for v, val in zip(self._input_vars(), z_values)]
        outs = self.synthesize(cs, z)
        return cs, [o.value for o in outs]

    @staticmethod
    def _input_vars():
        return [Variable("input", k + 1) for k in range(3)]
