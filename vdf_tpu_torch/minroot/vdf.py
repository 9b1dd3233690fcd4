"""MinRoot VDF over the Pasta scalar fields, on torch tensors.

Semantics mirror the reference trait ``MinRootVDF`` (src/minroot.rs:287-374)
and ``vdf_tpu.minroot.vdf``:

  forward round (slow):   x' = (x + y)^invalpha,  y' = x + i,  i' = i + 1
  inverse round (fast):   i' = i - 1,  x' = y - i',  y' = x^5 - x'

State components are ``(..., 8)`` int32 Montgomery tensors (see
fields/params.py), batched over lanes.  ``eval`` and ``inverse_eval`` are
the main path: they go through fields/kernels.py, which launches the
CUDA kernels K1/K2 for CUDA tensors and runs their plain versions for
CPU tensors.

``EvalMode`` is kept as a label.  The four reference strategies compute
the identical trace; the kernels run one schedule (the w=4 fixed window)
for all of them, as the TPU kernel did.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from ..fields import Field, get_field


class EvalMode(str, enum.Enum):
    """Forward-step strategy (reference EvalMode, src/minroot.rs:14-31)."""

    LTR_SEQUENTIAL = "ltr_sequential"
    LTR_ADD_CHAIN = "ltr_add_chain"
    RTL_SEQUENTIAL = "rtl_sequential"
    RTL_ADD_CHAIN = "rtl_add_chain"

    @classmethod
    def all(cls) -> list["EvalMode"]:
        return list(cls)


class State(NamedTuple):
    """VDF state triple; each leaf is a (..., 8) int32 Montgomery tensor.
    Mirrors reference ``State<T>`` (src/minroot.rs:267-272)."""

    x: torch.Tensor
    y: torch.Tensor
    i: torch.Tensor


class MinRootVDF:
    """MinRoot over one Pasta field.

    ``PallasVDF`` ≙ ``MinRootVDF(get_field("Fq"))`` (Pallas' scalar field),
    ``VestaVDF``  ≙ ``MinRootVDF(get_field("Fp"))``.
    """

    INVERSE_EXPONENT = 5

    def __init__(self, field: Field, mode: EvalMode = EvalMode.LTR_SEQUENTIAL):
        self.field = field
        self.mode = EvalMode(mode)

    # -- steps and single rounds (plain tensor code, any device) --------

    def forward_step(self, x: torch.Tensor) -> torch.Tensor:
        """x^invalpha — the slow 5th-root direction."""
        return self.field.pow(x, self.field.params.inv_alpha)

    def inverse_step(self, x: torch.Tensor) -> torch.Tensor:
        """x^5 — the fast direction (x * (x^2)^2)."""
        f = self.field
        return f.mul(f.sqr(f.sqr(x)), x)

    def round(self, s: State) -> State:
        f = self.field
        one = f.one(s.i.device).expand_as(s.i)
        return State(self.forward_step(f.add(s.x, s.y)), f.add(s.x, s.i), f.add(s.i, one))

    def inverse_round(self, s: State) -> State:
        f = self.field
        i = f.sub(s.i, f.one(s.i.device).expand_as(s.i))
        x = f.sub(s.y, i)
        return State(x, f.sub(self.inverse_step(s.x), x), i)

    # -- evaluation (the kernels) -----------------------------------------

    def eval(self, s: State, t: int) -> State:
        """t slow rounds: K1 on a CUDA state, its plain version on CPU."""
        from .fused import eval_fused

        return eval_fused(self, s, t)

    def inverse_eval(self, s: State, t: int) -> State:
        """t fast rounds: K2 on a CUDA state, its plain version on CPU."""
        from .fused import inverse_eval_fused

        return inverse_eval_fused(self, s, t)

    def check(self, result: State, t: int, original: State) -> torch.Tensor:
        """Verify by inverting: original == inverse_eval(result, t).
        Returns a boolean tensor over lanes."""
        back = self.inverse_eval(result, t)
        f = self.field
        return f.eq(back.x, original.x) & f.eq(back.y, original.y) & f.eq(back.i, original.i)

    # -- host-side conveniences -------------------------------------------

    def state_from_ints(self, x, y=0, i=0, device="cpu") -> State:
        """Ints give a single-lane state of (8,) tensors; equal-length
        sequences give (lanes, 8)."""
        f = self.field
        return State(f.encode(x, device), f.encode(y, device), f.encode(i, device))

    def state_to_ints(self, s: State):
        f = self.field
        return (f.decode(s.x), f.decode(s.y), f.decode(s.i))


def pallas_vdf(mode: EvalMode = EvalMode.LTR_SEQUENTIAL) -> MinRootVDF:
    """The reference's ``PallasVDF`` (MinRoot over Fq, src/minroot.rs:38-44)."""
    return MinRootVDF(get_field("Fq"), mode)


def vesta_vdf(mode: EvalMode = EvalMode.LTR_SEQUENTIAL) -> MinRootVDF:
    """The reference's ``VestaVDF`` (MinRoot over Fp, src/minroot.rs:199-262)."""
    return MinRootVDF(get_field("Fp"), mode)
