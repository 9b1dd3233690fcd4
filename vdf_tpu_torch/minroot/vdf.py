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

``EvalMode`` selects the schedule of ``forward_step`` (and ``round``),
as the JAX package's ``_MODE_IMPL`` does: an LTR window scan of width 1,
4 or 5, or RTL binary (fields/chains.py); ``forward_step_unrolled`` runs
the mode's addition-chain program.  The four strategies compute the
identical trace.  ``eval`` runs K1, whose one schedule (the w=4 fixed
window) serves every mode, as the TPU kernel's did.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from ..device import resolve_device
from ..fields import Field, get_field
from ..fields.chains import pow_fixed, pow_rtl, pow_window


class EvalMode(str, enum.Enum):
    """Forward-step strategy (reference EvalMode, src/minroot.rs:14-31)."""

    LTR_SEQUENTIAL = "ltr_sequential"
    LTR_ADD_CHAIN = "ltr_add_chain"
    RTL_SEQUENTIAL = "rtl_sequential"
    RTL_ADD_CHAIN = "rtl_add_chain"

    @classmethod
    def all(cls) -> list["EvalMode"]:
        return list(cls)


# mode -> (schedule, window): the JAX package's _MODE_IMPL
_MODE_IMPL = {
    EvalMode.LTR_SEQUENTIAL: ("ltr", 1),
    EvalMode.LTR_ADD_CHAIN: ("ltr", 4),
    EvalMode.RTL_SEQUENTIAL: ("rtl", None),
    EvalMode.RTL_ADD_CHAIN: ("ltr", 5),
}


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

    # -- steps and single rounds (Field ops: K10 on the card, any device) --

    def forward_step(self, x: torch.Tensor) -> torch.Tensor:
        """x^invalpha — the slow 5th-root direction, by the mode's schedule."""
        kind, window = _MODE_IMPL[self.mode]
        e = self.field.params.inv_alpha
        if kind == "rtl":
            return pow_rtl(self.field, x, e)
        return pow_window(self.field, x, e, window)

    def forward_step_unrolled(self, x: torch.Tensor) -> torch.Tensor:
        """The mode's addition-chain program, op by op (fields/chains.py)."""
        return pow_fixed(self.field, x, self.field.params.inv_alpha, self.mode.value)

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

    def state_from_ints(self, x, y=0, i=0, device=None) -> State:
        """Ints give a single-lane state of (8,) tensors; equal-length
        sequences give (lanes, 8).  ``device=None`` is the card."""
        device = resolve_device(device)
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
