"""Whole-t MinRoot evaluation on the device (front end of K1/K2).

The JAX package's fused.py converted between its two TPU
representations around the Pallas kernels.  The port has one
representation, so this is a thin call into fields/kernels.py: it
flattens ``(..., 8)`` state leaves to ``(lanes, 8)`` contiguous tensors
and restores their shape on the way out.
"""

from __future__ import annotations

from ..fields.kernels import minroot_eval, minroot_inverse
from .vdf import State


def _run(kernel, vdf, s: State, t: int) -> State:
    shape = s.x.shape
    flat = (a.reshape(-1, shape[-1]).contiguous() for a in s)
    out = kernel(vdf.field.params.name, *flat, t)
    return State(*(a.reshape(shape) for a in out))


def eval_fused(vdf, s: State, t: int) -> State:
    """t forward rounds through K1 (its plain version for CPU tensors)."""
    return _run(minroot_eval, vdf, s, t)


def inverse_eval_fused(vdf, s: State, t: int) -> State:
    """t inverse rounds (the verify direction) through K2."""
    return _run(minroot_inverse, vdf, s, t)
