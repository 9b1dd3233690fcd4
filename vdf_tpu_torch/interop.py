"""Carry MinRoot state, curve points and commitment keys between the JAX
package and the port.

The JAX package holds a field element as ``(..., 17)`` uint32 radix-2^16
limbs in Montgomery form with ``R = 2^272`` (possibly a lazy value below
2p); the port as ``(..., 8)`` int32 u32 limbs with ``R = 2^256``, canonical.
The two meet only at canonical integers, so each direction decodes to
Python ints and re-encodes.  Nothing here imports jax: the JAX side is
plain numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .curves import CURVES, Point, get_curve
from .fields import get_field
from .minroot.vdf import State

JAX_NLIMBS = 17
JAX_LIMB_BITS = 16
JAX_MONT_BITS = JAX_NLIMBS * JAX_LIMB_BITS  # 272


def jax_limbs_to_ints(field_name: str, limbs) -> list[int]:
    """(..., 17) JAX Montgomery limbs -> canonical ints (flattened)."""
    p = get_field(field_name).params.modulus
    r_inv = pow(1 << JAX_MONT_BITS, -1, p)
    rows = np.asarray(limbs, dtype=np.uint64).reshape(-1, JAX_NLIMBS).tolist()
    return [
        sum(int(l) << (JAX_LIMB_BITS * k) for k, l in enumerate(row)) * r_inv % p
        for row in rows
    ]


def ints_to_jax_limbs(field_name: str, values) -> np.ndarray:
    """Ints -> (n, 17) uint32 canonical JAX Montgomery limbs (what the JAX
    ``Field.encode`` gives)."""
    p = get_field(field_name).params.modulus
    buf = b"".join(
        ((int(v) << JAX_MONT_BITS) % p).to_bytes(2 * JAX_NLIMBS, "little") for v in values
    )
    return np.frombuffer(buf, dtype="<u2").reshape(-1, JAX_NLIMBS).astype(np.uint32)


def from_jax(field_name: str, limbs, device="cpu") -> torch.Tensor:
    """One JAX limb array -> port tensor of the same leading shape."""
    limbs = np.asarray(limbs)
    out = get_field(field_name).encode(jax_limbs_to_ints(field_name, limbs), device)
    return out.reshape(*limbs.shape[:-1], out.shape[-1])


def to_jax(field_name: str, a: torch.Tensor) -> np.ndarray:
    """Port tensor -> JAX limb array of the same leading shape."""
    vals = get_field(field_name).decode(a.reshape(-1, a.shape[-1]))
    return ints_to_jax_limbs(field_name, vals).reshape(*a.shape[:-1], JAX_NLIMBS)


def state_from_jax(field_name: str, x, y, i, device="cpu") -> State:
    """JAX state leaves (numpy) -> port ``State``."""
    return State(*(from_jax(field_name, a, device) for a in (x, y, i)))


def state_to_jax(field_name: str, s: State) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Port ``State`` -> JAX state leaves as numpy arrays."""
    return tuple(to_jax(field_name, a) for a in s)


def point_from_jax(curve_name: str, point, device="cpu") -> Point:
    """JAX ``Point`` ((..., 17) coordinate arrays, numpy or jax) -> port
    ``Point``: the same projective triple, coordinate by coordinate."""
    field_name = CURVES[curve_name].base_field
    return Point(*(from_jax(field_name, np.asarray(a), device) for a in point))


def point_to_jax(curve_name: str, p: Point) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Port ``Point`` -> JAX coordinate arrays (x, y, z) as numpy."""
    field_name = CURVES[curve_name].base_field
    return tuple(to_jax(field_name, a) for a in p)


def commitment_key_from_jax(ck, device="cpu"):
    """A JAX ``CommitmentKey`` -> the port's, with the same generators and
    blinding point (read through its ``curve``, ``gens`` and ``h``)."""
    from .nova.pedersen import CommitmentKey

    name = ck.curve.params.name
    return CommitmentKey(get_curve(name), point_from_jax(name, ck.gens, device),
                         point_from_jax(name, ck.h, device))
