"""Carry MinRoot state, curve points, commitment keys, Nova folding state
(instances, witnesses, whole proofs) and two-curve IVC proofs between the
JAX package and the port.

The JAX package holds a field element as ``(..., 17)`` uint32 radix-2^16
limbs in Montgomery form with ``R = 2^272`` (possibly a lazy value below
2p); the port as ``(..., 8)`` int32 u32 limbs with ``R = 2^256``, canonical.
The two meet only at canonical integers, so each direction decodes to
Python ints and re-encodes.  Nothing here imports jax: the JAX side is
plain numpy arrays, or objects read through their attributes.  The
``*_to_jax`` functions return plain tuples of numpy arrays in the field order
of the JAX package's NamedTuples, for the caller to wrap.
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


def from_jax(field_name: str, limbs, device=None) -> torch.Tensor:
    """One JAX limb array -> port tensor of the same leading shape."""
    limbs = np.asarray(limbs)
    out = get_field(field_name).encode(jax_limbs_to_ints(field_name, limbs), device)
    return out.reshape(*limbs.shape[:-1], out.shape[-1])


def to_jax(field_name: str, a: torch.Tensor) -> np.ndarray:
    """Port tensor -> JAX limb array of the same leading shape."""
    vals = get_field(field_name).decode(a.reshape(-1, a.shape[-1]))
    return ints_to_jax_limbs(field_name, vals).reshape(*a.shape[:-1], JAX_NLIMBS)


def state_from_jax(field_name: str, x, y, i, device=None) -> State:
    """JAX state leaves (numpy) -> port ``State``."""
    return State(*(from_jax(field_name, a, device) for a in (x, y, i)))


def state_to_jax(field_name: str, s: State) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Port ``State`` -> JAX state leaves as numpy arrays."""
    return tuple(to_jax(field_name, a) for a in s)


def point_from_jax(curve_name: str, point, device=None) -> Point:
    """JAX ``Point`` ((..., 17) coordinate arrays, numpy or jax) -> port
    ``Point``: the same projective triple, coordinate by coordinate."""
    field_name = CURVES[curve_name].base_field
    return Point(*(from_jax(field_name, np.asarray(a), device) for a in point))


def point_to_jax(curve_name: str, p: Point) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Port ``Point`` -> JAX coordinate arrays (x, y, z) as numpy."""
    field_name = CURVES[curve_name].base_field
    return tuple(to_jax(field_name, a) for a in p)


def commitment_key_from_jax(ck, device=None):
    """A JAX ``CommitmentKey`` -> the port's, with the same generators and
    blinding point (read through its ``curve``, ``gens`` and ``h``)."""
    from .nova.pedersen import CommitmentKey

    name = ck.curve.params.name
    return CommitmentKey(get_curve(name), point_from_jax(name, ck.gens, device),
                         point_from_jax(name, ck.h, device))


# ---------------------------------------------------------------------
# Nova folding state.  ``curve_name`` is the commitment curve; scalars (x,
# u, w, e) live in its scalar field.
# ---------------------------------------------------------------------


def r1cs_instance_from_jax(curve_name: str, inst, device=None):
    """A JAX ``R1CSInstance`` (comm_w, x) -> the port's."""
    from .nova.nifs import R1CSInstance

    sf = CURVES[curve_name].scalar_field
    return R1CSInstance(point_from_jax(curve_name, inst.comm_w, device),
                        from_jax(sf, inst.x, device))


def r1cs_instance_to_jax(curve_name: str, inst):
    """The port's ``R1CSInstance`` -> ((x, y, z), x) numpy arrays."""
    sf = CURVES[curve_name].scalar_field
    return point_to_jax(curve_name, inst.comm_w), to_jax(sf, inst.x)


def relaxed_instance_from_jax(curve_name: str, inst, device=None):
    """A JAX ``RelaxedInstance`` (comm_w, comm_e, x, u) -> the port's."""
    from .nova.nifs import RelaxedInstance

    sf = CURVES[curve_name].scalar_field
    return RelaxedInstance(point_from_jax(curve_name, inst.comm_w, device),
                           point_from_jax(curve_name, inst.comm_e, device),
                           from_jax(sf, inst.x, device), from_jax(sf, inst.u, device))


def relaxed_instance_to_jax(curve_name: str, inst):
    """The port's ``RelaxedInstance`` -> (comm_w, comm_e, x, u) numpy arrays."""
    sf = CURVES[curve_name].scalar_field
    return (point_to_jax(curve_name, inst.comm_w), point_to_jax(curve_name, inst.comm_e),
            to_jax(sf, inst.x), to_jax(sf, inst.u))


def relaxed_witness_from_jax(curve_name: str, wit, device=None):
    """A JAX ``RelaxedWitness`` (w, e) -> the port's."""
    from .nova.nifs import RelaxedWitness

    sf = CURVES[curve_name].scalar_field
    return RelaxedWitness(from_jax(sf, wit.w, device), from_jax(sf, wit.e, device))


def relaxed_witness_to_jax(curve_name: str, wit):
    """The port's ``RelaxedWitness`` -> (w, e) numpy arrays."""
    sf = CURVES[curve_name].scalar_field
    return to_jax(sf, wit.w), to_jax(sf, wit.e)


def nova_proof_from_jax(curve_name: str, proof, device=None):
    """A JAX ``NovaVDFProof`` (snark.step_instances, snark.U, snark.W,
    comm_ts) -> the port's."""
    from .nova.snark import NovaVDFProof, RecursiveSNARK

    snark = proof.snark
    return NovaVDFProof(
        RecursiveSNARK([r1cs_instance_from_jax(curve_name, u, device)
                        for u in snark.step_instances],
                       relaxed_instance_from_jax(curve_name, snark.U, device),
                       relaxed_witness_from_jax(curve_name, snark.W, device)),
        [point_from_jax(curve_name, t, device) for t in proof.comm_ts])


def nova_proof_to_jax(curve_name: str, proof) -> dict:
    """The port's ``NovaVDFProof`` -> {"step_instances", "U", "W", "comm_ts"}
    of numpy tuples, as the ``*_to_jax`` functions above give them."""
    snark = proof.snark
    return {
        "step_instances": [r1cs_instance_to_jax(curve_name, u) for u in snark.step_instances],
        "U": relaxed_instance_to_jax(curve_name, snark.U),
        "W": relaxed_witness_to_jax(curve_name, snark.W),
        "comm_ts": [point_to_jax(curve_name, t) for t in proof.comm_ts],
    }


# ---------------------------------------------------------------------
# Two-curve IVC proofs.  Host instances are plain ints in both packages;
# only the witness handles change form: int lists on either package's
# "native" engine, JAX (n, 17) limb arrays or the port's (n, 8) Montgomery
# tensors on the device planes.  The primary's witnesses are over Fq, the
# secondary's over Fp.
# ---------------------------------------------------------------------

_IVC_WITNESSES = {"r_W_primary": "Fq", "r_E_primary": "Fq", "r_W_secondary": "Fp",
                  "r_E_secondary": "Fp", "l_w_secondary": "Fp"}


def _witness_ints(field_name: str, w) -> list[int]:
    """A JAX witness handle (int list, or limb array) -> canonical ints."""
    if isinstance(w, (list, tuple)):
        return [int(v) for v in w]
    return jax_limbs_to_ints(field_name, np.asarray(w))


def ivc_proof_from_jax(proof, device=None, engine: str = "device"):
    """A JAX ``IVCProof`` (read through its attributes) -> the port's: host
    instances copied as ints; each witness handle as the port's ``engine``
    holds it, Montgomery tensors on ``device`` (None: the card) or, with
    ``engine="native"``, int lists."""
    from .nova.ivc import ENGINES, HostInstance, HostRelaxedInstance, IVCProof

    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")

    def relaxed(U):
        return HostRelaxedInstance(U.comm_w and tuple(map(int, U.comm_w)),
                                   U.comm_e and tuple(map(int, U.comm_e)),
                                   [int(v) for v in U.X], int(U.u))

    def witness(name):
        vals = _witness_ints(_IVC_WITNESSES[name], getattr(proof, name))
        return vals if engine == "native" else get_field(_IVC_WITNESSES[name]).encode(vals, device)

    u = proof.l_u_secondary
    return IVCProof(
        int(proof.i), [int(v) for v in proof.z0], [int(v) for v in proof.z_i],
        relaxed(proof.r_U_primary), witness("r_W_primary"), witness("r_E_primary"),
        relaxed(proof.r_U_secondary), witness("r_W_secondary"), witness("r_E_secondary"),
        HostInstance(u.comm_w and tuple(map(int, u.comm_w)), [int(v) for v in u.X]),
        witness("l_w_secondary"))


def ivc_proof_to_jax(proof, engine: str = "native") -> dict:
    """The port's ``IVCProof`` -> a dict of the JAX ``IVCProof``'s fields,
    instances as dicts of its ``HostInstance``/``HostRelaxedInstance``
    fields, for the caller to wrap; witness handles as int lists for the
    JAX package's ``"native"`` engine or, with ``engine="device"``, as its
    (n, 17) uint32 Montgomery limb arrays."""
    from .nova.ivc import CanonicalWitness

    def witness(name):
        w = getattr(proof, name)
        field_name = _IVC_WITNESSES[name]
        if isinstance(w, CanonicalWitness):
            raise ValueError(f"{name} is a deferred CanonicalWitness: take proof() first")
        vals = [int(v) for v in w] if isinstance(w, list) else get_field(field_name).decode(w)
        return vals if engine == "native" else ints_to_jax_limbs(field_name, vals)

    out = {"i": proof.i, "z0": list(proof.z0), "z_i": list(proof.z_i)}
    for name in ("r_U_primary", "r_U_secondary", "l_u_secondary"):
        U = getattr(proof, name)
        out[name] = {k: (list(v) if k == "X" else v) for k, v in vars(U).items()}
    for name in _IVC_WITNESSES:
        out[name] = witness(name)
    return out
