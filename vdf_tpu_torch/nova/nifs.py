"""NIFS: non-interactive folding scheme for relaxed R1CS (Nova's core; port
of ``vdf_tpu.nova.nifs``).

A running *relaxed* instance (comm_W, comm_E, X, u) absorbs a fresh plain
instance via one cross-term commitment and one Poseidon-derived 128-bit
challenge.

Cross-field hashing: commitments live on Pallas (coordinates in Fp) while
the primary transcript runs over Fq, so each affine coordinate is absorbed
as two 128-bit halves (limbs 0-3 and 4-7 of its canonical value) — an
injective, canonical embedding — plus an identity flag.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..curves import Curve, Point
from ..device import resolve_device
from ..fields import NLIMBS, Field
from ..poseidon import Transcript
from .pedersen import CommitmentKey
from .r1cs_device import DeviceShape

HALF = NLIMBS // 2  # limbs of a 128-bit half
CHALLENGE_BITS = 128


class R1CSInstance(NamedTuple):
    """Plain R1CS instance."""

    comm_w: Point
    x: torch.Tensor  # (n_io, 8)


class RelaxedInstance(NamedTuple):
    comm_w: Point
    comm_e: Point
    x: torch.Tensor
    u: torch.Tensor  # (8,)

    @classmethod
    def default(cls, curve: Curve, field: Field, n_io: int, device=None) -> "RelaxedInstance":
        device = resolve_device(device)
        zero = torch.zeros((n_io, NLIMBS), dtype=torch.int32, device=device)
        return cls(curve.identity((), device), curve.identity((), device), zero,
                   torch.zeros(NLIMBS, dtype=torch.int32, device=device))


class RelaxedWitness(NamedTuple):
    w: torch.Tensor  # (n_aux, 8)
    e: torch.Tensor  # (num_cons, 8)

    @classmethod
    def default(cls, field: Field, n_aux: int, n_cons: int, device=None) -> "RelaxedWitness":
        device = resolve_device(device)
        return cls(torch.zeros((n_aux, NLIMBS), dtype=torch.int32, device=device),
                   torch.zeros((n_cons, NLIMBS), dtype=torch.int32, device=device))


# ---------------------------------------------------------------------
# transcript helpers
# ---------------------------------------------------------------------


def absorb_point(tr: Transcript, field: Field, curve: Curve, p: Point) -> None:
    """Absorb a point canonically: affine coordinates split into 128-bit
    chunks of the transcript field, plus an identity flag.  The identity has
    z = 0, whose "inverse" is 0, so its chunks are all zero."""
    f_base = curve.field
    coords = torch.stack([p.x, p.y])
    zinv = f_base.inv(p.z)
    canon = f_base.from_mont(f_base.mul(coords, zinv.expand_as(coords)))  # (2, 8) integers
    halves = torch.zeros((5, NLIMBS), dtype=torch.int32, device=canon.device)
    halves[0, :HALF], halves[1, :HALF] = canon[0, :HALF], canon[0, HALF:]
    halves[2, :HALF], halves[3, :HALF] = canon[1, :HALF], canon[1, HALF:]
    halves[4, 0] = curve.is_identity(p).to(torch.int32)
    # Integers below 2^128 < p are field elements; into Montgomery form.
    tr.absorb(*field.to_mont(halves).unbind(0))


def absorb_scalars(tr: Transcript, arrs) -> None:
    for a in arrs:
        if a.dim() == 1:
            tr.absorb(a)
        else:
            tr.absorb(*a.unbind(0))


def squeeze_challenge_bits(tr: Transcript, field: Field, n_bits: int = CHALLENGE_BITS):
    """(r_mont, r_bits): the low ``n_bits`` of a squeezed element as a field
    scalar and as a little-endian bit tensor for point scalar-multiplication."""
    canon = field.from_mont(tr.squeeze())
    keep = torch.where(torch.arange(NLIMBS, device=canon.device) < n_bits // 32, canon,
                       torch.zeros_like(canon))
    words = keep[: n_bits // 32].to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, device=canon.device)
    bits = ((words[:, None] >> shifts) & 1).reshape(-1).to(torch.uint8)
    return field.to_mont(keep), bits


# ---------------------------------------------------------------------
# folding
# ---------------------------------------------------------------------


@dataclasses.dataclass
class NIFS:
    """Folding context for one (shape, commitment key, curve) triple."""

    field: Field  # circuit field (= curve scalar field)
    curve: Curve
    shape: DeviceShape
    ck: CommitmentKey

    def fold_instance(self, tr: Transcript, U1: RelaxedInstance, u2: R1CSInstance,
                      comm_t: Point):
        """Derive r and fold (verifier-side work; no witnesses).  Returns
        (folded instance, r in Montgomery form)."""
        f, c = self.field, self.curve
        absorb_point(tr, f, c, U1.comm_w)
        absorb_point(tr, f, c, U1.comm_e)
        absorb_scalars(tr, [U1.x, U1.u])
        absorb_point(tr, f, c, u2.comm_w)
        absorb_scalars(tr, [u2.x])
        absorb_point(tr, f, c, comm_t)
        r_mont, r_bits = squeeze_challenge_bits(tr, f)

        x = f.add(U1.x, f.mul(r_mont.expand_as(u2.x), u2.x))
        u = f.add(U1.u, r_mont)
        # One batched scalar-mul covers both r-scaled points (same r).
        both = Point(*(torch.stack([a, b]) for a, b in zip(u2.comm_w, comm_t)))
        scaled = c.scalar_mul_bits(both, r_bits[:, None].expand(-1, 2))
        folded = c.add(Point(*(torch.stack([a, b]) for a, b in zip(U1.comm_w, U1.comm_e))),
                       scaled)
        comm_w, comm_e = (Point(*(v[k] for v in folded)) for k in range(2))
        return RelaxedInstance(comm_w, comm_e, x, u), r_mont

    def prove(self, tr: Transcript, U1: RelaxedInstance, W1: RelaxedWitness,
              u2: R1CSInstance, w2: torch.Tensor):
        """Prover fold: compute + commit the cross term, then fold both
        instance and witness.  Returns (U', W', comm_T)."""
        f = self.field
        one = f.one(w2.device)
        z1 = self.shape.z_vector(f, W1.w, U1.x, U1.u)
        z2 = self.shape.z_vector(f, w2, u2.x, one)
        t = self.shape.cross_term(f, z1, U1.u, z2, one)
        comm_t = self.ck.commit(t)

        U_new, r_mont = self.fold_instance(tr, U1, u2, comm_t)

        w = f.add(W1.w, f.mul(r_mont.expand_as(w2), w2))
        e = f.add(W1.e, f.mul(r_mont.expand_as(t), t))
        return U_new, RelaxedWitness(w, e), comm_t
