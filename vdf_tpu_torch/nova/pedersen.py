"""Pedersen vector commitments over the Pasta curves (Nova's PCS base).

Port of ``vdf_tpu.nova.pedersen``: fixed hash-derived generators (no
known discrete logs, the same points as the JAX package), commitments
through the fixed-base bucket pipeline (curves/bucket_msm.py, kernels
K3-K7).  Keys are cached per (curve, n, label, device).

Putting a key on a device costs two parts, reported apart by
chip_smoke.py: deriving the generators on the host (try-and-increment
with a Tonelli–Shanks root a point, ``derive_generators``), and the K7
pre-shifted table (``CommitmentKey.table``, built at first commit).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..curves import Curve, Point, get_curve, hash_to_curve_ints
from ..curves.bucket_msm import commit_table
from ..curves.kernels import canon_mont, shift_gens
from ..curves.point import stack_point, unstack_point
from ..fields import NLIMBS

DEFAULT_LABEL = b"vdf_tpu/ck"  # the JAX package's commitment_key label


@dataclasses.dataclass(eq=False)
class CommitmentKey:
    curve: Curve
    gens: Point  # (n,) points, Montgomery, z = 1
    h: Point  # blinding generator (single point)

    @property
    def n(self) -> int:
        return self.gens.x.shape[0]

    @functools.cached_property
    def table(self) -> torch.Tensor:
        """(W n, 3, 8): item w n + i = 2^(12 w) G_i (kernel K7)."""
        return shift_gens(self.curve.params.base_field, stack_point(self.gens).contiguous())

    def _padded(self, values: torch.Tensor) -> torch.Tensor:
        m = values.shape[-2]
        if m > self.n:
            raise ValueError(f"{m} values for a key of {self.n} generators")
        pad = torch.zeros((*values.shape[:-2], self.n - m, NLIMBS), dtype=values.dtype,
                          device=values.device)
        return torch.cat([values, pad], dim=-2)  # zero scalars add the identity

    def commit(self, values: torch.Tensor, blind: torch.Tensor | None = None) -> Point:
        """values: (m, 8) Montgomery scalars, m <= n, zero-padded to n -> one
        point.  ``blind=None`` commits deterministically (Nova folds use
        zero blinds); a blind (8,) adds h * blind, a plain double-and-add."""
        out = unstack_point(commit_table(self.curve.params.name, self.table,
                                         self._padded(values)[None])[0])
        if blind is None:
            return out
        hb = self.curve.scalar_mul_bits(Point(*(v[None] for v in self.h)),
                                        scalar_bits(self.curve, blind)[:, None])
        total = self.curve.add(Point(*(v[None] for v in out)), hb)
        return Point(*(v[0] for v in total))

    def commit_batch(self, values: torch.Tensor) -> Point:
        """K commits of (K, m, 8) scalars in one pass (the fused fold's
        strict witness and cross term); a Point with (K, 8) coordinates."""
        return unstack_point(commit_table(self.curve.params.name, self.table,
                                          self._padded(values)))


def scalar_bits(curve: Curve, s: torch.Tensor) -> torch.Tensor:
    """(8,) Montgomery scalar -> (256,) little-endian bits of its canonical
    value."""
    words = curve.scalar.from_mont(s.reshape(1, NLIMBS))[0].to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, device=s.device)
    return ((words[:, None] >> shifts) & 1).reshape(-1)


@functools.lru_cache(maxsize=16)
def derive_generators(curve_name: str, n: int, label: bytes = DEFAULT_LABEL):
    """The n + 1 affine generator ints of a key (host, exact)."""
    return tuple(hash_to_curve_ints(curve_name, n + 1, domain=label))


def _limbs_of(values) -> torch.Tensor:
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    return torch.from_numpy(np.frombuffer(buf, dtype="<u4").view(np.int32).copy())


@functools.lru_cache(maxsize=16)
def _key(curve_name: str, n: int, label: bytes, device: str) -> CommitmentKey:
    curve = get_curve(curve_name)
    pts = derive_generators(curve_name, n, label)
    coords = _limbs_of([c for pt in pts for c in pt]).reshape(-1, NLIMBS).to(device)
    # K3 in its domain mode puts the canonical coordinates into Montgomery form.
    xy = canon_mont(curve.params.base_field, coords).reshape(n + 1, 2, NLIMBS)
    one = curve.field.one(device).expand(n + 1, NLIMBS)
    pts_m = Point(xy[:, 0].contiguous(), xy[:, 1].contiguous(), one.contiguous())
    gens = Point(*(v[:n] for v in pts_m))
    h = Point(*(v[n] for v in pts_m))
    return CommitmentKey(curve, gens, h)


def commitment_key(curve_name: str, n: int, label: bytes = DEFAULT_LABEL,
                   device="cpu") -> CommitmentKey:
    """The key of n hash-derived generators and a blinding generator, on
    ``device`` (cached; ``CommitmentKey.table`` is built at first use)."""
    return _key(curve_name, n, label, str(torch.device(device)))
