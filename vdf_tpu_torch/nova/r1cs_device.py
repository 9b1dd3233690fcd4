"""Device-side R1CS: sparse matrices as tensors + batched matvec (port of
``vdf_tpu.nova.r1cs_device``).

The prover's linear algebra: Az, Bz, Cz as gather -> field product ->
row sums over COO entries.  Plain tensor code; the JAX package computes it
outside any Pallas kernel too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..fields import NLIMBS, Field
from ..fields.ops import from_digits, to_digits
from ..r1cs.cs import R1CSShape

MAX_ROW_NNZ = 1 << 15  # entries a row the lazy row sum is sized for (its bound is 2^30)


@dataclasses.dataclass
class DeviceMatrix:
    rows: torch.Tensor  # (nnz,) int64
    cols: torch.Tensor  # (nnz,) int64
    vals: torch.Tensor  # (nnz, 8) Montgomery-encoded coefficients
    num_rows: int

    def matvec(self, field: Field, z: torch.Tensor) -> torch.Tensor:
        """M @ z over the field; z: (num_vars, 8) -> (num_rows, 8).

        The products are canonical (< p); a row's sum is accumulated digit by
        digit in int64 (``index_add_`` on integers is exact whatever the
        order, so the result is the same on every device) and reduced once.
        The Pasta primes leave no room for a lazy 256-bit sum (4p > 2^256), so
        ``reduce_wide16`` folds the bits above 2^256 back through R^2."""
        prods = field.mul16(to_digits(self.vals), to_digits(z[self.cols]))
        acc = torch.zeros((self.num_rows, prods.shape[-1]), dtype=torch.int64, device=z.device)
        acc.index_add_(0, self.rows, prods)
        return from_digits(field.reduce_wide16(acc))


@dataclasses.dataclass
class DeviceShape:
    shape: R1CSShape
    a: DeviceMatrix
    b: DeviceMatrix
    c: DeviceMatrix

    @classmethod
    def build(cls, field: Field, shape: R1CSShape, device=None) -> "DeviceShape":
        device = resolve_device(device)

        def mk(coo):
            rows, cols, coeffs = coo
            if len(rows) and int(np.bincount(np.asarray(rows)).max()) > MAX_ROW_NNZ:
                raise ValueError(f"a row has more than {MAX_ROW_NNZ} entries")
            vals = (field.encode([int(c) for c in coeffs], device) if len(coeffs)
                    else torch.zeros((0, NLIMBS), dtype=torch.int32, device=device))
            idx = [torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device) for a in (rows, cols)]
            return DeviceMatrix(idx[0], idx[1], vals, shape.num_cons)

        return cls(shape, mk(shape.a_coo), mk(shape.b_coo), mk(shape.c_coo))

    def z_vector(self, field: Field, w: torch.Tensor, x: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
        """z = (W, u, X) per Nova's layout."""
        return torch.cat([w, u[None], x], dim=0)

    def check_relaxed_dev(self, field: Field, w, e, x, u) -> torch.Tensor:
        """Az ∘ Bz == u·Cz + E; returns a bool tensor on the device."""
        z = self.z_vector(field, w, x, u)
        az = self.a.matvec(field, z)
        bz = self.b.matvec(field, z)
        cz = self.c.matvec(field, z)
        lhs = field.mul(az, bz)
        rhs = field.add(field.mul(u.expand_as(cz), cz), e)
        return field.eq(lhs, rhs).all()

    def check_relaxed(self, field: Field, w, e, x, u) -> bool:
        return bool(self.check_relaxed_dev(field, w, e, x, u))

    def cross_term(self, field: Field, z1, u1, z2, u2) -> torch.Tensor:
        """NIFS cross term: T = Az1∘Bz2 + Az2∘Bz1 − u1·Cz2 − u2·Cz1."""
        az1, bz1, cz1 = (m.matvec(field, z1) for m in (self.a, self.b, self.c))
        az2, bz2, cz2 = (m.matvec(field, z2) for m in (self.a, self.b, self.c))
        t = field.add(field.mul(az1, bz2), field.mul(az2, bz1))
        t = field.sub(t, field.mul(u1.expand_as(cz2), cz2))
        t = field.sub(t, field.mul(u2.expand_as(cz1), cz1))
        return t
