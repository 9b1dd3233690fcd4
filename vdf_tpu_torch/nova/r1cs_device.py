"""Device-side R1CS: sparse matrices as tensors + batched matvec (port of
``vdf_tpu.nova.r1cs_device``).

The prover's linear algebra: Az, Bz, Cz over COO entries kept in row
order with their CSR row offsets, one K12 launch a matvec on the card
(fields/kernels.py ``r1cs_matvec``: gather, field product, exact row sum),
its plain digit version on the CPU.  The JAX package computes it with XLA
(``segment_sum`` + ``partial_reduce``), outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..device import resolve_device
from ..fields import NLIMBS, Field
from ..fields.kernels import r1cs_matvec
from ..r1cs.cs import R1CSShape

MAX_ROW_NNZ = 1 << 15  # entries a row the lazy row sum is sized for (its bound is 2^30)


def row_offsets(rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """CSR offsets (num_rows + 1,) of row-sorted entries: entry k lies in row
    r iff offsets[r] <= k < offsets[r + 1]."""
    return torch.searchsorted(rows, torch.arange(num_rows + 1, dtype=rows.dtype,
                                                 device=rows.device))


@dataclasses.dataclass
class DeviceMatrix:
    rows: torch.Tensor  # (nnz,) int64, nondecreasing (DeviceShape.build sorts them)
    cols: torch.Tensor  # (nnz,) int64
    vals: torch.Tensor  # (nnz, 8) Montgomery-encoded coefficients
    num_rows: int
    offsets: torch.Tensor | None = None  # (num_rows + 1,) int64; None: from the rows

    def __post_init__(self):
        if self.offsets is None:
            self.offsets = row_offsets(self.rows, self.num_rows)

    def matvec(self, field: Field, z: torch.Tensor) -> torch.Tensor:
        """M @ z over the field; z: (num_vars, 8) -> (num_rows, 8), canonical.

        K12 on the card: a warp a row adds the row's products in 9 limbs
        and reduces once.  The plain version sums the products' 16-bit
        digits by row in int64 (``index_add_`` on integers is exact in any
        order).  The Pasta primes leave no room for a lazy 256-bit sum
        (4p > 2^256), so both fold the bits above 2^256 back through R^2."""
        return r1cs_matvec(field.params.name, self.rows, self.offsets, self.cols, self.vals, z)


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
            # Row order (a stable sort), so K12 reads each row's entries from
            # its CSR offsets; a row sum is exact in any order.
            order = np.argsort(np.asarray(rows, dtype=np.int64), kind="stable")
            vals = (field.encode([int(coeffs[k]) for k in order], device) if len(coeffs)
                    else torch.zeros((0, NLIMBS), dtype=torch.int32, device=device))
            idx = [torch.from_numpy(np.asarray(a, dtype=np.int64)[order]).to(device)
                   for a in (rows, cols)]
            return DeviceMatrix(idx[0], idx[1], vals, shape.num_cons)

        return cls(shape, mk(shape.a_coo), mk(shape.b_coo), mk(shape.c_coo))

    @functools.cached_property
    def entries_by_column(self) -> tuple:
        """A's, B's and C's entries together, sorted by column (stable):
        (matrix index 0, 1, 2; rows; cols; vals), for the gamma-matvec's
        column sums (spartan/snark.py), one K11 segment a column."""
        mats = (self.a, self.b, self.c)
        mat = torch.cat([torch.full_like(m.rows, k) for k, m in enumerate(mats)])
        rows, cols, vals = (torch.cat([getattr(m, k) for m in mats])
                            for k in ("rows", "cols", "vals"))
        order = torch.sort(cols, stable=True).indices
        return mat[order], rows[order], cols[order], vals[order]

    def z_vector(self, field: Field, w: torch.Tensor, x: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
        """z = (W, u, X) per Nova's layout."""
        return torch.cat([w, u[None], x], dim=0)

    def check_relaxed_dev(self, field: Field, w, e, x, u, matvecs=None) -> torch.Tensor:
        """Az ∘ Bz == u·Cz + E; returns a bool tensor on the device.
        ``matvecs`` maps z to (Az, Bz, Cz) (default: this shape's matvecs;
        the IVC passes its mesh-sharded ones under tensor parallelism)."""
        z = self.z_vector(field, w, x, u)
        if matvecs is None:
            az, bz, cz = (m.matvec(field, z) for m in (self.a, self.b, self.c))
        else:
            az, bz, cz = matvecs(z)
        lhs = field.mul(az, bz)
        rhs = field.add(field.mul(u.expand_as(cz), cz), e)
        return field.eq(lhs, rhs).all()

    def check_relaxed(self, field: Field, w, e, x, u, matvecs=None) -> bool:
        return bool(self.check_relaxed_dev(field, w, e, x, u, matvecs))

    def cross_term(self, field: Field, z1, u1, z2, u2) -> torch.Tensor:
        """NIFS cross term: T = Az1∘Bz2 + Az2∘Bz1 − u1·Cz2 − u2·Cz1."""
        az1, bz1, cz1 = (m.matvec(field, z1) for m in (self.a, self.b, self.c))
        az2, bz2, cz2 = (m.matvec(field, z2) for m in (self.a, self.b, self.c))
        t = field.add(field.mul(az1, bz2), field.mul(az2, bz1))
        t = field.sub(t, field.mul(u1.expand_as(cz2), cz2))
        t = field.sub(t, field.mul(u2.expand_as(cz1), cz1))
        return t
