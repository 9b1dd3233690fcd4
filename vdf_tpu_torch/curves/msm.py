"""Variable-base multi-scalar multiplication: sum_i s_i P_i.

Port of ``vdf_tpu/curves/msm.py::msm`` and of the kernel pipeline behind
it, ``vdf_tpu/curves/pallas_msm.py::msm_pallas``.  A scalar is 22 windows
of 12 bits, and each window is one batch row of the bucket accumulation
over the n unshifted points:

  1. K3 (``canon_digits``, window rows): Montgomery scalars -> canonical ->
     keys (22, m_pad), row w holding the key of (digit_w(s_i), item i):
     int32 up to n = 2^20 (the JAX package's uint32 key ``digit << 20 | i``
     in offset binary), int64 ``digit << 32 | i`` beyond;
  2. ``torch.sort`` along each row;
  3. K4 (``bucket_scan``) with the points as the table: run sums down
     ``cols = ceil(n / ROWS)`` columns of ``ROWS`` sorted items a window;
  4. K5 (``column_carries``): the carry into each column;
  5. K6 (``bucket_sums``): S_w = sum_b b B_b, one point a window;
  6. K9 (``horner``): sum_w 2^(12 w) S_w.

Every step is a kernel launch or a torch op on the scalars' device; an MSM
does not synchronise with the host.

One evaluator serves every n >= 1 and every input the complete formulas
take (identity points, repeated points, P and -P, zero scalars).  The JAX
package switches between three (bit planes below 256 points, an XLA
Pippenger, the Pallas pipeline from 1,024 points on a TPU), runs the
windows in groups and limits n by its uint32 sort keys.  Those answer
XLA's dispatch cost and the TPU's memory and do not carry over: here all
22 windows run in one pass (at n = 2^20 the keys take 92 MB, the column
summaries 100 MB, the carries as much, and K5's and K6's scratch 13 MB and
26 MB), and past 2^20 points the keys are int64.
"""

from __future__ import annotations

import torch

from .bucket_msm import ROWS
from .kernels import bucket_scan, bucket_sums, canon_digits, column_carries, horner
from .point import Curve, Point, stack_point, unstack_point


def msm_layout(n: int) -> tuple[int, int]:
    """(cols, m_pad) of one window row over n points: m_pad = cols * ROWS >= n."""
    cols = -(-n // ROWS)
    return cols, cols * ROWS


def window_sums(curve: Curve, points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """points (n, 3, 8), scalars (n, 8) -> (22, 3, 8): S_w = sum_i digit_w(s_i) P_i."""
    bf = curve.params.base_field
    _, m_pad = msm_layout(points.shape[0])
    keys = canon_digits(curve.params.scalar_field, scalars[None], m_pad, window_rows=True)[0]
    keys = torch.sort(keys, dim=-1).values
    tails, tail_col, col_sums, col_flags = bucket_scan(bf, points, keys, ROWS)
    carries = column_carries(bf, col_sums, col_flags)
    return bucket_sums(bf, tails, tail_col, carries)


def msm(curve: Curve, points: Point, scalars: torch.Tensor) -> Point:
    """sum_i scalars[i] * points[i]: ``points`` a Point of (n, 8) canonical
    Montgomery coordinates over the curve's base field, ``scalars`` (n, 8)
    Montgomery over its scalar field, n >= 1, on one device.  Returns one
    projective point ((8,) coordinates)."""
    pts = stack_point(points).contiguous()
    if pts.dim() != 3 or pts.shape[0] < 1 or scalars.shape != (pts.shape[0], pts.shape[-1]):
        raise ValueError(
            f"msm needs (n, 8) point coordinates and (n, 8) scalars with n >= 1, got "
            f"{tuple(points.x.shape)} and {tuple(scalars.shape)}"
        )
    sums = window_sums(curve, pts, scalars.contiguous())
    return unstack_point(horner(curve.params.base_field, sums[None])[0])
