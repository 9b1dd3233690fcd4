"""Fixed-base Pedersen commit: the bucket accumulation around K3-K7.

Port of the fixed-base half of ``vdf_tpu/curves/pallas_msm.py``
(``_shifted_gens12``, ``_bucket_accumulate``, ``commit_pallas``,
``commit_pallas_batch_traceable``; the XLA glue "K8").  With the
pre-shifted table ``T[w n + i] = 2^(12 w) G_i`` (K7), a commit of n
scalars is ONE bucket accumulation over W n items, item ``w n + i``
weighted by digit w of scalar i:

  1. K3 (``canon_digits``): Montgomery scalars -> canonical -> window
     digits, as sort keys of (digit, item): int32, the JAX package's key
     ``digit << 20 | item`` in offset binary, while the W n items fit 20
     bits (n <= 47,662), int64 ``digit << 32 | item`` beyond
     (``curves.kernels.key_width``);
  2. ``torch.sort`` of each batch row's keys;
  3. K4 (``bucket_scan``): run sums down ``cols`` columns of ``rows``
     sorted items, run tails written straight to their buckets;
  4. K5 (``column_carries``): the carry into each column;
  5. K6 (``bucket_sums``): bucket = tail + carry, then sum_b b B_b.

Every step is a kernel launch or a torch op on the scalars' device: a
commit does not synchronise with the host.  Past 2^20 items the keys are
int64, so the JAX package's uint32 key-size limit does not apply.  A batch row is its
own bucket set, so the K = 2 form (``commit_fixed_batch``) commits a
strict witness and a cross term in one pass, as nova/ivc.py's fused fold
does.
"""

from __future__ import annotations

import torch

from ..fields import NLIMBS, get_field
from .kernels import (
    WINDOWS,
    bucket_scan,
    bucket_sums,
    canon_digits,
    column_carries,
    key_digit,
)
from .point import CURVES, Point, unstack_point

# K4's column height.  cols = ceil(W n / ROWS) threads a batch row walk
# ROWS items each; K5 scans the cols column summaries in tiles (depth 15
# adds up to 16,384 columns, which n = 2^14 gives with 22: one block of 128
# threads an SM in K4).  See PERF.md for the readings at 11, 16 and 22.
ROWS = 22


def layout(n: int, rows: int = ROWS) -> tuple[int, int]:
    """(cols, m_pad) for a commit of n scalars: m_pad = cols * rows >= W n."""
    cols = -(-WINDOWS * n // rows)
    return cols, cols * rows


def digits_of_scalars(curve_name: str, scalars: torch.Tensor) -> torch.Tensor:
    """(…, n, 8) Montgomery scalars -> (…, n, W) window digits (int64):
    digit w of a scalar is bits [12 w, 12 w + 12) of its canonical value."""
    s = scalars.reshape(-1, *scalars.shape[-2:]).contiguous()
    k, n = s.shape[:2]
    keys = canon_digits(CURVES[curve_name].scalar_field, s, WINDOWS * n)
    digits = key_digit(keys).reshape(k, WINDOWS, n).transpose(1, 2)
    return digits.reshape(*scalars.shape[:-1], WINDOWS)


def commit_table(curve_name: str, table: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """K fixed-base commits against one pre-shifted table: scalars
    (K, n, 8) Montgomery over the curve's scalar field, table (W n, 3, 8)
    -> (K, 3, 8) projective Montgomery points, sum_b b B_b a row."""
    params = CURVES[curve_name]
    if scalars.dim() != 3 or table.shape[0] != WINDOWS * scalars.shape[1]:
        raise ValueError(
            f"scalars (K, n, 8) need a table of W n = {WINDOWS} n rows, got "
            f"{tuple(scalars.shape)} and {tuple(table.shape)}"
        )
    bf = params.base_field
    _, m_pad = layout(scalars.shape[1])
    keys = canon_digits(params.scalar_field, scalars.contiguous(), m_pad)
    keys = torch.sort(keys, dim=-1).values
    tails, tail_col, col_sums, col_flags = bucket_scan(bf, table, keys, ROWS)
    carries = column_carries(bf, col_sums, col_flags)
    return bucket_sums(bf, tails, tail_col, carries)


def shifted_gens(curve_name: str, n: int, device=None) -> torch.Tensor:
    """The (W n, 3, 8) table of ``commitment_key(curve_name, n)`` (K7,
    cached with the key)."""
    from ..nova.pedersen import commitment_key

    return commitment_key(curve_name, n, device=device).table


def commit_fixed_batch(curve_name: str, scalars: torch.Tensor) -> Point:
    """K commits of (K, n, 8) scalars against ``commitment_key(curve, n)``
    in one pass; a Point with (K, 8) coordinates."""
    table = shifted_gens(curve_name, scalars.shape[1], scalars.device)
    return unstack_point(commit_table(curve_name, table, scalars))


def commit_fixed(curve_name: str, scalars: torch.Tensor):
    """Pedersen commit of (n, 8) Montgomery scalars against the cached
    hash-derived key (the generators of ``commitment_key(curve, n)``).

    Returns (projective Point in Montgomery form, canonical (3, 8) integer
    limbs of X, Y, Z), as ``commit_pallas`` does."""
    table = shifted_gens(curve_name, scalars.shape[0], scalars.device)
    out = commit_table(curve_name, table, scalars[None])[0]
    canon = get_field(CURVES[curve_name].base_field).from_mont(out)
    return unstack_point(out), canon.reshape(3, NLIMBS)
