"""Multilinear polynomials for Spartan in dense evaluation form (port of
``vdf_tpu.spartan.multilinear``).

A polynomial over {0,1}^m is its table of 2^m values, an ``(2^m, 8)``
Montgomery tensor (fields/ops.py); index bit m-1 (the most significant) is
the first variable.  Every operation is a handful of batched field ops.
"""

from __future__ import annotations

import torch

from ..fields import Field


def num_vars(n: int) -> int:
    """Variables of the table that holds n values (at least one)."""
    return max(1, (n - 1).bit_length())


def pad_to_pow2(field: Field, arr: torch.Tensor) -> torch.Tensor:
    """Zero-pad the rows of ``arr`` to 2^num_vars(rows) (0 is 0 in Montgomery form)."""
    m = 1 << num_vars(arr.shape[0])
    return torch.nn.functional.pad(arr, (0, 0, 0, m - arr.shape[0]))


def product_table(field: Field, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(m, 8) factors -> the 2^m products prod_j (hi_j if bit m-1-j of the
    index is set, else lo_j), by doubling: each step puts the next factor
    pair on a new top bit, one batched product a step."""
    f = field
    table = f.one(lo.device)[None]
    for j in reversed(range(lo.shape[0])):
        pair = torch.stack([lo[j], hi[j]])[:, None]
        table = f.mul(table[None], pair).reshape(-1, table.shape[-1])
    return table


def eq_table(field: Field, rs) -> torch.Tensor:
    """eq(r, x) for every x in {0,1}^m; ``rs`` an (m, 8) tensor (or a
    non-empty sequence of (8,) elements), rs[0] the first variable (the top
    index bit), as evaluate() and fold_top() bind it."""
    if not isinstance(rs, torch.Tensor):
        rs = torch.stack(list(rs))
    return product_table(field, field.sub(field.const_like(rs, 1), rs), rs)


def evaluate(field: Field, evals: torch.Tensor, rs) -> torch.Tensor:
    """The multilinear extension of ``evals`` at the point ``rs`` (first
    variable first)."""
    cur = evals
    for r in rs:
        cur = fold_top(field, cur, r)
    return cur[0]


def fold_top(field: Field, evals: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Bind the first variable to r: (2^m, 8) -> (2^(m-1), 8), lo + r (hi - lo)."""
    f = field
    half = evals.shape[0] // 2
    lo, hi = evals[:half], evals[half:]
    return f.fold(lo, r, f.sub(hi, lo))
