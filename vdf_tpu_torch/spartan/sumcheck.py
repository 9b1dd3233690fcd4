"""The sumcheck protocol, prover and verifier, on tensors (port of
``vdf_tpu.spartan.sumcheck``).

A round binds the first variable of every table: the prover evaluates the
round's univariate at 0..degree from the tables' lo and hi halves, all
tables and all points in one batch of field ops, and folds the tables at
the challenge.  The Fiat–Shamir transcript is the host's ``IntTranscript``
(the control plane, as in nova/ivc.py): a round reads its degree + 1
values from the device once and sends its challenge back once.  The JAX
package caches one jitted evaluation and one fold a round size; eager
torch needs no such cache.
"""

from __future__ import annotations

import functools

import torch

from ..fields import NLIMBS, Field
from ..fields.kernels import MAX_SEGMENT, field_segsum
from ..poseidon.int_poseidon import IntTranscript

MAX_SUM_ROWS = MAX_SEGMENT  # K11 (and reduce_wide16) take sums of up to 2^30 values


def _sum_rows(field: Field, arr: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Exact field sum of canonical elements over axis ``dim``: the other
    axes' elements are equal segments of one K11 launch (on the CPU its
    plain version: 16-bit digit sums in int64, then one reduction)."""
    if arr.shape[dim] > MAX_SUM_ROWS:
        raise ValueError(f"a sum of {arr.shape[dim]} elements exceeds {MAX_SUM_ROWS}")
    moved = arr.movedim(dim, -2)
    lead = moved.shape[:-2]
    segments = 1
    for k in lead:
        segments *= k
    out = field_segsum(field.params.name, moved.reshape(-1, NLIMBS), segments=segments)
    return out.reshape(*lead, NLIMBS)


@functools.cache
def _lagrange_denominators(degree: int, modulus: int) -> tuple:
    """1 / prod_{j != k} (k - j) mod p for nodes 0..degree."""
    inv = []
    for k in range(degree + 1):
        d = 1
        for j in range(degree + 1):
            if j != k:
                d = d * (k - j) % modulus
        inv.append(pow(d, -1, modulus))
    return tuple(inv)


def eval_univariate(field: Field, evals: list[torch.Tensor], r: torch.Tensor) -> torch.Tensor:
    """The degree-d univariate with values ``evals`` at 0..d, at r; batched
    over the leading axes of r and of each value.  Term k starts as
    evals[k] / prod_{j != k} (k - j) and takes the factor (r - j) for each
    j != k: d + 1 batched products in all."""
    f = field
    d = len(evals) - 1
    shape = torch.broadcast_shapes(r.shape, *(e.shape for e in evals))
    nodes = f.encode(list(range(d + 1)), r.device).reshape(d + 1, *(1,) * (len(shape) - 1), -1)
    factors = f.sub(r.expand(shape)[None], nodes)  # (d + 1, ...): r - j
    denoms = f.encode(list(_lagrange_denominators(d, f.params.modulus)), r.device)
    terms = f.mul(torch.stack([e.expand(shape) for e in evals]),
                  denoms.reshape(d + 1, *(1,) * (len(shape) - 1), -1))
    one = f.const_like(factors[0], 1)
    for j in range(d + 1):
        # Every term but the j-th takes the factor (r - j).
        fj = torch.stack([one if k == j else factors[j] for k in range(d + 1)])
        terms = f.mul(terms, fj)
    return _sum_rows(f, terms)


# Combinations a round sums over its bound tables, by name.
_COMBS: dict = {}


def register_comb(name: str):
    def deco(fn):
        _COMBS[name] = fn
        return fn

    return deco


@register_comb("product")
def _comb_product(f: Field, m, z):
    return f.mul(m, z)


@register_comb("spartan_outer")
def _comb_spartan_outer(f: Field, eqv, a, b, c, ev, u):
    """eq · (a b - (u c + e)): a b and u c as one batched product."""
    ab, uc = f.mul(torch.stack([a, u.expand_as(c)]), torch.stack([b, c])).unbind(0)
    return f.mul(eqv, f.sub(ab, f.add(uc, ev)))


def _round(field: Field, polys: torch.Tensor, degree: int, comb, aux: tuple):
    """polys (k, n, 8) -> (the round's values at 0..degree (d + 1, 8), the
    halves' difference hi - lo (k, n / 2, 8)).  Point t >= 2 binds to
    hi + (t - 1) (hi - lo), one batched addition a point."""
    f = field
    half = polys.shape[1] // 2
    lo, hi = polys[:, :half], polys[:, half:]
    diff = f.sub(hi, lo)
    bound = [lo, hi]
    for _ in range(2, degree + 1):
        bound.append(f.add(bound[-1], diff))
    vals = comb(f, *torch.stack(bound).unbind(1), *aux)  # (d + 1, n / 2, 8)
    return _sum_rows(f, vals, dim=1), diff


def sumcheck_prove(field: Field, tr: IntTranscript, polys: list[torch.Tensor], degree: int,
                   comb_key: str, aux: tuple = ()):
    """Prove the sum over the hypercube of comb(p_1(x), ..., p_k(x), *aux):
    ``polys`` k tables of 2^m rows on one device.  Returns (rs, finals,
    messages): the m challenges as ints, the tables bound at them (k, 8),
    and each round's degree + 1 values as a tuple of (8,) tensors."""
    f = field
    comb = _COMBS[comb_key]
    p = torch.stack(list(polys))
    n = p.shape[1]
    if n & (n - 1):
        raise ValueError(f"sumcheck tables need a power-of-two length, got {n}")
    rs, messages = [], []
    for _ in range((n - 1).bit_length()):
        evals, diff = _round(f, p, degree, comb, aux)
        tr.absorb(*f.decode(evals))
        messages.append(tuple(evals.unbind(0)))
        r = tr.squeeze()
        rs.append(r)
        p = f.fold(p[:, : diff.shape[1]], f.encode(r, p.device), diff)
    return rs, p[:, 0], messages


def sumcheck_verify(field: Field, tr: IntTranscript, messages, claim: torch.Tensor,
                    degree: int):
    """Replay the rounds: one read of every message, the transcript on the
    host, then every round's check and evaluation as one batch.  Returns
    (rs ints, the final claim (8,), ok: a bool tensor on the device); the
    caller checks the final claim against the tables' values at rs.

    There must be a message, and each must carry exactly ``degree + 1``
    values: longer ones would raise the degree unseen, shorter ones would
    not evaluate."""
    f = field
    if not messages or any(len(evals) != degree + 1 for evals in messages):
        return [], claim, torch.zeros((), dtype=torch.bool, device=claim.device)
    evals = torch.stack([torch.stack(list(m)) for m in messages])  # (rounds, d + 1, 8)
    ints = f.decode(evals.reshape(-1, evals.shape[-1]))
    rs = []
    for j in range(len(messages)):
        tr.absorb(*ints[j * (degree + 1) : (j + 1) * (degree + 1)])
        rs.append(tr.squeeze())
    at_r = eval_univariate(f, list(evals.unbind(1)), f.encode(rs, evals.device))
    claims = torch.cat([claim[None], at_r[:-1]])  # round j's g(0) + g(1) must equal these
    ok = f.eq(f.add(evals[:, 0], evals[:, 1]), claims).all()
    return rs, at_r[-1], ok
