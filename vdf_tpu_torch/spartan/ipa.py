"""Inner-product argument (Bulletproofs-style) over the Pasta curves (port
of ``vdf_tpu.spartan.ipa``).

Spartan's polynomial-commitment opening (nova-snark's
``spartan_with_ipa_pc``): proves <a, b> = v for a Pedersen-committed
vector a and a public b in log2(n) rounds, with the transcript of the JAX
package (``absorb_point`` framing, 128-bit challenges; spartan/host.py).

Every point sum is one commit against the key with h appended
(``CommitmentKey.with_h``: K3, sort, K4-K6 on the K7 table) or one
variable-base ``msm`` (K3 window rows, K4-K6, K9); no vector of points is
folded.  The JAX package folds the generators every round,
g' = x^-1 g_lo + x g_hi, a double-and-add over n/2 points each; here the
prover keeps instead the weights w of the original generators: round j's
folded generators are G(j)_i = sum over k = i mod n_j of w_k G_k, with w_k
the product over rounds l < j of x_l if bit (log n - 1 - l) of k is set,
else x_l^-1 (the verifier's s vector, built round by round).  So

    L = <a_lo, G(j)_hi> + c_l h = <sigma_L, G> + c_l h,
    sigma_L[k] = a_lo[(k mod n_j) - n_j/2] w_k where k mod n_j >= n_j/2, else 0,

and R likewise from a_hi over the low halves: the two are one K = 2
commit of (sigma_L ‖ c_l, sigma_R ‖ c_r).  They are the same group
elements as the JAX package's, so the transcript and the proof are the
same (tests/test_torch_spartan.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..curves import Point, msm
from ..fields import NLIMBS, Field
from ..nova.pedersen import CommitmentKey
from ..poseidon.int_poseidon import IntTranscript
from ..utils.profiling import PhaseTimer
from .host import absorb_point_ints, squeeze_challenge_128
from .multilinear import product_table
from .sumcheck import _sum_rows


class IPAProof(NamedTuple):
    ls: tuple  # per-round L commitments: Points of (8,) projective coordinates
    rs: tuple
    a_final: torch.Tensor  # (8,)


def _with_h(ck: CommitmentKey, n: int, vals: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(K, n, 8) scalars and (K, 8) scalars of h -> (K, ck.n + 1, 8): the
    scalars of one commit against ``ck.with_h`` each."""
    out = torch.zeros((vals.shape[0], ck.n + 1, NLIMBS), dtype=vals.dtype, device=vals.device)
    out[:, :n] = vals
    out[:, ck.n] = c
    return out


def ipa_prove(field: Field, ck: CommitmentKey, a: torch.Tensor, b: torch.Tensor,
              tr: IntTranscript, timer: PhaseTimer | None = None) -> IPAProof:
    """a (committed, over ck.gens[:n]) and b: (n, 8), n a power of two <= ck.n.
    ``timer`` (None: no spans) gets four spans a round, "<curve>/ipa.<part>":
    "commit" (c, sigma and the K = 2 commit), "read" (L and R read back as
    affine ints), "transcript" (absorbed, the challenge squeezed, it and its
    inverse encoded) and "fold" (a, b and the weights folded)."""
    f = field
    timer = timer or PhaseTimer(enabled=False)
    curve = ck.curve.params.name
    span = lambda part: timer.phase(f"{curve}/ipa.{part}")  # noqa: E731
    n = a.shape[0]
    if n & (n - 1) or n > ck.n:
        raise ValueError(f"the inner-product argument needs a power-of-two length <= {ck.n}, "
                         f"got {n}")
    q = f.params.modulus
    w = f.const_like(a, 1)
    ls, rs = [], []
    nj = n
    while nj > 1:
        half = nj // 2
        a_lo, a_hi, b_lo, b_hi = a[:half], a[half:], b[:half], b[half:]
        with span("commit"):
            c = _sum_rows(f, f.mul(torch.stack([a_lo, a_hi]), torch.stack([b_hi, b_lo])), dim=1)
            zero = torch.zeros_like(a_lo)
            pattern = torch.stack([torch.cat([zero, a_lo]), torch.cat([a_hi, zero])])  # (2, nj, 8)
            sigma = f.mul(w.reshape(1, n // nj, nj, NLIMBS), pattern[:, None]).reshape(2, n, NLIMBS)
            pts = ck.with_h.commit_batch(_with_h(ck, n, sigma, c))
        with span("read"):
            l_aff, r_aff = ck.curve.to_affine_ints(pts)
        with span("transcript"):
            absorb_point_ints(tr, l_aff)
            absorb_point_ints(tr, r_aff)
            ls.append(Point(*(v[0] for v in pts)))
            rs.append(Point(*(v[1] for v in pts)))
            x = squeeze_challenge_128(tr)
            # x == 0 has probability 2^-128; let it raise
            xs = f.encode([x, pow(x, -1, q)], a.device)
        with span("fold"):
            # a' = a_lo x + a_hi x^-1, b' = b_lo x^-1 + b_hi x, one batched product.
            prod = f.mul(torch.stack([a_lo, a_hi, b_lo, b_hi]), xs[[0, 1, 1, 0]][:, None])
            a, b = f.add(prod[0::2], prod[1::2]).unbind(0)
            # w_k takes x where the top bit of k mod nj is set, else x^-1.
            w = f.mul(w.reshape(n // nj, 2, half, NLIMBS),
                      xs[[1, 0]][None, :, None]).reshape(n, NLIMBS)
        nj = half
    return IPAProof(tuple(ls), tuple(rs), a[0])


def ipa_verify(field: Field, ck: CommitmentKey, comm: tuple | None, b: torch.Tensor,
               value: int, proof: IPAProof, tr: IntTranscript) -> bool:
    """Check <a, b> = value for the a that ``comm`` (affine ints, None for
    the identity) commits over ck.gens[:n]: with s the challenges' product
    vector, whether

        comm + sum_j (x_j^2 L_j + x_j^-2 R_j) == <a_final s, G> + (a_final <s, b> - v) h,

    the left side one ``msm`` over [comm, L_0 .., R_0 ..], the right one
    commit against ``ck.with_h``, compared in affine."""
    f = field
    n, rounds = b.shape[0], len(proof.ls)
    if n != 1 << rounds or len(proof.rs) != rounds or n > ck.n:
        return False
    curve = ck.curve
    affs = curve.to_affine_ints(Point(*(torch.stack(c) for c in zip(*proof.ls, *proof.rs)))) \
        if rounds else []
    xs = []
    for j in range(rounds):
        absorb_point_ints(tr, affs[j])
        absorb_point_ints(tr, affs[rounds + j])
        xs.append(squeeze_challenge_128(tr))
    if any(x == 0 for x in xs):
        return False  # an untrusted proof fails closed
    q = f.params.modulus
    xinvs = [pow(x, -1, q) for x in xs]
    dev = b.device
    enc = f.encode([*xinvs, *xs, value], dev)
    s = product_table(f, enc[:rounds], enc[rounds : 2 * rounds])
    a_fin = proof.a_final
    c = f.sub(f.mul(a_fin, _sum_rows(f, f.mul(s, b))), enc[-1])
    rhs = ck.with_h.commit(_with_h(ck, n, f.mul(s, a_fin.expand_as(s))[None], c[None])[0])
    pts = curve.from_affine_ints([comm, *affs], dev)
    scalars = f.encode([1, *(x * x % q for x in xs), *(x * x % q for x in xinvs)], dev)
    lhs = msm(curve, pts, scalars)
    left, right = curve.to_affine_ints(Point(*(torch.stack(v) for v in zip(lhs, rhs))))
    return left == right
