"""Spartan SNARK for relaxed R1CS, the device tier (port of
``vdf_tpu.spartan.snark``; nova-snark's ``spartan_with_ipa_pc``).

Proves knowledge of (W, E) for a relaxed instance (comm_W, comm_E, X, u);
the compressed IVC proof carries two such arguments in place of the two
witness vectors (the Rust reference's src/nova/proof.rs:360-368).

Protocol (standard Spartan, relaxed form):
  1. sumcheck #1 over constraint rows:
         0 = sum_x eq(tau, x) (Az(x) Bz(x) - u Cz(x) - E(x))
     -> point r_x, claims vA, vB, vC, vE.
  2. batch with gamma; sumcheck #2 over columns:
         vA + gamma vB + gamma^2 vC = sum_y M_gamma(r_x, y) z(y)
     -> point r_y; the verifier evaluates M_gamma(r_x, r_y) itself from the
     sparse matrices, and z(r_y) splits into a committed W part (an IPA
     opening) plus the public (u, X) part.
  3. IPA openings: E at eq(r_x), W at the eq(r_y) restriction.

The vectors (matvecs, tables, sumcheck rounds, IPA rounds) live on the
tensors' device and every point sum goes through the commit pipeline or
``msm``; the transcript, the instance and the verifier's scalar checks are
host-side values (spartan/host.py's framing), so a proof equals the host
tier's field by field.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..fields import NLIMBS, Field
from ..fields.kernels import field_segsum
from ..nova.pedersen import CommitmentKey
from ..poseidon.int_poseidon import IntTranscript
from ..utils.profiling import PhaseTimer
from .host import absorb_instance_ints
from .ipa import IPAProof, ipa_prove, ipa_verify
from .multilinear import eq_table, num_vars, pad_to_pow2
from .sumcheck import MAX_SUM_ROWS, _sum_rows, sumcheck_prove, sumcheck_verify


class SpartanProof(NamedTuple):
    sc1_messages: tuple  # rounds of (8,) values at 0..3
    vA: torch.Tensor
    vB: torch.Tensor
    vC: torch.Tensor
    vE: torch.Tensor
    sc2_messages: tuple  # rounds of (8,) values at 0..2
    vW: torch.Tensor
    ipa_e: IPAProof
    ipa_w: IPAProof


@dataclasses.dataclass
class SpartanCtx:
    """What the device tier needs of a relaxed R1CS: its field, commitment
    curve, device matrices (nova/r1cs_device.py) and key (the key's length
    covers the witness and the constraint rows, zero-padded).  A device
    engine's IVC ``Side`` has the same attributes and serves as one."""

    field: Field
    curve_name: str
    dev_shape: object
    ck: CommitmentKey

    @property
    def device(self) -> torch.device:
        return self.ck.gens.x.device


def spartan_transcript(field: Field, digest: int) -> IntTranscript:
    """An argument's transcript: the parameters' digest, absorbed."""
    tr = IntTranscript(field.params.name)
    tr.absorb(digest)
    tr.flush()
    return tr


def _matvec_padded(field: Field, mat, z: torch.Tensor, n_pad: int) -> torch.Tensor:
    out = mat.matvec(field, z)
    return torch.nn.functional.pad(out, (0, 0, 0, n_pad - out.shape[0]))


def _gamma_entries(field: Field, shape, eq_rx: torch.Tensor, gamma: int):
    """Every entry of A, B and C at once, in column order
    (``DeviceShape.entries_by_column``): (cols, v eq_rx[row] gamma^k), with
    k = 0, 1, 2 for A, B, C: eq_rx scaled by the three weights in one batched
    product, then one product an entry."""
    f = field
    mat, rows, cols, vals = shape.entries_by_column
    weights = f.encode([1, gamma, gamma * gamma], eq_rx.device)
    scaled = f.mul(eq_rx[None], weights[:, None]).reshape(-1, NLIMBS)  # (3 n1, 8)
    return cols, f.mul(vals, scaled[mat * eq_rx.shape[0] + rows])


def _gamma_matrix_vector(field: Field, shape, eq_rx: torch.Tensor, gamma: int,
                         n_cols_pad: int) -> torch.Tensor:
    """m(y) = sum_rows (A + gamma B + gamma^2 C)[row, y] eq_rx[row], by column:
    the entries' products in column order, one K11 segment a column (their
    CSR offsets from ``torch.searchsorted``; an empty column sums to 0).  A
    sum is exact for up to 2^30 entries in all (the bench IVC at t = 32 has
    99,735 on the primary side, 146 of them in its largest column)."""
    cols, prods = _gamma_entries(field, shape, eq_rx, gamma)
    if prods.shape[0] > MAX_SUM_ROWS:
        raise ValueError(f"{prods.shape[0]} matrix entries exceed {MAX_SUM_ROWS}")
    offsets = torch.searchsorted(cols, torch.arange(n_cols_pad + 1, dtype=cols.dtype,
                                                    device=cols.device))
    return field_segsum(field.params.name, prods, offsets)


def _eval_gamma_matrix(field: Field, shape, eq_rx, eq_ry, gamma: int) -> torch.Tensor:
    """M_gamma(r_x, r_y) = sum of entries v eq_rx[row] eq_ry[col] gamma^k."""
    cols, prods = _gamma_entries(field, shape, eq_rx, gamma)
    return _sum_rows(field, field.mul(prods, eq_ry[cols]))


def _eq_point(field: Field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """eq(a, b) = prod_j (a_j b_j + (1 - a_j)(1 - b_j)) for two (m, 8) points:
    the terms in two batched products, then a halving product tree."""
    f = field
    one = f.const_like(a, 1)
    ab = f.mul(torch.stack([a, f.sub(one, a)]), torch.stack([b, f.sub(one, b)]))
    terms = f.add(ab[0], ab[1])
    while terms.shape[0] > 1:
        if terms.shape[0] % 2:
            terms = torch.cat([terms, one[:1]])
        half = terms.shape[0] // 2
        terms = f.mul(terms[:half], terms[half:])
    return terms[0]


def spartan_prove(ctx: SpartanCtx, U, W, tr: IntTranscript,
                  timer: PhaseTimer | None = None) -> SpartanProof:
    """Prove that U (a host-side relaxed instance: comm_w, comm_e affine,
    X and u ints) opens to W = RelaxedWitness(w, e), Montgomery tensors on
    ``ctx.device``.  ``timer`` gets a span for each part, named
    "<curve>/outer sumcheck", "<curve>/gamma-matvec", "<curve>/inner
    sumcheck" and "<curve>/two IPAs" (inside it, ``ipa_prove``'s
    "<curve>/ipa.<part>" spans of each round); the rest (Az, Bz, Cz, the eq
    tables, vW, the reads) is in none of them.  None: no spans."""
    f, shape, dev = ctx.field, ctx.dev_shape, ctx.device
    s = shape.shape
    timer = timer or PhaseTimer(enabled=False)
    span = lambda part: timer.phase(f"{ctx.curve_name}/{part}")  # noqa: E731
    absorb_instance_ints(tr, U)

    s1, s2 = num_vars(s.num_cons), num_vars(s.num_vars)
    n1 = 1 << s1
    xu = f.encode([*U.X, U.u], dev)
    z = shape.z_vector(f, W.w, xu[:-1], xu[-1])
    z_pad = pad_to_pow2(f, z)
    az, bz, cz = (_matvec_padded(f, m, z, n1) for m in (shape.a, shape.b, shape.c))
    e_pad = pad_to_pow2(f, W.e)

    tau = [tr.squeeze() for _ in range(s1)]
    eq_t = eq_table(f, f.encode(tau, dev))
    with span("outer sumcheck"):
        rs_x, finals1, msgs1 = sumcheck_prove(
            f, tr, [eq_t, az, bz, cz, e_pad], 3, "spartan_outer", aux=(xu[-1],)
        )
    vA, vB, vC, vE = finals1[1:].unbind(0)
    tr.absorb(*f.decode(finals1[1:]))
    gamma = tr.squeeze()

    eq_rx = eq_table(f, f.encode(rs_x, dev))
    with span("gamma-matvec"):
        m_vec = _gamma_matrix_vector(f, shape, eq_rx, gamma, 1 << s2)
    with span("inner sumcheck"):
        rs_y, _, msgs2 = sumcheck_prove(f, tr, [m_vec, z_pad], 2, "product")

    n_w = 1 << num_vars(s.num_aux)
    eq_ry = eq_table(f, f.encode(rs_y, dev))
    w_pad = pad_to_pow2(f, W.w)[:n_w]
    b_w = eq_ry[:n_w]
    vW = _sum_rows(f, f.mul(w_pad, b_w))
    tr.absorb(f.decode(vW))

    with span("two IPAs"):
        ipa_e = ipa_prove(f, ctx.ck, e_pad, eq_rx, tr, timer)
        ipa_w = ipa_prove(f, ctx.ck, w_pad, b_w, tr, timer)
    return SpartanProof(tuple(msgs1), vA, vB, vC, vE, tuple(msgs2), vW, ipa_e, ipa_w)


def spartan_verify(ctx: SpartanCtx, U, proof: SpartanProof, tr: IntTranscript) -> bool:
    """Check a SpartanProof against the host-side relaxed instance U.  The
    two sumchecks and the claims are checked first (one read); the IPA
    openings, each one commit and one ``msm``, only if those hold."""
    f, shape, dev = ctx.field, ctx.dev_shape, ctx.device
    s = shape.shape
    absorb_instance_ints(tr, U)
    s1, s2 = num_vars(s.num_cons), num_vars(s.num_vars)
    if len(proof.sc1_messages) != s1 or len(proof.sc2_messages) != s2:
        return False

    tau = [tr.squeeze() for _ in range(s1)]
    xu = f.encode([*U.X, U.u], dev)
    u = xu[-1]
    rs_x, final1, ok = sumcheck_verify(f, tr, proof.sc1_messages, torch.zeros_like(u), 3)
    if len(rs_x) != s1:
        return False
    v = torch.stack([proof.vA, proof.vB, proof.vC, proof.vE, proof.vW])
    vA, vB, vC, vE, vW = v.unbind(0)
    ab, uc = f.mul(torch.stack([vA, u]), torch.stack([vB, vC])).unbind(0)
    inner = f.sub(ab, f.add(uc, vE))
    eq_tau = _eq_point(f, f.encode(tau, dev), f.encode(rs_x, dev))
    ok = ok & f.eq(final1, f.mul(eq_tau, inner))

    v_ints = f.decode(v)
    tr.absorb(*v_ints[:4])
    gamma = tr.squeeze()
    g = f.encode([gamma, gamma * gamma], dev)
    claim2 = f.add(vA, _sum_rows(f, f.mul(g, torch.stack([vB, vC]))))
    rs_y, final2, ok2 = sumcheck_verify(f, tr, proof.sc2_messages, claim2, 2)
    if len(rs_y) != s2:
        return False
    ok = ok & ok2

    eq_rx = eq_table(f, f.encode(rs_x, dev))
    eq_ry = eq_table(f, f.encode(rs_y, dev))
    m_ry = _eval_gamma_matrix(f, shape, eq_rx, eq_ry, gamma)
    # z(r_y) = vW (the committed part) + u eq_ry[num_aux] + sum_i X_i eq_ry[num_aux + 1 + i]
    pub = _sum_rows(f, f.mul(torch.cat([xu[-1:], xu[:-1]]),
                             eq_ry[s.num_aux : s.num_aux + 1 + s.num_inputs]))
    ok = ok & f.eq(final2, f.mul(m_ry, f.add(vW, pub)))
    if not bool(ok):
        return False

    tr.absorb(v_ints[4])
    n_w = 1 << num_vars(s.num_aux)
    return (ipa_verify(f, ctx.ck, U.comm_e, eq_rx, v_ints[3], proof.ipa_e, tr)
            and ipa_verify(f, ctx.ck, U.comm_w, eq_ry[:n_w], v_ints[4], proof.ipa_w, tr))
