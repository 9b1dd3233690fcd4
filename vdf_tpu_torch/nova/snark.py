"""Recursive VDF proving via NIFS folding (Nova RecursiveSNARK surface; port
of ``vdf_tpu.nova.snark``).

API mirrors the reference (src/nova/proof.rs:232-392): ``public_params(t)``,
``eval_and_make_circuits``, ``prove_recursively``, ``verify``, with the same
segment-reversal convention (circuits walk the inverse direction from the
final result back to the initial state).

This is the framework's transparent tier: the prover folds every
per-segment step instance into one running relaxed R1CS instance (witness
synthesis, Pedersen commits through kernels K3-K7, cross-term matvecs, all on
the parameters' device), and the verifier replays the Poseidon transcript
to re-derive every fold challenge, checks public-IO chaining across segments,
and checks the final folded relaxed instance directly against its witness —
sound by Nova's folding theorem, with O(n) verification and no augmented
circuit.

The JAX package jits a whole step into one executable; here a step is eager
torch, one small op after another, and its time splits into the witness
pass, the commits, the matvecs, the transcript and the point scalings
(chip_smoke.py reports the split).  ``NovaVDFProof.compress`` replaces
the final witness with a Spartan argument (spartan/snark.py).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np
import torch

from ..curves import Point, get_curve
from ..device import resolve_device
from ..errors import NovaError
from ..fields import Field, get_field
from ..minroot import Evaluation, MinRootVDF, State
from ..poseidon import Transcript
from ..r1cs.gadgets import AllocatedNum
from ..r1cs.witness import WitnessCS
from ..spartan.snark import SpartanCtx, spartan_prove, spartan_transcript, spartan_verify
from .circuit import InverseMinRootCircuit
from .ivc import HostRelaxedInstance
from .nifs import NIFS, R1CSInstance, RelaxedInstance, RelaxedWitness
from .pedersen import commitment_key
from .r1cs_device import DeviceShape


@dataclasses.dataclass
class PublicParams:
    t: int  # iterations per step
    field: Field
    curve_name: str
    dev_shape: DeviceShape
    digest: torch.Tensor  # transcript domain separator (field element)

    @property
    def device(self) -> torch.device:
        return self.digest.device

    @functools.cached_property
    def nifs(self) -> NIFS:
        # Generators cover the next power of two, so that openings over
        # zero-padded vectors commit to the identical points.
        n = max(self.dev_shape.shape.num_aux, self.dev_shape.shape.num_cons)
        n = 1 << (n - 1).bit_length()
        ck = commitment_key(self.curve_name, n, device=self.device)
        return NIFS(self.field, get_curve(self.curve_name), self.dev_shape, ck)

    @functools.cached_property
    def spartan_ctx(self) -> SpartanCtx:
        return SpartanCtx(self.field, self.curve_name, self.dev_shape, self.nifs.ck)

    def new_transcript(self) -> Transcript:
        tr = Transcript(self.field.params.name)
        tr.absorb(self.digest)
        tr.flush()
        return tr

    def prove_step(self, tr: Transcript, U: RelaxedInstance, W: RelaxedWitness, z_in):
        """One step: witness synthesis, commit, fold.  Returns
        (U', W', the step's instance, comm_T)."""
        nifs = self.nifs
        cs = WitnessCS(self.field, inputs=list(z_in), check=False)
        z_alloc = [AllocatedNum(v, val)
                   for v, val in zip(InverseMinRootCircuit._input_vars(), z_in)]
        outs = InverseMinRootCircuit(self.t).synthesize(cs, z_alloc)
        w_vec = cs.witness()
        x_vec = torch.stack(list(z_in) + [o.value for o in outs])
        u2 = R1CSInstance(nifs.ck.commit(w_vec), x_vec)
        U2, W2, comm_t = nifs.prove(tr, U, W, u2, w_vec)
        return U2, W2, u2, comm_t

    def final_check(self, U: RelaxedInstance, W: RelaxedWitness) -> torch.Tensor:
        """Relaxed satisfaction of (U, W) and the openings of both
        commitments; a bool tensor on the device."""
        nifs = self.nifs
        c = nifs.curve
        ok = self.dev_shape.check_relaxed_dev(self.field, W.w, W.e, U.x, U.u)
        ok = ok & c.eq(nifs.ck.commit(W.w), U.comm_w).all()
        return ok & c.eq(nifs.ck.commit(W.e), U.comm_e).all()


def _shape_digest(field: Field, shape, device) -> torch.Tensor:
    h = hashlib.sha256()
    for coo in (shape.a_coo, shape.b_coo, shape.c_coo):
        h.update(np.asarray(coo[0]).tobytes())
        h.update(np.asarray(coo[1]).tobytes())
        for c in coo[2]:
            h.update(int(c).to_bytes(32, "little"))
    h.update(bytes([shape.num_cons & 0xFF, shape.num_aux & 0xFF]))
    return field.encode(int.from_bytes(h.digest(), "little") % field.params.modulus, device)


def public_params(num_iters_per_step: int, field_name: str = "Fq", device=None) -> PublicParams:
    """Setup: synthesize the step-circuit shape once and put it on the
    device (None: the card); the commitment generators follow at first use
    (reference public_params, proof.rs:232-237)."""
    device = resolve_device(device)
    field = get_field(field_name)
    circuit = InverseMinRootCircuit(num_iters_per_step)
    shape = circuit.shape(field.params.modulus).shape()
    dev = DeviceShape.build(field, shape, device)
    curve_name = "pallas" if field_name == "Fq" else "vesta"
    return PublicParams(num_iters_per_step, field, curve_name, dev,
                        _shape_digest(field, shape, device))


def eval_and_make_circuits(vdf: MinRootVDF, num_iters_per_step: int, num_steps: int,
                           initial_state: State):
    """Run the slow VDF for n segments; emit circuits in reverse order
    (reference proof.rs:262-298).  Returns (z0, circuits)."""
    if num_steps <= 0:
        raise NovaError("num_steps must be positive")
    t = num_iters_per_step
    states = [initial_state]
    s = initial_state
    for _ in range(num_steps):
        _, proof = Evaluation.eval(vdf, s, t)
        s = proof.result
        states.append(s)
    z0 = [s.x, s.y, s.i]  # final result state: circuits walk backward
    circuits = [InverseMinRootCircuit(t, result=states[k + 1], input=states[k])
                for k in range(num_steps - 1, -1, -1)]
    return z0, circuits


def _replay_folds(pp: PublicParams, instances: list, comm_ts: list) -> RelaxedInstance:
    """Verifier-side transcript replay over all folds."""
    tr = pp.new_transcript()
    U = RelaxedInstance.default(pp.nifs.curve, pp.field, pp.dev_shape.shape.num_inputs,
                                pp.device)
    for u2, comm_t in zip(instances, comm_ts):
        U, _ = pp.nifs.fold_instance(tr, U, u2, comm_t)
    return U


@dataclasses.dataclass
class RecursiveSNARK:
    """Folded proof: per-step instances + final relaxed accumulator."""

    step_instances: list  # [R1CSInstance] in fold order
    U: RelaxedInstance
    W: RelaxedWitness  # final witness


@dataclasses.dataclass
class NovaVDFProof:
    """The reference's ``Recursive(…)`` proof."""

    snark: RecursiveSNARK
    comm_ts: list  # cross-term commitments, one per fold

    @classmethod
    def prove_recursively(cls, pp: PublicParams, circuits: list, z0: list):
        shape = pp.dev_shape.shape
        tr = pp.new_transcript()
        U = RelaxedInstance.default(pp.nifs.curve, pp.field, shape.num_inputs, pp.device)
        W = RelaxedWitness.default(pp.field, shape.num_aux, shape.num_cons, pp.device)
        instances, comm_ts = [], []
        for circ in circuits:
            z_in = tuple(a.to(pp.device) for a in circ.result)
            U, W, u2, comm_t = pp.prove_step(tr, U, W, z_in)
            instances.append(u2)
            comm_ts.append(comm_t)
        return cls(RecursiveSNARK(instances, U, W), comm_ts)

    def verify(self, pp: PublicParams, num_steps: int, z0: list, zi: list) -> bool:
        """Replay transcript, refold instances, check chaining + final
        relaxed satisfaction + commitment openings
        (reference verify, proof.rs:370-387)."""
        snark = self.snark
        return (_chain_holds(pp, snark.step_instances, self.comm_ts, snark.U, num_steps, z0, zi)
                and bool(pp.final_check(snark.U, snark.W)))

    def compress(self, pp: PublicParams) -> "CompressedVDFProof":
        """Replace the final witness with a Spartan argument (reference
        compress, proof.rs:360-368)."""
        sp = spartan_prove(pp.spartan_ctx, _host_instance(pp, self.snark.U), self.snark.W,
                           spartan_transcript(pp.field, pp.field.decode(pp.digest)))
        return CompressedVDFProof(self.snark.step_instances, self.comm_ts, self.snark.U, sp)


def _host_instance(pp: PublicParams, U: RelaxedInstance) -> HostRelaxedInstance:
    """A relaxed instance's points as affine ints and its scalars as ints
    (the form the Spartan transcript absorbs), from one read of each."""
    comm_w, comm_e = pp.nifs.curve.to_affine_ints(
        Point(*(torch.stack(c) for c in zip(U.comm_w, U.comm_e))))
    *x, u = pp.field.decode(torch.cat([U.x, U.u[None]]))
    return HostRelaxedInstance(comm_w, comm_e, x, u)


def _chain_holds(pp: PublicParams, instances: list, comm_ts: list, U: RelaxedInstance,
                 num_steps: int, z0: list, zi: list) -> bool:
    """The verifier's checks short of the final witness: public-IO chaining
    (first z_in == z0, z_out_k == z_in_{k+1}, last z_out == zi), then the
    transcript replay, whose refolded instance must be U."""
    f = pp.field
    if len(instances) != num_steps or num_steps == 0:
        return False

    def eq_state(a, b) -> bool:
        a, b = (torch.stack([v.to(pp.device) for v in s]) for s in (a, b))
        return bool(f.eq(a, b).all())

    xs = [inst.x for inst in instances]
    if not eq_state(xs[0][:3], z0):
        return False
    for xk, xn in zip(xs, xs[1:]):
        if not eq_state(xk[3:6], xn[:3]):
            return False
    if not eq_state(xs[-1][3:6], zi):
        return False
    refold = _replay_folds(pp, instances, comm_ts)
    c = pp.nifs.curve
    return bool(c.eq(refold.comm_w, U.comm_w).all() & c.eq(refold.comm_e, U.comm_e).all()
                & f.eq(refold.x, U.x).all() & f.eq(refold.u, U.u).all())


@dataclasses.dataclass
class CompressedVDFProof:
    """The folded instances and a Spartan argument for the final
    accumulator: the final (W, E) vectors are no longer sent."""

    step_instances: list
    comm_ts: list
    U: RelaxedInstance
    spartan: object  # spartan.SpartanProof

    def verify(self, pp: PublicParams, num_steps: int, z0: list, zi: list) -> bool:
        if not _chain_holds(pp, self.step_instances, self.comm_ts, self.U, num_steps, z0, zi):
            return False
        return spartan_verify(pp.spartan_ctx, _host_instance(pp, self.U), self.spartan,
                              spartan_transcript(pp.field, pp.field.decode(pp.digest)))
