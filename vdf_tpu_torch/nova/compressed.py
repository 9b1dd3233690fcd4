"""Constant-size compressed proof for the two-curve IVC (port of
``vdf_tpu.nova.compressed``).

Reference capability: nova-snark's CompressedSNARK with
``spartan_with_ipa_pc`` (the Rust reference's src/nova/proof.rs:32-43,
360-368): the O(1)-size RecursiveSNARK still carries the two relaxed
*witness* vectors; compression replaces them with Spartan(+IPA) arguments,
so the serialized proof is a few dozen field elements, points and sumcheck
messages, independent of both the chain length and the witness size.

  prove:
    1. fold ``l_u_secondary`` into ``r_U_secondary`` -> (U_sec', W_sec',
       comm_T): after it there are exactly TWO relaxed instances;
    2. a Spartan argument for (W, E) of the primary accumulator (Fq,
       Pallas commitments) and of the folded secondary one (Fp, Vesta).
  verify:
    1. the state-hash checks of ``ivc_verify`` (O(1));
    2. re-derive the closing fold's challenge from (digest, r_U_secondary,
       l_u_secondary, comm_T) and refold the *instance* only;
    3. both Spartan arguments against the two relaxed instances.

Each side argues on the engine it was built with: the device engine's on
the device tier (spartan/snark.py: the vectors on the card, the commits
and ``msm`` in K3-K6, K9), the native engine's on the host-int tier
(spartan/host.py).  Both give the same proof; each keeps it in its own
form (tensors, or ints), as its witness handles.
"""

from __future__ import annotations

import dataclasses

from ..spartan.host import host_spartan_prove, host_spartan_verify
from ..spartan.snark import spartan_prove, spartan_transcript, spartan_verify
from ..utils.profiling import PhaseTimer
from .augmented import HASH_BITS
from .ivc import (
    HostInstance,
    HostRelaxedInstance,
    IVCParams,
    IVCProof,
    Side,
    fold_challenge,
    state_hash,
)
from .nifs import RelaxedWitness


def _prove_side(side: Side, digest: int, U: HostRelaxedInstance, W, E, timer: PhaseTimer):
    """One Spartan argument on the side's engine: a SpartanProof of tensors
    on the device engine (a device Side is its own SpartanCtx), a
    HostSpartanProof on the native one."""
    tr = spartan_transcript(side.field, digest)
    if side.use_device:
        return spartan_prove(side, U, RelaxedWitness(W, E), tr, timer)
    return host_spartan_prove(side, U, W, E, tr)


def _verify_side(side: Side, digest: int, U: HostRelaxedInstance, sp) -> bool:
    """The argument, in the side's engine's form, on that engine."""
    tr = spartan_transcript(side.field, digest)
    if side.use_device:
        return spartan_verify(side, U, sp, tr)
    return host_spartan_verify(side, U, sp, tr)


@dataclasses.dataclass
class CompressedIVCProof:
    """Constant-size proof: three instances, one cross-term commitment and
    two Spartan arguments.  No witness vectors, no per-step data: its size
    depends on neither the number of steps nor the witness length
    (reference CompressedSNARK, proof.rs:52-55, 360-368)."""

    i: int
    z0: list[int]
    z_i: list[int]
    r_U_primary: HostRelaxedInstance
    r_U_secondary: HostRelaxedInstance
    l_u_secondary: HostInstance
    comm_t_final: tuple | None  # cross term of the closing secondary fold
    spartan_primary: object  # SpartanProof (device engine) | HostSpartanProof (native)
    spartan_secondary: object


def ivc_compress(pp: IVCParams, proof: IVCProof,
                 timer: PhaseTimer | None = None) -> CompressedIVCProof:
    """CompressedSNARK::prove (proof.rs:360-368).  The closing fold is
    ``Side.fold_cached`` with the product cache seeded anew: the device
    engine's fold (which refuses a witness in the wrong domain), or on the
    native engine its six-matvec ``Side.fold``.

    ``timer`` gets the spans "closing fold" and "<curve>" (a side's whole
    argument), and on the device engine "<curve>/<part>" for the parts of
    ``spartan_prove``; give it a ``sync`` to time the card's work."""
    timer = timer or PhaseTimer()
    d = pp.digest
    with timer.phase("closing fold"):
        U_sec, W_sec, E_sec, comm_t, _, _ = pp.secondary.fold_cached(
            d, proof.r_U_secondary, proof.r_W_secondary, proof.r_E_secondary,
            proof.l_u_secondary, proof.l_w_secondary, None,
        )
    with timer.phase(pp.primary.curve_name):
        sp_p = _prove_side(pp.primary, d, proof.r_U_primary, proof.r_W_primary,
                           proof.r_E_primary, timer)
    with timer.phase(pp.secondary.curve_name):
        sp_s = _prove_side(pp.secondary, d, U_sec, W_sec, E_sec, timer)
    return CompressedIVCProof(
        proof.i, list(proof.z0), [int(v) for v in proof.z_i], proof.r_U_primary,
        proof.r_U_secondary, proof.l_u_secondary, comm_t, sp_p, sp_s,
    )


def ivc_verify_compressed(pp: IVCParams, proof: CompressedIVCProof, num_steps: int,
                          z0: list[int], zn: list[int]) -> bool:
    """CompressedSNARK::verify (proof.rs:370-387): O(1) hash checks, the
    instance refold and two Spartan verifications; touches no witness
    vector and nothing sized by num_steps."""
    if num_steps == 0 or proof.i != num_steps:
        return False
    p = pp.primary.field.params.modulus
    z0 = [int(v) % p for v in z0]
    zn = [int(v) % p for v in zn]
    if proof.z0 != z0 or [int(v) % p for v in proof.z_i] != zn:
        return False

    d = pp.digest
    if proof.l_u_secondary.X[0] != state_hash("Fq", d, num_steps, z0, zn, proof.r_U_secondary):
        return False
    if proof.l_u_secondary.X[1] != state_hash("Fp", d, num_steps, [0], [0], proof.r_U_primary):
        return False
    for U in (proof.r_U_primary, proof.r_U_secondary):
        if not (0 <= U.u < (1 << HASH_BITS)):
            return False

    sec = pp.secondary
    r = fold_challenge(sec.tr_field, d, proof.r_U_secondary, proof.l_u_secondary,
                       proof.comm_t_final)
    U_sec = sec.fold_instance(proof.r_U_secondary, proof.l_u_secondary, proof.comm_t_final, r)
    return (_verify_side(pp.primary, d, proof.r_U_primary, proof.spartan_primary)
            and _verify_side(sec, d, U_sec, proof.spartan_secondary))
