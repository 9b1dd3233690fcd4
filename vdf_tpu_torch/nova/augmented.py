"""The Nova augmented circuit over the Pasta cycle.

This is THE piece that makes Nova IVC (reference: nova-snark's
NovaAugmentedCircuit, synthesized by PublicParams::setup at
src/nova/proof.rs:232-237 and folded at :342-349): each
step circuit is wrapped so that, besides one application of F, it
verifies the previous *fold* of the other curve's instances in-circuit —
hash check, fold challenge from the in-circuit random oracle, native EC
scalar-mul for the commitment folds, non-native limb arithmetic for the
scalar folds.  Two mirror copies run on the cycle:

  * primary  — over Fq, F = t inverse-MinRoot rounds, folds *secondary*
    instances (Vesta commitments: coords native in Fq);
  * secondary — over Fp, F = trivial (arity 1), folds *primary*
    instances (Pallas commitments: coords native in Fp).

Public IO (arity 2, matching the microsoft/Nova convention):

    X[0] = u.X[1]  — pass-through of the other side's latest state hash
    X[1] = H(d, i+1, z0, z_{i+1}, U_new) truncated to 250 bits

Per-step chain invariant (n = completed steps, checked by the O(1)
verifier in nova/ivc.py):

    l_u_secondary.X[0] == H_Fq(d, n, z0, zn, r_U_secondary)
    l_u_secondary.X[1] == H_Fp(d, n, [0], [0], r_U_primary)

Base case (i == 0): the hash check is skipped; U_new is the empty
accumulator for the primary circuit, and the *lift* of the incoming
primary instance for the secondary circuit (the asymmetry that seeds
the running primary accumulator).

A copy of ``vdf_tpu.nova.augmented`` (host-integer code; the port cannot import that
package, which pulls in jax), its imports re-pointed at the port.
"""

from __future__ import annotations

import dataclasses

from ..fields.int_field import get_int_field
from ..r1cs.bits import AllocatedBit, bits_to_lc, num_select, num_to_bits_le_strict
from ..r1cs.cs import ONE, LinearCombination, ShapeCS
from ..r1cs.gadgets import AllocatedNum, Num, _is_witness
from .circuit import InverseMinRootCircuit
from .gadgets.ec import AllocatedPoint, const_num
from .gadgets.instance import (
    AllocatedInstance,
    AllocatedRelaxedInstance,
    RelaxedParts,
    _alloc_num,
)
from .gadgets.sponge import TranscriptGadget

HASH_BITS = 250  # state hashes truncate here: embeds in both Pasta fields
CHALLENGE_BITS = 128


def _is_zero(cs, num: Num, name: str) -> AllocatedBit:
    """b = 1 iff num == 0: alloc inv with num*inv = 1-b and num*b = 0."""
    if _is_witness(cs):
        f = cs.field
        v = int(num.value) % f.params.modulus
        bv = 1 if v == 0 else 0
        b = AllocatedBit.alloc(cs, f"{name}_b", bv)
        iv = f.inv(v) if v else 0
        inv = AllocatedNum(cs.alloc(f"{name}_inv", value=iv), iv)
    else:
        b = AllocatedBit.alloc(cs, f"{name}_b")
        inv = AllocatedNum(cs.alloc(f"{name}_inv"))
    cs.enforce(num.lc(), inv.lc(), b.not_lc(), name=f"{name}_definv")
    cs.enforce(num.lc(), b.lc(), LinearCombination(), name=f"{name}_zero")
    return b


def _truncated_squeeze(cs, tr: TranscriptGadget, n_bits: int, name: str):
    """Squeeze, decompose canonically (strict), keep the low n_bits.
    Returns (Num of the truncated value, its bits)."""
    h = tr.squeeze()
    bits = num_to_bits_le_strict(cs, h, f"{name}_bits")
    kept = bits[:n_bits]
    value = None
    if _is_witness(cs):
        value = sum(b.value << k for k, b in enumerate(kept))
    return Num(bits_to_lc(kept), value), kept


@dataclasses.dataclass
class TrivialCircuit:
    """Reference TrivialTestCircuit (proof.rs:36, 258-260): F = identity,
    arity 1."""

    arity: int = 1

    def synthesize(self, cs, z):
        return z


@dataclasses.dataclass
class AugmentedInputs:
    """Witness-mode inputs for one synthesis (host-int values)."""

    digest: int  # pp digest: *witnessed* (hash-checked by the verifier),
    # so shapes need not depend on their own digest
    i: int
    z0: list[int]
    z_i: list[int]
    U: object | None  # HostRelaxedInstance of the other circuit
    u: object | None  # HostInstance of the other circuit
    comm_t: tuple | None  # affine (x, y) or None = identity


class AugmentedCircuit:
    """One side of the cycle.  ``step`` provides arity + synthesize(cs, z)."""

    def __init__(self, is_primary: bool, field_name: str, other_modulus: int, step):
        self.is_primary = is_primary
        self.field_name = field_name
        self.other_modulus = other_modulus
        self.step = step

    @property
    def arity(self) -> int:
        a = getattr(self.step, "arity", 3)
        return a() if callable(a) else a

    # -- synthesis (shared by shape and witness passes) ------------------

    def synthesize(self, cs, inp: AugmentedInputs | None):
        w = _is_witness(cs)
        arity = self.arity
        d = Num.from_alloc(_alloc_num(cs, "params", inp.digest if w else None))

        i_num = _alloc_num(cs, "i", inp.i if w else None)
        z0 = [
            _alloc_num(cs, f"z0_{k}", inp.z0[k] if w else None) for k in range(arity)
        ]
        z_i = [
            _alloc_num(cs, f"zi_{k}", inp.z_i[k] if w else None) for k in range(arity)
        ]
        U = AllocatedRelaxedInstance.alloc(cs, "U", inp.U if w else None)
        u = AllocatedInstance.alloc(cs, "u", inp.u if w else None)
        comm_t = AllocatedPoint.alloc(cs, "comm_t", inp.comm_t if w else None)

        is_base = _is_zero(cs, Num.from_alloc(i_num), "base")

        # -- input-state hash: H(d, i, z0, z_i, U), checked vs u.X[0] ----
        with cs.namespace("h_in"):
            tr = TranscriptGadget(cs, self.field_name, name="hin")
            tr.absorb(d, i_num, *z0, *z_i, *U.parts().absorb_elements())
            h_in, _ = _truncated_squeeze(cs, tr, HASH_BITS, "hin")
        # (1 - is_base) * (h_in - u.X[0]) = 0
        cs.enforce(
            is_base.not_lc(),
            h_in.lc() - u.X[0].lc(),
            LinearCombination(),
            name="h_in matches u.X0",
        )

        # -- fold challenge from the in-circuit RO -----------------------
        with cs.namespace("ro"):
            tr = TranscriptGadget(cs, self.field_name, name="ro")
            tr.absorb(
                d,
                *U.parts().absorb_elements(),
                *u.absorb_elements(),
                *comm_t.absorb_elements(),
            )
            _, r_all_bits = _truncated_squeeze(cs, tr, CHALLENGE_BITS, "r")
            r_bits = r_all_bits[:CHALLENGE_BITS]

        # -- the fold, then base-case select -----------------------------
        with cs.namespace("fold"):
            U_fold = U.fold(cs, u, comm_t, r_bits, self.other_modulus)
        with cs.namespace("base"):
            if self.is_primary:
                U_base = RelaxedParts.default(cs)
            else:
                U_base = RelaxedParts.from_strict(cs, u, "lift")
            U_new = U_base.select(cs, is_base, U_fold, "unew")

        # -- one application of F (z input pinned to z0 at the base) -----
        with cs.namespace("stepf"):
            z_in = [
                num_select(cs, is_base, Num.from_alloc(a), Num.from_alloc(b), f"zsel{k}")
                for k, (a, b) in enumerate(zip(z0, z_i))
            ]
            z_next = self.step.synthesize(cs, z_in)
            assert len(z_next) == arity

        i_next = Num(i_num.lc().add(ONE, 1), (inp.i + 1) if w else None)

        # -- output-state hash + public IO -------------------------------
        with cs.namespace("h_out"):
            tr = TranscriptGadget(cs, self.field_name, name="hout")
            tr.absorb(d, i_next, *z0, *z_next, *U_new.absorb_elements())
            h_out, _ = _truncated_squeeze(cs, tr, HASH_BITS, "hout")

        def inputize(num: Num, name: str) -> None:
            if w:
                v = cs.alloc_input(name, value=num.value)
            else:
                v = cs.alloc_input(name)
            cs.enforce(
                LinearCombination.of(v, 1),
                LinearCombination.of(ONE, 1),
                num.lc(),
                name=f"{name} bound",
            )

        inputize(Num.from_alloc(u.X[1]), "X0_passthrough")
        inputize(h_out, "X1_hash")
        return [n.value for n in z_next] if w else None

    # -- host conveniences ------------------------------------------------

    def shape(self):
        modulus = get_int_field(self.field_name).p
        cs = ShapeCS(modulus)
        self.synthesize(cs, None)
        return cs.shape()

    def witness(self, inp: AugmentedInputs, check: bool = False):
        """Returns (cs, z_next ints).  cs.aux is the witness (host ints);
        cs.inputs the two public IO values."""
        from ..r1cs.cs import lc_sink
        from ..r1cs.witness import WitnessCS

        f = get_int_field(self.field_name)
        cs = WitnessCS(f, inputs=[], check=check)
        # check=False never reads a constraint: route LC building to the
        # no-op sink (r1cs/cs.py::lc_sink): synthesis is a large share of a
        # fold's host time.
        with lc_sink(not check):
            z_next = self.synthesize(cs, inp)
        return cs, z_next


def make_circuits(t: int):
    """The standard pair: primary = t inverse-MinRoot rounds over Fq,
    secondary = trivial over Fp (reference circuits(), proof.rs:240-247)."""
    fq = get_int_field("Fq")
    fp = get_int_field("Fp")
    primary = AugmentedCircuit(True, "Fq", fp.p, InverseMinRootCircuit(t))
    secondary = AugmentedCircuit(False, "Fp", fq.p, TrivialCircuit())
    return primary, secondary
