"""In-circuit (relaxed) R1CS instances of the *other* curve's circuit.

The heart of the Nova augmented circuit (reference: nova-snark's
AllocatedRelaxedR1CSInstance machinery, consumed by the reference at
src/nova/proof.rs:232-237 via PublicParams::setup): the
circuit over one Pasta field carries, hashes, and folds instances whose
commitments are points on the curve with coordinates in THAT field —
so all EC math is native — while the instance scalars (u, X) belong to
the other field and are handled by integer-range tricks:

  * ``u`` starts at 0/1 and grows by a 128-bit challenge per fold, so
    its integer value stays < 2^250 for any feasible chain length and
    is representable in both fields without reduction.
  * ``X`` values are full-range other-field elements, carried as
    3x85-bit bit-backed limbs (``BigNat``) and folded with an explicit
    quotient + carry chain (``fold_mod``).

Every value a host transcript absorbs has a circuit twin here with the
identical canonical encoding (affine x, y, inf for points; the integer
itself for u; the 85-bit limb split for X) — parity locked by
tests/test_torch_augmented.py.

A copy of ``vdf_tpu.nova.gadgets.instance`` (host-integer code; the port cannot import that
package, which pulls in jax), its imports re-pointed at the port.
"""

from __future__ import annotations

import dataclasses

from ...r1cs.bits import (
    AllocatedBit,
    BitBlock,
    bits_to_lc,
    bits_value,
    num_select,
    num_to_bits_le,
)
from ...native import ec_fold_witness_native_words, ints_of_u64
from ...r1cs.gadgets import AllocatedNum, Num, _is_witness
from .bignat import BigNat, _bits_limbs, fold_mod, int_to_limbs
from .ec import AllocatedPoint, ProjPoint, const_num


def _alloc_num(cs, name: str, value=None) -> AllocatedNum:
    if _is_witness(cs):
        v = int(value) % cs.field.params.modulus
        return AllocatedNum(cs.alloc(name, value=v), v)
    return AllocatedNum(cs.alloc(name))


@dataclasses.dataclass
class PointParts:
    """A point as three Nums (x, y, inf) — the canonical hash encoding."""

    x: Num
    y: Num
    inf: Num

    @classmethod
    def from_alloc(cls, p: AllocatedPoint) -> "PointParts":
        return cls(
            Num.from_alloc(p.x), Num.from_alloc(p.y), Num(p.inf.lc(), p.inf.value)
        )

    @classmethod
    def constant_identity(cls, cs) -> "PointParts":
        return cls(const_num(cs, 0), const_num(cs, 0), const_num(cs, 1))

    def absorb_elements(self) -> list[Num]:
        return [self.x, self.y, self.inf]


class AllocatedInstance:
    """A strict (u=1, E=0) instance of the other circuit: commitment
    point + its two public IO values.

    The IO values of a *strict* augmented-circuit instance are always
    250-bit truncated hashes (or pass-throughs of such), so they embed
    natively in this field; their range is enforced by the bit
    decomposition shared with the fold (see ``decompose_x``)."""

    def __init__(self, comm_w: AllocatedPoint, X: list[AllocatedNum]):
        assert len(X) == 2
        self.comm_w = comm_w
        self.X = X
        self._x_bits: list[list[AllocatedBit]] | None = None

    @classmethod
    def alloc(cls, cs, name: str, value=None) -> "AllocatedInstance":
        """``value``: host HostInstance or None (dummy: identity, X=[0,0])."""
        if _is_witness(cs) and value is not None:
            comm = AllocatedPoint.alloc(cs, f"{name}_w", value.comm_w)
            X = [_alloc_num(cs, f"{name}_X{k}", value.X[k]) for k in range(2)]
        elif _is_witness(cs):
            comm = AllocatedPoint.alloc(cs, f"{name}_w", None)
            X = [_alloc_num(cs, f"{name}_X{k}", 0) for k in range(2)]
        else:
            comm = AllocatedPoint.alloc(cs, f"{name}_w")
            X = [AllocatedNum(cs.alloc(f"{name}_X{k}")) for k in range(2)]
        return cls(comm, X)

    def decompose_x(self, cs, name: str) -> list[list[AllocatedBit]]:
        """250-bit decompositions of both IO values (range proof +
        limb source for the non-native fold).  Allocated once."""
        if self._x_bits is None:
            self._x_bits = [
                num_to_bits_le(cs, self.X[k], 250, f"{name}_x{k}b") for k in range(2)
            ]
        return self._x_bits

    def absorb_elements(self) -> list[Num]:
        return PointParts.from_alloc(self.comm_w).absorb_elements() + [
            Num.from_alloc(self.X[0]),
            Num.from_alloc(self.X[1]),
        ]


@dataclasses.dataclass
class RelaxedParts:
    """A relaxed instance of the other circuit as pure Nums — the form
    produced by folds/selects and absorbed by the output hash."""

    comm_w: PointParts
    comm_e: PointParts
    u: Num
    X: list[BigNat]  # len 2

    def absorb_elements(self) -> list[Num]:
        out = self.comm_w.absorb_elements() + self.comm_e.absorb_elements() + [self.u]
        for bn in self.X:
            out.extend(bn.absorb_elements())
        return out

    @classmethod
    def default(cls, cs) -> "RelaxedParts":
        """The empty accumulator: identity comms, u = 0, X = 0."""
        return cls(
            PointParts.constant_identity(cs),
            PointParts.constant_identity(cs),
            const_num(cs, 0),
            [BigNat.constant(cs, 0), BigNat.constant(cs, 0)],
        )

    @classmethod
    def from_strict(
        cls, cs, u_inst: AllocatedInstance, name: str = "lift"
    ) -> "RelaxedParts":
        """Lift a strict instance: (comm_w, E=0, u=1, X) — the secondary
        circuit's base case absorbs the first primary instance this way
        (nova-snark's from_r1cs_instance)."""
        x_bits = u_inst.decompose_x(cs, name)
        return cls(
            PointParts.from_alloc(u_inst.comm_w),
            PointParts.constant_identity(cs),
            const_num(cs, 1),
            [BigNat.from_bits(cs, bits) for bits in x_bits],
        )

    def select(
        self, cs, cond: AllocatedBit, other: "RelaxedParts", name: str = "usel"
    ) -> "RelaxedParts":
        """cond ? self : other, component-wise."""

        def sel(a: Num, b: Num, nm: str) -> Num:
            return Num.from_alloc(num_select(cs, cond, a, b, nm))

        def sel_pt(a: PointParts, b: PointParts, nm: str) -> PointParts:
            return PointParts(
                sel(a.x, b.x, f"{nm}_x"),
                sel(a.y, b.y, f"{nm}_y"),
                sel(a.inf, b.inf, f"{nm}_i"),
            )

        return RelaxedParts(
            sel_pt(self.comm_w, other.comm_w, f"{name}_w"),
            sel_pt(self.comm_e, other.comm_e, f"{name}_e"),
            sel(self.u, other.u, f"{name}_u"),
            [
                self.X[k].select(cs, cond, other.X[k], f"{name}_X{k}")
                for k in range(2)
            ],
        )


class AllocatedRelaxedInstance:
    """The witnessed running relaxed instance (circuit input form)."""

    def __init__(
        self,
        comm_w: AllocatedPoint,
        comm_e: AllocatedPoint,
        u: AllocatedNum,
        X: list[BigNat],
    ):
        self.comm_w, self.comm_e, self.u, self.X = comm_w, comm_e, u, X

    @classmethod
    def alloc(cls, cs, name: str, value=None) -> "AllocatedRelaxedInstance":
        """``value``: host HostRelaxedInstance or None (default/empty)."""
        if _is_witness(cs):
            v = value
            cw = AllocatedPoint.alloc(cs, f"{name}_w", v.comm_w if v else None)
            ce = AllocatedPoint.alloc(cs, f"{name}_e", v.comm_e if v else None)
            u = _alloc_num(cs, f"{name}_u", v.u if v else 0)
            X = [
                BigNat.alloc(cs, f"{name}_X{k}", v.X[k] if v else 0)
                for k in range(2)
            ]
        else:
            cw = AllocatedPoint.alloc(cs, f"{name}_w")
            ce = AllocatedPoint.alloc(cs, f"{name}_e")
            u = AllocatedNum(cs.alloc(f"{name}_u"))
            X = [BigNat.alloc(cs, f"{name}_X{k}") for k in range(2)]
        return cls(cw, ce, u, X)

    def parts(self) -> RelaxedParts:
        return RelaxedParts(
            PointParts.from_alloc(self.comm_w),
            PointParts.from_alloc(self.comm_e),
            Num.from_alloc(self.u),
            self.X,
        )

    def fold(
        self,
        cs,
        u_inst: AllocatedInstance,
        comm_t: AllocatedPoint,
        r_bits: list[AllocatedBit],
        p_other: int,
        name: str = "fold",
    ) -> RelaxedParts:
        """The NIFS instance fold, in-circuit (the verifier the augmented
        circuit embeds — nova-snark's fold_with_r1cs):

            comm_w' = comm_w + r * u.comm_w      (native EC, complete ops)
            comm_e' = comm_e + r * comm_T
            u'      = u + r                       (integer, no reduction)
            X_k'    = (X_k + r * u.X_k) mod p_other   (bignat carry proof)
        """
        r_val = bits_value(r_bits) if _is_witness(cs) else None
        r_num = Num(bits_to_lc(r_bits), r_val)

        # The value-only pass over host ints (cs.blocks): the C++ emitter
        # produces every allocated value of scalar_mul + add + to_affine in
        # gadget order (native/pasta.cpp::ec_fold_witness_native), allocated
        # as one block in place of the double-and-add chains in Python ints.
        blocks = getattr(cs, "blocks", False)

        def scaled_add(base: AllocatedPoint, pt: AllocatedPoint, nm: str) -> PointParts:
            if blocks:
                p_mod = cs.field.params.modulus

                def proj(ap: AllocatedPoint) -> tuple[int, int, int]:
                    # to_projective's linear embedding (x, y+inf, 1-inf)
                    return (
                        int(ap.x.value) % p_mod,
                        (int(ap.y.value) + int(ap.inf.value)) % p_mod,
                        (1 - int(ap.inf.value)) % p_mod,
                    )

                if isinstance(r_bits, BitBlock):
                    bits_msb = r_bits.msb_first()
                else:
                    bits_msb = [b.value for b in reversed(r_bits)]
                words = ec_fold_witness_native_words(
                    cs.field.params.name, proj(base), proj(pt), bits_msb
                )
                cs.alloc_block(words)
                inf_v, _, x_v, y_v = ints_of_u64(words[-4:])
                from ...r1cs.cs import NULL_LC

                return PointParts(
                    Num(NULL_LC, x_v), Num(NULL_LC, y_v), Num(NULL_LC, inf_v)
                )
            term = pt.to_projective(cs).scalar_mul(cs, r_bits, f"{nm}_smul")
            total = base.to_projective(cs).add(cs, term, f"{nm}_acc")
            return PointParts.from_alloc(total.to_affine(cs, f"{nm}_aff"))

        comm_w = scaled_add(self.comm_w, u_inst.comm_w, f"{name}_w")
        comm_e = scaled_add(self.comm_e, comm_t, f"{name}_e")

        u_val = None
        if _is_witness(cs):
            u_val = cs.field.add(self.u.value, r_val)
        u_new = Num(self.u.lc() + r_num.lc(), u_val)

        x_bits = u_inst.decompose_x(cs, name)
        X_new = [
            fold_mod(
                cs,
                self.X[k],
                r_bits,
                Num.from_alloc(u_inst.X[k]),
                p_other,
                f"{name}_X{k}",
                x_bits=x_bits[k],
            )
            for k in range(2)
        ]
        return RelaxedParts(comm_w, comm_e, u_new, X_new)
