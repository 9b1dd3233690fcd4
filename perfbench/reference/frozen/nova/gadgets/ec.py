"""In-circuit elliptic-curve gadgets over the circuit's *native* field.

The Pasta-cycle trick (nova-snark's augmented circuit, reference
src/nova/proof.rs:26-43,232-237): the primary circuit
(over Fq) folds instances whose commitments are Vesta points — whose
coordinates live in Fq — so all point arithmetic here is native field
arithmetic.  Mirror statement for the secondary circuit and Pallas
points.

Representation:
  * ``AllocatedPoint`` — affine (x, y) plus an ``inf`` bit; identity is
    stored as (0, 0, inf=1) and enforced by inf*x = 0, inf*y = 0.  This
    matches the canonical transcript encoding the host absorbs.
  * ``ProjPoint`` — projective (X : Y : Z) as linear-combination ``Num``s;
    identity is (0 : 1 : 0).  Group ops use the same complete RCB15 a=0
    formulas as the device (curves/point.py:88-129) and host
    (curves/int_ops.py) implementations, so no case analysis is needed
    anywhere — identity and doubling flow through the one add.

A copy of ``vdf_tpu.nova.gadgets.ec`` (host-integer code; the port cannot import that
package, which pulls in jax), its imports re-pointed at the port.
"""

from __future__ import annotations

from ...curves.point import B3, B_COEFF
from ...r1cs.bits import AllocatedBit, num_select
from ...r1cs.cs import ONE, LinearCombination
from ...r1cs.gadgets import AllocatedNum, Num, _is_witness


def const_num(cs, k: int) -> Num:
    value = cs.field.encode(k) if _is_witness(cs) else None
    return Num(LinearCombination.of(ONE, k), value)


def num_mul(cs, a, b, name: str = "mul") -> AllocatedNum:
    """Allocate out = a*b for any Num/AllocatedNum operands."""
    if _is_witness(cs):
        value = cs.field.mul(a.value, b.value)
        out = AllocatedNum(cs.alloc(name, value=value), value)
    else:
        out = AllocatedNum(cs.alloc(name))
    cs.enforce(a.lc(), b.lc(), out.lc(), name=name)
    return out


def _num_add(cs, a, b) -> Num:
    """Free linear add of Num-likes."""
    value = None
    if a.value is not None and b.value is not None:
        value = cs.field.add(a.value, b.value) if _is_witness(cs) else None
        if value is not None:
            value = cs.field.partial_reduce(value, k_max=2)
    return Num(a.lc() + b.lc(), value)


def _num_sub(cs, a, b) -> Num:
    value = None
    if a.value is not None and b.value is not None:
        value = cs.field.sub(a.value, b.value) if _is_witness(cs) else None
    return Num(a.lc() - b.lc(), value)


def _num_scale(cs, a, k: int) -> Num:
    value = None
    if a.value is not None and _is_witness(cs):
        value = cs.field.mul(a.value, cs.field.const_like(a.value, k))
    return Num(a.lc(k), value)


class AllocatedPoint:
    """Affine witness point (x, y, inf) with canonical identity (0,0,1)."""

    def __init__(self, x: AllocatedNum, y: AllocatedNum, inf: AllocatedBit):
        self.x, self.y, self.inf = x, y, inf

    @classmethod
    def alloc(cls, cs, name: str, value=None) -> "AllocatedPoint":
        """``value``: affine (x, y) int tuple, or None for identity
        (witness mode); ignored in shape mode."""
        if _is_witness(cs):
            if value is None:
                xv, yv, iv = 0, 0, 1
            else:
                xv, yv, iv = int(value[0]), int(value[1]), 0
            x = AllocatedNum(cs.alloc(f"{name}_x", value=xv), xv)
            y = AllocatedNum(cs.alloc(f"{name}_y", value=yv), yv)
            inf = AllocatedBit.alloc(cs, f"{name}_inf", iv)
        else:
            x = AllocatedNum(cs.alloc(f"{name}_x"))
            y = AllocatedNum(cs.alloc(f"{name}_y"))
            inf = AllocatedBit.alloc(cs, f"{name}_inf")
        # identity is canonically (0, 0): inf * x = 0, inf * y = 0
        cs.enforce(inf.lc(), x.lc(), LinearCombination(), name=f"{name}_inf_x")
        cs.enforce(inf.lc(), y.lc(), LinearCombination(), name=f"{name}_inf_y")
        return cls(x, y, inf)

    def check_on_curve(self, cs, name: str = "oncurve") -> None:
        """y^2 = x^3 + b, gated by (1 - inf)."""
        ysq = num_mul(cs, self.y, self.y, f"{name}_ysq")
        xsq = num_mul(cs, self.x, self.x, f"{name}_xsq")
        xcube = num_mul(cs, xsq, self.x, f"{name}_xcube")
        # ysq - xcube - b*(1 - inf) == 0  (linear)
        lc = ysq.lc() - xcube.lc() - LinearCombination.of(ONE, B_COEFF) + self.inf.lc(
            B_COEFF
        )
        cs.enforce(
            lc, LinearCombination.of(ONE, 1), LinearCombination(), name=name
        )

    def absorb_elements(self) -> list:
        """Canonical transcript encoding: [x, y, inf]."""
        return [
            Num.from_alloc(self.x),
            Num.from_alloc(self.y),
            Num(self.inf.lc(), self.inf.value),
        ]

    def to_projective(self, cs) -> "ProjPoint":
        """Linear embedding: (x, y + inf, 1 - inf)."""
        f = cs.field if _is_witness(cs) else None
        xv = yv = zv = None
        if _is_witness(cs):
            xv = self.x.value
            yv = f.add(self.y.value, self.inf.value) % f.params.modulus
            zv = (1 - self.inf.value) % f.params.modulus
        return ProjPoint(
            Num(self.x.lc(), xv),
            Num(self.y.lc() + self.inf.lc(), yv),
            Num(LinearCombination.of(ONE, 1) - self.inf.lc(), zv),
        )


class ProjPoint:
    """Projective point of Nums; ops allocate intermediate products."""

    def __init__(self, x: Num, y: Num, z: Num):
        self.x, self.y, self.z = x, y, z

    @classmethod
    def identity(cls, cs) -> "ProjPoint":
        return cls(const_num(cs, 0), const_num(cs, 1), const_num(cs, 0))

    def add(self, cs, q: "ProjPoint", name: str = "ecadd") -> "ProjPoint":
        """Complete RCB15 a=0 addition — 12 product constraints.
        Mirrors curves/point.py:88-110 term for term."""
        x1, y1, z1 = self.x, self.y, self.z
        x2, y2, z2 = q.x, q.y, q.z
        m = lambda a, b, nm: num_mul(cs, a, b, f"{name}_{nm}")
        t0 = m(x1, x2, "t0")
        t1 = m(y1, y2, "t1")
        t2 = m(z1, z2, "t2")
        t3 = m(_num_add(cs, x1, y1), _num_add(cs, x2, y2), "t3")
        t3 = _num_sub(cs, t3, _num_add(cs, t0, t1))
        t4 = m(_num_add(cs, y1, z1), _num_add(cs, y2, z2), "t4")
        t4 = _num_sub(cs, t4, _num_add(cs, t1, t2))
        y3 = m(_num_add(cs, x1, z1), _num_add(cs, x2, z2), "xz")
        y3 = _num_sub(cs, y3, _num_add(cs, t0, t2))
        x3 = _num_scale(cs, t0, 3)
        t2b = _num_scale(cs, t2, B3)
        z3 = _num_add(cs, t1, t2b)
        t1 = _num_sub(cs, t1, t2b)
        y3 = _num_scale(cs, y3, B3)
        x3_out = _num_sub(cs, m(t3, t1, "x3a"), m(t4, y3, "x3b"))
        y3_out = _num_add(cs, m(t1, z3, "y3a"), m(y3, x3, "y3b"))
        z3_out = _num_add(cs, m(z3, t4, "z3a"), m(x3, t3, "z3b"))
        return ProjPoint(x3_out, y3_out, z3_out)

    def double(self, cs, name: str = "ecdbl") -> "ProjPoint":
        """Complete RCB15 a=0 doubling — mirrors curves/point.py:112-129."""
        x, y, z = self.x, self.y, self.z
        m = lambda a, b, nm: num_mul(cs, a, b, f"{name}_{nm}")
        t0 = m(y, y, "t0")
        z3 = _num_scale(cs, t0, 8)
        t1 = m(y, z, "t1")
        zsq = m(z, z, "zsq")
        t2 = _num_scale(cs, zsq, B3)
        x3 = m(t2, z3, "x3")
        y3 = _num_add(cs, t0, t2)
        z3 = m(t1, z3, "z3")
        t1b = _num_scale(cs, t2, 3)
        t0 = _num_sub(cs, t0, t1b)
        y3 = _num_add(cs, m(t0, y3, "y3"), x3)
        xy = m(x, y, "xy")
        x3 = _num_scale(cs, m(xy, t0, "x3f"), 2)
        return ProjPoint(x3, y3, z3)

    def select(self, cs, cond: AllocatedBit, other: "ProjPoint", name: str = "psel") -> "ProjPoint":
        """cond ? self : other."""
        return ProjPoint(
            Num.from_alloc(num_select(cs, cond, self.x, other.x, f"{name}_x")),
            Num.from_alloc(num_select(cs, cond, self.y, other.y, f"{name}_y")),
            Num.from_alloc(num_select(cs, cond, self.z, other.z, f"{name}_z")),
        )

    def scalar_mul(self, cs, bits_le: list[AllocatedBit], name: str = "smul") -> "ProjPoint":
        """Double-and-add over little-endian challenge bits (MSB-first
        scan); a constant sequence of complete ops, like the device scan
        (curves/point.py:182-191)."""
        acc = ProjPoint.identity(cs)
        for j, bit in enumerate(reversed(bits_le)):
            acc = acc.double(cs, f"{name}_d{j}")
            added = acc.add(cs, self, f"{name}_a{j}")
            acc = added.select(cs, bit, acc, f"{name}_s{j}")
        return acc

    def to_affine(self, cs, name: str = "aff") -> AllocatedPoint:
        """Allocate the canonical affine form (x, y, inf).

        Constraints: inf boolean; z * zinv = 1 - inf; inf * z = 0
        (so z != 0 forces inf = 0, z == 0 forces inf = 1);
        x = X * zinv; y = Y * zinv; inf * y = 0 (pins y = 0 at identity
        — x is already forced to 0 because identity outputs have X = 0).
        """
        f = cs.field if _is_witness(cs) else None
        if _is_witness(cs):
            p = f.params.modulus
            zv = int(self.z.value) % p
            iv = 1 if zv == 0 else 0
            zinv_v = pow(zv, -1, p) if zv else 0
            xv = int(self.x.value) * zinv_v % p
            yv = int(self.y.value) * zinv_v % p
            inf = AllocatedBit.alloc(cs, f"{name}_inf", iv)
            zinv = AllocatedNum(cs.alloc(f"{name}_zinv", value=zinv_v), zinv_v)
            x = AllocatedNum(cs.alloc(f"{name}_x", value=xv), xv)
            y = AllocatedNum(cs.alloc(f"{name}_y", value=yv), yv)
        else:
            inf = AllocatedBit.alloc(cs, f"{name}_inf")
            zinv = AllocatedNum(cs.alloc(f"{name}_zinv"))
            x = AllocatedNum(cs.alloc(f"{name}_x"))
            y = AllocatedNum(cs.alloc(f"{name}_y"))
        one = LinearCombination.of(ONE, 1)
        cs.enforce(self.z.lc(), zinv.lc(), one - inf.lc(), name=f"{name}_zinv")
        cs.enforce(inf.lc(), self.z.lc(), LinearCombination(), name=f"{name}_infz")
        cs.enforce(self.x.lc(), zinv.lc(), x.lc(), name=f"{name}_x")
        cs.enforce(self.y.lc(), zinv.lc(), y.lc(), name=f"{name}_y")
        cs.enforce(inf.lc(), y.lc(), LinearCombination(), name=f"{name}_infy")
        return AllocatedPoint(x, y, inf)
