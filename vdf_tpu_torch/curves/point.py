"""Pasta curve points on torch tensors (port of ``vdf_tpu.curves.point``).

Pallas is y^2 = x^3 + 5 over Fp with scalar field Fq; Vesta is the same
equation over Fq with scalar field Fp.  A point is homogeneous projective
``(X : Y : Z)``, identity ``(0 : 1 : 0)``, each coordinate an ``(..., 8)``
int32 Montgomery tensor (fields/params.py), batched over leading axes.

The group law is the complete a=0 addition and doubling of
Renes–Costello–Batina 2015 (algorithms 7 and 9), the same formulas as the
JAX package and ``curves/int_ops.py``.  Every intermediate is canonical
(< p), so a result is the exact projective triple those formulas give,
limb for limb, on every device.  ``add16``/``double16`` work on 16-bit
digit tuples (fields/ops.py) and are the plain versions of the device
functions in ``csrc/curve.cuh``; they stack independent field products
into one ``mul16`` call, since a call's fixed cost dominates at small
batch sizes.

Host-side exact-int helpers (generator derivation, Tonelli–Shanks sqrt)
are copied from the JAX package and give the same ints.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import NamedTuple

import torch

from ..device import resolve_device
from ..fields import NLIMBS, Field, get_field
from ..fields.ops import from_digits, to_digits

B_COEFF = 5  # y^2 = x^3 + 5 for both Pasta curves
B3 = 15  # 3*b, used by the complete formulas


class Point(NamedTuple):
    """Projective (X : Y : Z); identity is (0 : 1 : 0)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CurveParams:
    name: str
    base_field: str  # coordinates live here
    scalar_field: str  # group order field


PALLAS = CurveParams("pallas", base_field="Fp", scalar_field="Fq")
VESTA = CurveParams("vesta", base_field="Fq", scalar_field="Fp")
CURVES = {"pallas": PALLAS, "vesta": VESTA}


def stack_point(p: Point) -> torch.Tensor:
    """Point of (..., 8) coordinates -> (..., 3, 8), the kernels' layout."""
    return torch.stack(tuple(p), dim=-2)


def unstack_point(t: torch.Tensor) -> Point:
    return Point(*t.unbind(-2))


# ---------------------------------------------------------------------
# digit-level group law: points as (x, y, z) tuples of (..., 16) digits
# ---------------------------------------------------------------------


def point_to_digits(t: torch.Tensor) -> tuple:
    """(..., 3, 8) int32 stacked point -> (x, y, z) digit tensors."""
    return to_digits(t).unbind(-2)


def point_from_digits(p16) -> torch.Tensor:
    """(x, y, z) digit tensors -> (..., 3, 8) int32 stacked point."""
    return from_digits(torch.stack(tuple(p16), dim=-2))


def _batched(op, pairs):
    """op over several independent (a, b) operand pairs in one call."""
    shape = torch.broadcast_shapes(*(t.shape for pr in pairs for t in pr))
    a = torch.stack([x.expand(shape) for x, _ in pairs])
    b = torch.stack([y.expand(shape) for _, y in pairs])
    return op(a, b).unbind(0)


class _Ops:
    """Canonical field ops on digits, each over a list of operand pairs."""

    def __init__(self, f: Field, device):
        self.f = f
        self.b3 = to_digits(f.encode(B3, device))  # 3b in Montgomery form

    def mul(self, *pairs):
        return _batched(self.f.mul16, pairs)

    def add(self, *pairs):
        return _batched(lambda a, b: self.f.cond_sub_p16(self.f.add16(a, b)), pairs)

    def sub(self, *pairs):
        return _batched(self.f.sub16, pairs)


@functools.cache
def _ops(field_name: str, device: str) -> _Ops:
    return _Ops(get_field(field_name), torch.device(device))


def add16(field_name: str, p, q):
    """Complete RCB15 add (a=0) on digit tuples; canonical in and out."""
    o = _ops(field_name, str(p[0].device))
    b3 = o.b3
    x1, y1, z1 = p
    x2, y2, z2 = q
    s = o.add((x1, y1), (x2, y2), (y1, z1), (y2, z2), (x1, z1), (x2, z2))
    t0, t1, t2, u3, u4, u5 = o.mul(
        (x1, x2), (y1, y2), (z1, z2), (s[0], s[1]), (s[2], s[3]), (s[4], s[5])
    )
    a01, a12, a02, t00 = o.add((t0, t1), (t1, t2), (t0, t2), (t0, t0))
    t3, t4, y3 = o.sub((u3, a01), (u4, a12), (u5, a02))
    (x3,) = o.add((t00, t0))  # 3*t0
    t2b, y3 = o.mul((b3, t2), (b3, y3))
    (z3,) = o.add((t1, t2b))
    (t1,) = o.sub((t1, t2b))
    m = o.mul((t3, t1), (t4, y3), (t1, z3), (y3, x3), (z3, t4), (x3, t3))
    (x_out,) = o.sub((m[0], m[1]))
    y_out, z_out = o.add((m[2], m[3]), (m[4], m[5]))
    return (x_out, y_out, z_out)


def double16(field_name: str, p):
    """Complete RCB15 doubling (a=0) on digit tuples: 6M + 2S."""
    o = _ops(field_name, str(p[0].device))
    x, y, z = p
    t0, t1, zz, xy = o.mul((y, y), (y, z), (z, z), (x, y))
    (t2,) = o.mul((o.b3, zz))
    e2, t2x2 = o.add((t0, t0), (t2, t2))
    e4, t2x3, y3 = o.add((e2, e2), (t2x2, t2), (t0, t2))
    (z8,) = o.add((e4, e4))  # 8*t0
    (t0,) = o.sub((t0, t2x3))  # t0 - 3*t2
    x3, z_out, u, v = o.mul((t2, z8), (t1, z8), (t0, y3), (xy, t0))
    y_out, x_out = o.add((u, x3), (v, v))
    return (x_out, y_out, z_out)


def identity16(field_name: str, like: torch.Tensor):
    """The identity as digit tuples shaped like ``like`` (..., 16)."""
    c = get_field(field_name).consts(like.device)
    zero = torch.zeros_like(like)
    return (zero, c.one.expand_as(like).clone(), zero.clone())


def select16(mask: torch.Tensor, p, q):
    """mask ? p : q per batch element (mask shape = batch shape)."""
    m = mask[..., None]
    return tuple(torch.where(m, a, b) for a, b in zip(p, q))


class Curve:
    def __init__(self, params: CurveParams):
        self.params = params
        self.field: Field = get_field(params.base_field)
        self.scalar: Field = get_field(params.scalar_field)

    # -- constructors ---------------------------------------------------

    def _bcast(self, v: torch.Tensor, shape) -> torch.Tensor:
        return v.expand(*shape, v.shape[-1]).clone()

    def identity(self, shape=(), device=None) -> Point:
        device = resolve_device(device)
        zero = torch.zeros(8, dtype=torch.int32, device=device)
        one = self.field.one(device)
        return Point(self._bcast(zero, shape), self._bcast(one, shape), self._bcast(zero, shape))

    def generator(self, shape=(), device=None) -> Point:
        """The pasta_curves generator (-1, 2): on both curves, since
        (-1)^3 + 5 = 4 = 2^2."""
        device = resolve_device(device)
        f = self.field
        x = f.encode(f.params.modulus - 1, device)
        return Point(*(self._bcast(v, shape) for v in (x, f.encode(2, device), f.one(device))))

    def from_affine_ints(self, coords: list[tuple[int, int] | None], device=None) -> Point:
        """Host ints [(x, y) or None, ...] -> batched projective points
        (z = 1; None is the identity (0 : 1 : 0)), in one transfer."""
        f = self.field
        xyz = f.encode([v for c in coords for v in ((0, 1, 0) if c is None else (*c, 1))],
                       resolve_device(device))
        return Point(*(v.contiguous() for v in xyz.reshape(-1, 3, xyz.shape[-1]).unbind(1)))

    # -- group law ------------------------------------------------------

    def _apply(self, fn, *points: Point) -> Point:
        shape = torch.broadcast_shapes(*(a.shape for p in points for a in p))
        digits = [point_to_digits(stack_point(Point(*(a.expand(shape) for a in p))))
                  for p in points]
        return unstack_point(point_from_digits(fn(self.params.base_field, *digits)))

    def add(self, p: Point, q: Point) -> Point:
        return self._apply(add16, p, q)

    def double(self, p: Point) -> Point:
        return self._apply(double16, p)

    def neg(self, p: Point) -> Point:
        return Point(p.x, self.field.neg(p.y), p.z)

    def select(self, mask: torch.Tensor, p: Point, q: Point) -> Point:
        """mask ? p : q, elementwise over the batch (mask shape = batch)."""
        m = mask[..., None]
        return Point(*(torch.where(m, a, b) for a, b in zip(p, q)))

    # -- conversions / predicates --------------------------------------

    def is_identity(self, p: Point) -> torch.Tensor:
        return self.field.is_zero(p.z)

    def eq(self, p: Point, q: Point) -> torch.Tensor:
        """Projective equality: X1*Z2 == X2*Z1 and Y1*Z2 == Y2*Z1 (plus
        both-identity)."""
        f = self.field
        cross_x = f.eq(f.mul(p.x, q.z), f.mul(q.x, p.z))
        cross_y = f.eq(f.mul(p.y, q.z), f.mul(q.y, p.z))
        both_id = self.is_identity(p) & self.is_identity(q)
        return (cross_x & cross_y) | both_id

    def to_affine_ints(self, p: Point) -> list[tuple[int, int] | None]:
        """A Point of (8,) or (..., 8) coordinates -> its affine int pairs,
        flattened over the leading axes (None = identity), from ONE read
        of the device."""
        vals = self.field.decode(stack_point(p).reshape(-1, NLIMBS))
        mod = self.field.params.modulus
        out = []
        for k in range(0, len(vals), 3):
            x, y, z = vals[k : k + 3]
            if z == 0:
                out.append(None)
                continue
            zi = pow(z, -1, mod)
            out.append((x * zi % mod, y * zi % mod))
        return out

    # -- scalar multiplication -----------------------------------------

    def scalar_mul_bits(self, p: Point, bits: torch.Tensor) -> Point:
        """Batched double-and-add over a little-endian bit array
        (n_bits, ...): a fixed sequence of complete adds, no data-dependent
        branching (the JAX package's scan, written out as a loop)."""
        fname = self.params.base_field
        base = point_to_digits(stack_point(p))
        acc = identity16(fname, base[0])
        for bit in bits.to(torch.bool).unbind(0):
            acc = select16(bit, add16(fname, acc, base), acc)
            base = double16(fname, base)
        return unstack_point(point_from_digits(acc))


@functools.cache
def get_curve(name: str) -> Curve:
    return Curve(CURVES[name])


# ---------------------------------------------------------------------
# host-side exact helpers (setup only)
# ---------------------------------------------------------------------


@functools.cache
def _tonelli_constants(p: int) -> tuple[int, int, int]:
    """(q, s, c) with p - 1 = q 2^s, q odd, and c = z^q for the least
    non-residue z."""
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    return q, s, pow(z, q, p)


def sqrt_mod(a: int, p: int) -> int | None:
    """Tonelli–Shanks square root mod p (None if non-residue).

    One exponentiation, w = a^((q-1)/2), gives both r = a^((q+1)/2) and
    t = a^q; a is a non-residue exactly when t has order 2^s, which the
    first pass of squarings finds, so no separate Euler test is made."""
    a %= p
    if a == 0:
        return 0
    q, m, c = _tonelli_constants(p)
    w = pow(a, (q - 1) // 2, p)
    r = a * w % p
    t = r * w % p
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
            if i == m:
                return None
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t = t * c % p
        r = r * b % p
    return r


def hash_to_curve_ints(curve_name: str, n: int, domain: bytes = b"vdf_tpu/pedersen") -> list[tuple[int, int]]:
    """Derive n independent curve points by try-and-increment over a
    hash-derived x-stream (setup-time; exact ints).

    Independence rests on the x-coordinates being hash outputs with no
    known discrete logs — the standard Pedersen setup assumption.
    """
    p = get_field(CURVES[curve_name].base_field).params.modulus
    out = []
    ctr = 0
    while len(out) < n:
        h = hashlib.sha512(domain + curve_name.encode() + ctr.to_bytes(8, "little")).digest()
        ctr += 1
        x = int.from_bytes(h, "little") % p
        y2 = (x * x * x + B_COEFF) % p
        y = sqrt_mod(y2, p)
        if y is None:
            continue
        out.append((x, min(y, p - y)))  # canonical sign
    return out
