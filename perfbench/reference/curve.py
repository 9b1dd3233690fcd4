"""Pasta curve arithmetic and a multi-scalar multiplication on Python ints.

Written for the benchmark's reference, apart from the program: Jacobian
coordinates (X, Y, Z) for y^2 = x^3 + 5 (a = 0), the identity as Z = 0,
affine points as (x, y) tuples or None.  ``msm`` is a plain bucket method
over windows of ``c`` bits.
"""

from __future__ import annotations

from .frozen.fields.params import P_FP, P_FQ

B = 5
# curve -> (base field modulus, group order)
CURVES = {"pallas": (P_FP, P_FQ), "vesta": (P_FQ, P_FP)}
INF = (1, 1, 0)


def dbl(P, p):
    x, y, z = P
    if z == 0 or y == 0:
        return INF
    a = x * x % p
    b = y * y % p
    c = b * b % p
    d = 2 * ((x + b) * (x + b) - a - c) % p
    e = 3 * a % p
    x3 = (e * e - 2 * d) % p
    y3 = (e * (d - x3) - 8 * c) % p
    z3 = 2 * y * z % p
    return (x3, y3, z3)


def add(P, Q, p):
    x1, y1, z1 = P
    x2, y2, z2 = Q
    if z1 == 0:
        return Q
    if z2 == 0:
        return P
    z1z1 = z1 * z1 % p
    z2z2 = z2 * z2 % p
    u1 = x1 * z2z2 % p
    u2 = x2 * z1z1 % p
    s1 = y1 * z2 % p * z2z2 % p
    s2 = y2 * z1 % p * z1z1 % p
    h = (u2 - u1) % p
    r = (s2 - s1) % p
    if h == 0:
        return dbl(P, p) if r == 0 else INF
    hh = h * h % p
    hhh = h * hh % p
    v = u1 * hh % p
    x3 = (r * r - hhh - 2 * v) % p
    y3 = (r * (v - x3) - s1 * hhh) % p
    z3 = z1 * z2 % p * h % p
    return (x3, y3, z3)


def add_affine(P, a, p):
    """P + a for an affine point a = (x, y) (not None)."""
    x1, y1, z1 = P
    if z1 == 0:
        return (a[0], a[1], 1)
    z1z1 = z1 * z1 % p
    u2 = a[0] * z1z1 % p
    s2 = a[1] * z1 % p * z1z1 % p
    h = (u2 - x1) % p
    r = (s2 - y1) % p
    if h == 0:
        return dbl(P, p) if r == 0 else INF
    hh = h * h % p
    hhh = h * hh % p
    v = x1 * hh % p
    x3 = (r * r - hhh - 2 * v) % p
    y3 = (r * (v - x3) - y1 * hhh) % p
    return (x3, y3, z1 * h % p)


def to_affine(P, p):
    if P[2] % p == 0:
        return None
    zi = pow(P[2], -1, p)
    zi2 = zi * zi % p
    return (P[0] * zi2 % p, P[1] * zi2 % p * zi % p)


def from_affine(a):
    return INF if a is None else (a[0], a[1], 1)


def mul(P, k, p):
    acc = INF
    for bit in bin(k)[2:] if k > 0 else "":
        acc = dbl(acc, p)
        if bit == "1":
            acc = add(acc, P, p)
    return acc


def on_curve(a, p) -> bool:
    return a is None or (a[1] * a[1] - a[0] * a[0] * a[0] - B) % p == 0


def msm(curve: str, points, scalars, c: int = 12):
    """sum_i scalars[i] * points[i] (affine points, None allowed) -> affine."""
    p, q = CURVES[curve]
    pairs = [(s % q, g) for s, g in zip(scalars, points) if g is not None and s % q]
    acc = INF
    if not pairs:
        return None
    nbits = max(s for s, _ in pairs).bit_length()
    mask = (1 << c) - 1
    for w in reversed(range(0, nbits, c)):
        for _ in range(c if acc[2] else 0):
            acc = dbl(acc, p)
        buckets = {}
        for s, g in pairs:
            d = (s >> w) & mask
            if d:
                b = buckets.get(d)
                buckets[d] = (g[0], g[1], 1) if b is None else add_affine(b, g, p)
        run = total = INF
        for d in range(mask, 0, -1):
            b = buckets.get(d)
            if b is not None:
                run = add(run, b, p)
            if run[2]:
                total = add(total, run, p)
        acc = add(acc, total, p)
    return to_affine(acc, p)
