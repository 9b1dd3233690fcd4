"""Pasta curve constants and the generators' derivation, on host ints.

Frozen from the port's ``curves/point.py`` (its constants and its
setup-time helpers: Tonelli-Shanks and the try-and-increment derivation),
so the reference derives the Pedersen generators itself.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib

from ..fields import get_field

B_COEFF = 5  # y^2 = x^3 + 5 for both Pasta curves
B3 = 15  # 3*b, used by the complete formulas


@dataclasses.dataclass(frozen=True)
class CurveParams:
    name: str
    base_field: str  # coordinates live here
    scalar_field: str  # group order field


PALLAS = CurveParams("pallas", base_field="Fp", scalar_field="Fq")
VESTA = CurveParams("vesta", base_field="Fq", scalar_field="Fp")
CURVES = {"pallas": PALLAS, "vesta": VESTA}


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
