"""MinRoot on Python ints (the reference's delay function).

    forward  x' = (x + y)^(1/5),  y' = x + i,  i' = i + 1
    inverse  i' = i - 1,  x' = y - i',  y' = x^5 - x'

over a Pasta field, the 1/5 power being x^e with e = 5^-1 mod (p - 1).
The inverse round is a bijection's inverse, so ``back(forward(s, n), n) ==
s``: a state is n forward rounds of a start exactly when n inverse rounds
take it back there.
"""

from __future__ import annotations

from .frozen.fields.params import P_FP, P_FQ

MODULI = {"Fp": P_FP, "Fq": P_FQ}


def forward(state, n: int, p: int):
    x, y, i = state
    e = pow(5, -1, p - 1)
    for _ in range(n):
        x, y, i = pow((x + y) % p, e, p), (x + i) % p, (i + 1) % p
    return x, y, i


def back(state, n: int, p: int):
    x, y, i = state
    for _ in range(n):
        i = (i - 1) % p
        nx = (y - i) % p
        x, y = nx, (pow(x, 5, p) - nx) % p
    return x, y, i
