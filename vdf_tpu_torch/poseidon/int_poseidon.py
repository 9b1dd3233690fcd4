"""Host-integer Poseidon permutation + transcript (control-plane twin).

A copy of ``vdf_tpu.poseidon.int_poseidon`` (the port cannot import that
package: it pulls in jax).  The Fiat–Shamir transcript over Python ints
must produce values identical to the tensor ``Transcript``
(poseidon/permutation.py) and to the in-circuit transcript gadget
(nova/gadgets/sponge.py), because the two-curve IVC's host-derived
challenges are re-derived inside the augmented circuit.  All three share
the constants from ``poseidon/params.py``; tests/test_torch_poseidon.py
and tests/test_torch_augmented.py lock the parity.

The permutation runs in C++ (native/pasta.cpp), which the port requires:
``checked_native`` builds the library at first use and holds its
permutation against the Python rounds here on a fixed state, and raises
where either fails.  The Python rounds stay as the reference the tests
hold the native tier against.
"""

from __future__ import annotations

import functools

from .. import native
from ..fields.int_field import get_int_field
from .params import FULL_ROUNDS, partial_rounds, round_constants


@functools.cache
def checked_native():
    """The native tier, ``vdf_tpu_torch.native``, once its permutation has
    given the Python rounds' values on a fixed state: the first call builds
    and loads the library, and raises RuntimeError, as ``native.load`` does
    for a failed build, where the two disagree.  Every native permutation,
    the ``*_words`` form included, is reached through it."""
    got = native.poseidon_permute_native("Fq", [1, 2, 3, 4, 5])
    if got != _permute_ints_py("Fq", [1, 2, 3, 4, 5], 5):
        raise RuntimeError("the native Poseidon permutation disagrees with the Python rounds")
    return native


def permute_ints(field_name: str, state: list[int], width: int | None = None) -> list[int]:
    """One Poseidon permutation over canonical ints, in C++."""
    width = width or len(state)
    assert len(state) == width
    return checked_native().poseidon_permute_native(field_name, [int(v) for v in state])


def _permute_ints_py(field_name: str, state: list[int], width: int) -> list[int]:
    p = get_int_field(field_name).p
    rc, mds = round_constants(field_name, width)
    r_p = partial_rounds(width)
    half = FULL_ROUNDS // 2

    def sbox(x: int) -> int:
        x2 = x * x % p
        return x2 * x2 % p * x % p

    def mds_mul(s: list[int]) -> list[int]:
        return [sum(mds[i][j] * s[j] for j in range(width)) % p for i in range(width)]

    s = list(state)
    for r in range(half):
        s = [(v + c) % p for v, c in zip(s, rc[r])]
        s = mds_mul([sbox(v) for v in s])
    for r in range(half, half + r_p):
        s = [(v + c) % p for v, c in zip(s, rc[r])]
        s = mds_mul([sbox(s[0])] + s[1:])
    for r in range(half + r_p, half + r_p + FULL_ROUNDS - half):
        s = [(v + c) % p for v, c in zip(s, rc[r])]
        s = mds_mul([sbox(v) for v in s])
    return s


class IntTranscript:
    """Duplex-sponge transcript over ints; logic mirrors ``Transcript``
    (poseidon/permutation.py) line for line: rate = width-1, capacity
    element 0 takes a per-chunk length tag, squeeze returns state[1] and
    domain-separates successive squeezes by bumping state[0]."""

    def __init__(self, field_name: str, width: int = 5):
        self.field_name = field_name
        self.p = get_int_field(field_name).p
        self.width = width
        self.rate = width - 1
        self.buf: list[int] = []
        self.state: list[int] | None = None

    def absorb(self, *elements: int) -> None:
        self.buf.extend(int(e) % self.p for e in elements)

    def flush(self) -> None:
        if self.buf or self.state is None:
            self._flush()

    def _flush(self) -> None:
        if self.state is None:
            self.state = [0] * self.width
        buf, self.buf = self.buf, []
        for k in range(0, max(len(buf), 1), self.rate):
            chunk = buf[k : k + self.rate]
            st = list(self.state)
            st[0] = (st[0] + len(chunk) + 1) % self.p
            for j, el in enumerate(chunk):
                st[1 + j] = (st[1 + j] + el) % self.p
            self.state = permute_ints(self.field_name, st, self.width)

    def squeeze(self) -> int:
        self._flush()
        out = self.state[1]
        self.state = [(self.state[0] + 1) % self.p] + self.state[1:]
        self.buf = []
        return out
