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

A prover needs some permutations twice: the augmented circuit re-derives
the host's fold challenge, and each input hash repeats the output hash of
the previous synthesis on its side.  ``permute_memo`` serves those from a
bounded table keyed by the input state, with the S-box values the circuit
allocates; its two callers are the in-circuit sponge's value-only pass
(nova/gadgets/sponge.py) and ``MemoTranscript``, the fold challenge's
transcript (nova/ivc.py::fold_challenge).  Every other transcript permutes
through ``permute_ints`` and leaves the table alone.
"""

from __future__ import annotations

import collections
import functools
import threading

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


# The memo: (field name, input state) -> (output state, S-box triples), least
# recently used first.  A step inserts ~23 entries and reads an output hash's
# entry one step later, so 128 entries (~1.2 MB) hold four chains interleaved.
MEMO_ENTRIES = 128
_MEMO: collections.OrderedDict = collections.OrderedDict()
_MEMO_LOCK = threading.Lock()

# How each permutation of the in-circuit sponge's value-only pass was served:
# from the memo or computed.  Never reset; syntheses on several threads
# (prove_interleaved) count under the lock.
PERMS = {"reused": 0, "computed": 0}


def permute_memo(field_name: str, state: list[int], count: bool = False):
    """One permutation of canonical ints with every S-box's (x^2, x^4, x^5):
    -> (the output state as a tuple of ints, the ``(3 n_sbox, 4)`` uint64
    words of ``poseidon_permute_native_words``, read-only), from the memo
    where this input was permuted before.  A permutation is a pure function
    of its input, so a hit returns what a miss computes.  ``count``: the
    in-circuit sponge's call, counted in ``PERMS``."""
    key = (field_name, tuple(int(v) for v in state))
    with _MEMO_LOCK:
        got = _MEMO.get(key)
        if got is not None:
            _MEMO.move_to_end(key)
            if count:
                PERMS["reused"] += 1
            return got
    out, triples = checked_native().poseidon_permute_native_words(field_name, list(key[1]))
    triples.flags.writeable = False
    got = (tuple(out), triples)
    with _MEMO_LOCK:
        _MEMO[key] = got
        while len(_MEMO) > MEMO_ENTRIES:
            _MEMO.popitem(last=False)
        if count:
            PERMS["computed"] += 1
    return got


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
            self.state = self._permute(st)

    def _permute(self, st: list[int]) -> list[int]:
        return permute_ints(self.field_name, st, self.width)

    def squeeze(self) -> int:
        self._flush()
        out = self.state[1]
        self.state = [(self.state[0] + 1) % self.p] + self.state[1:]
        self.buf = []
        return out


class MemoTranscript(IntTranscript):
    """``IntTranscript`` whose permutations go through ``permute_memo``: the
    fold challenge's transcript, whose every permutation the next synthesis
    re-derives in circuit and then finds in the memo."""

    def _permute(self, st: list[int]) -> list[int]:
        return list(permute_memo(self.field_name, st)[0])
