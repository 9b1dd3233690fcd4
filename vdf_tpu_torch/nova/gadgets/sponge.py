"""In-circuit Poseidon permutation + duplex transcript gadget.

This is the R1CS form of the framework's random oracle — the piece
neptune provides to nova-snark for in-circuit fold verification
(SURVEY.md §2 D4).  It must agree value-for-value with BOTH host
transcripts: the device ``Transcript`` (poseidon/permutation.py) and the
control-plane ``IntTranscript`` (poseidon/int_poseidon.py) — same
constants, same duplex/padding schedule, same squeeze semantics.
Parity is locked by tests/test_torch_augmented.py.

Costs: one permutation = width sboxes per full round (3 constraints
each: x^2, x^4, x^5) + 1 sbox per partial round; the MDS mix and round
constants are free linear combinations.

A copy of ``vdf_tpu.nova.gadgets.sponge`` (host-integer code; the port cannot import that
package, which pulls in jax), its imports re-pointed at the port.
"""

from __future__ import annotations

from ...poseidon.int_poseidon import permute_memo
from ...poseidon.params import FULL_ROUNDS, partial_rounds, round_constants
from ...r1cs.cs import ONE, LinearCombination
from ...r1cs.gadgets import AllocatedNum, Num, _is_witness
from .ec import _num_add, const_num, num_mul


def _sbox(cs, x, name: str) -> AllocatedNum:
    """x^5 via x^2, x^4, x^5 — 3 constraints."""
    x2 = num_mul(cs, x, x, f"{name}_sq")
    x4 = num_mul(cs, x2, x2, f"{name}_qd")
    return num_mul(cs, x4, x, f"{name}_x5")


def permute_gadget(cs, field_name: str, state: list, name: str = "pos") -> list:
    """One Poseidon permutation over a list of Nums (width = len(state)).
    Mirrors poseidon/int_poseidon.py:permute_ints round for round.

    The value-only pass over host ints (``cs.blocks``) reads no linear
    combination: the C++ permutation emits every S-box's (x^2, x^4, x^5) in
    this gadget's allocation order, allocated as one block, through
    ``permute_memo``, which serves an input the prover permuted before (the
    host's fold challenge, the previous output hash).  The shape pass and
    ``check=True`` take the rounds below, with their linear
    combinations."""
    if getattr(cs, "blocks", False):
        out_state, triples = permute_memo(
            field_name, [int(el.value) for el in state], count=True
        )
        cs.alloc_block(triples)
        empty = LinearCombination()
        return [Num(empty, v) for v in out_state]
    width = len(state)
    rc, mds = round_constants(field_name, width)
    r_p = partial_rounds(width)
    half = FULL_ROUNDS // 2

    def add_rc(s: list, r: int) -> list:
        out = []
        for j, el in enumerate(s):
            k = rc[r][j]
            value = None
            if _is_witness(cs):
                value = cs.field.add(el.value, k)
            out.append(Num(el.lc() + LinearCombination.of(ONE, k), value))
        return out

    def mds_mul(s: list) -> list:
        out = []
        lcs = [el.lc() for el in s]
        for i in range(width):
            # single-dict accumulation: avoids width copies of growing
            # LC dicts per output row (the synthesis hot loop)
            acc: dict = {}
            get = acc.get
            for j in range(width):
                m = mds[i][j]
                for v, c in lcs[j].terms.items():
                    acc[v] = get(v, 0) + c * m
            value = None
            if _is_witness(cs):
                value = 0
                for j in range(width):
                    value = cs.field.add(
                        value, cs.field.mul(s[j].value, mds[i][j] % cs.field.params.modulus)
                    )
            out.append(Num(LinearCombination(acc), value))
        return out

    s = [el if isinstance(el, Num) else Num.from_alloc(el) for el in state]
    rnd = 0
    for r in range(half):
        s = add_rc(s, rnd)
        s = mds_mul([_sbox(cs, v, f"{name}_f{rnd}_{j}") for j, v in enumerate(s)])
        rnd += 1
    for r in range(r_p):
        s = add_rc(s, rnd)
        s = mds_mul([_sbox(cs, s[0], f"{name}_p{rnd}")] + s[1:])
        rnd += 1
    for r in range(FULL_ROUNDS - half):
        s = add_rc(s, rnd)
        s = mds_mul([_sbox(cs, v, f"{name}_g{rnd}_{j}") for j, v in enumerate(s)])
        rnd += 1
    return s


class TranscriptGadget:
    """Circuit twin of IntTranscript: rate = width-1, length-tagged
    chunks into the capacity element, squeeze = state[1] with a
    domain-separation bump of state[0]."""

    def __init__(self, cs, field_name: str, width: int = 5, name: str = "tr"):
        self.cs = cs
        self.field_name = field_name
        self.width = width
        self.rate = width - 1
        self.name = name
        self._n = 0
        self.buf: list = []
        self.state: list | None = None

    def absorb(self, *elements) -> None:
        self.buf.extend(
            el if isinstance(el, Num) else Num.from_alloc(el) for el in elements
        )

    def _flush(self) -> None:
        cs = self.cs
        if self.state is None:
            self.state = [const_num(cs, 0) for _ in range(self.width)]
        buf, self.buf = self.buf, []
        for k in range(0, max(len(buf), 1), self.rate):
            chunk = buf[k : k + self.rate]
            st = list(self.state)
            st[0] = _num_add(cs, st[0], const_num(cs, len(chunk) + 1))
            for j, el in enumerate(chunk):
                st[1 + j] = _num_add(cs, st[1 + j], el)
            self._n += 1
            self.state = permute_gadget(
                cs, self.field_name, st, f"{self.name}_perm{self._n}"
            )

    def squeeze(self) -> Num:
        self._flush()  # unconditional: matches IntTranscript/Transcript
        out = self.state[1]
        self.state = [_num_add(self.cs, self.state[0], const_num(self.cs, 1))] + self.state[1:]
        self.buf = []
        return out
