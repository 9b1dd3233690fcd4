"""Poseidon permutation, sponge hash, and random-oracle transcript on
torch tensors (port of ``vdf_tpu.poseidon.permutation``).

Batched over leading axes like every field op: a state is a list of
``width`` ``(..., 8)`` Montgomery tensors.  Used for Nova's Fiat–Shamir
transcript; the constants are those of ``poseidon/params.py``, shared
with the host-integer twin (``int_poseidon``).

The JAX package compiles the rounds as three ``lax.scan``s behind a
shape-keyed jit to bound XLA's graph size; here they are plain loops.
Inside a permutation the state stays in 16-bit digits (fields/ops.py), and
the MDS product of a round is one ``dot16``: the ``width`` raw products of
a row are summed before a single Montgomery reduction.
"""

from __future__ import annotations

import functools

import torch

from ..fields import Field, get_field
from ..fields.ops import from_digits, to_digits
from .params import FULL_ROUNDS, generate_constants, partial_rounds

_DOT_TERMS = 8  # Field.dot16 sums at most this many products


class Poseidon:
    """Poseidon-128 permutation over one Pasta field, fixed width."""

    def __init__(self, field: Field, width: int):
        assert width >= 2
        self.field = field
        self.width = width
        self.r_p = partial_rounds(width)
        self._rc_ints, self._mds_ints = generate_constants(field.params.name, width)
        self._consts: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def _device_consts(self, device: torch.device):
        """(rc (rounds, w, 16), mds (w, w, 16)) Montgomery digits on device."""
        c = self._consts.get(device)
        if c is None:
            f, w = self.field, self.width
            rc = to_digits(f.encode(list(self._rc_ints), device)).reshape(-1, w, 16)
            mds = to_digits(f.encode([v for row in self._mds_ints for v in row], device))
            c = self._consts[device] = (rc, mds.reshape(w, w, 16))
        return c

    def _sbox(self, x: torch.Tensor) -> torch.Tensor:
        f = self.field
        return f.mul16(f.sqr16(f.sqr16(x)), x)  # x^5

    def _mds_mul(self, state: torch.Tensor, mds: torch.Tensor) -> torch.Tensor:
        """state (w, ..., 16) -> (w, ..., 16): row i = sum_j mds[i][j] state[j]."""
        f, w = self.field, self.width
        mds = mds.reshape(w, w, *(1,) * (state.dim() - 2), 16)
        acc = None
        for j in range(0, w, _DOT_TERMS):
            part = f.dot16(mds[:, j : j + _DOT_TERMS], state[None, j : j + _DOT_TERMS], dim=1)
            acc = part if acc is None else f.cond_sub_p16(f.add16(acc, part))
        return acc

    def permute_array(self, state: torch.Tensor) -> torch.Tensor:
        """state: (w, ..., 8) Montgomery -> same."""
        f, w = self.field, self.width
        assert state.shape[0] == w
        rc, mds = self._device_consts(state.device)
        rc = rc.reshape(rc.shape[0], w, *(1,) * (state.dim() - 2), 16)
        half = FULL_ROUNDS // 2
        s = to_digits(state)
        for r in range(FULL_ROUNDS + self.r_p):
            s = f.cond_sub_p16(f.add16(s, rc[r].expand_as(s)))
            if half <= r < half + self.r_p:  # partial round: the S-box on element 0
                s = torch.cat([self._sbox(s[0:1]), s[1:]], dim=0)
            else:
                s = self._sbox(s)
            s = self._mds_mul(s, mds)
        return from_digits(s)

    def permute(self, state: list) -> list:
        """List-of-tensors facade over permute_array."""
        out = self.permute_array(torch.stack(list(state)))
        return [out[k] for k in range(self.width)]


@functools.lru_cache(maxsize=64)
def get_poseidon(field_name: str, width: int) -> Poseidon:
    return Poseidon(get_field(field_name), width)


def hash_fixed(field_name: str, inputs: list) -> torch.Tensor:
    """Fixed-arity hash: domain-tagged single permutation, first element out.

    Domain tag (element 0) is ``2^arity - 1``, matching the constant-
    input-length convention of the neptune-style API.
    """
    arity = len(inputs)
    pos = get_poseidon(field_name, arity + 1)
    tag = pos.field.const_like(inputs[0], (1 << arity) - 1)
    return pos.permute([tag] + list(inputs))[0]


class Transcript:
    """Duplex-sponge Fiat–Shamir transcript (Nova's RO equivalent).

    Absorb any number of field elements, then squeeze challenge scalars.
    Rate = width - 1, capacity = 1 (the running state element 0).  The
    tensors absorbed decide the device.
    """

    def __init__(self, field_name: str, width: int = 5):
        self.pos = get_poseidon(field_name, width)
        self.field_name = field_name
        self.rate = width - 1
        self.buf: list = []
        self.state = None

    # -- explicit state (to carry a transcript from step to step) --------

    def export_state(self):
        """(state tuple, buffered tuple) of tensors."""
        return (
            tuple(self.state) if self.state is not None else (),
            tuple(self.buf),
        )

    @classmethod
    def from_state(cls, field_name: str, exported, width: int = 5) -> "Transcript":
        tr = cls(field_name, width)
        state, buf = exported
        tr.state = list(state) if state else None
        tr.buf = list(buf)
        return tr

    def absorb(self, *elements: torch.Tensor) -> None:
        self.buf.extend(elements)

    def flush(self) -> None:
        """Absorb any buffered elements into the state now."""
        if self.buf or self.state is None:
            self._flush()

    def _flush(self) -> None:
        f = self.pos.field
        if self.state is None:
            if not self.buf:
                raise ValueError("an empty transcript has no device yet: absorb first")
            self.state = [torch.zeros_like(self.buf[0])] * self.pos.width
        buf, self.buf = self.buf, []
        for k in range(0, max(len(buf), 1), self.rate):
            chunk = buf[k : k + self.rate]
            st = list(self.state)
            # Length/padding tag into the capacity element: distinguishes
            # absorbing zeros from absorbing nothing and full chunks from
            # partial ones (duplex pad-10*-equivalent).
            st[0] = f.add(st[0], f.const_like(st[0], len(chunk) + 1))
            for j, el in enumerate(chunk):
                st[1 + j] = f.add(st[1 + j], el)
            self.state = self.pos.permute(st)

    def squeeze(self) -> torch.Tensor:
        """One field element of challenge material."""
        self._flush()
        out = self.state[1]
        # Domain-separate successive squeezes.
        f = self.pos.field
        self.state = [f.add(self.state[0], f.const_like(self.state[0], 1))] + self.state[1:]
        self.buf = []
        return out
