"""Batched Pasta field arithmetic on torch tensors (the plain versions).

A field element is ``(..., 8)`` ``torch.int32``: the bit patterns of 8
little-endian u32 limbs, Montgomery form with ``R = 2^256``, canonical
(``< p``) at every public method's boundary (see fields/params.py).

The arithmetic is exact integer code that runs on any device.  Inside,
an element is split into 16 half-limbs of 16 bits held in ``int64``
("digits", shape ``(..., 16)``): a digit product is below 2^32, a
schoolbook column of 16 of them below 2^36, so every sum is exact in
int64.  Carries are resolved in parallel (three folding passes, then one
integer addition over the digits' generate/propagate bits, ``resolve``),
so an op costs a few dozen tensor ops whatever the batch size.  The ``*16`` methods work on
digits and are what the plain MinRoot loops (fields/kernels.py) chain,
so a t-round loop converts in and out once.

Bounds on digits: ``mul16`` takes inputs ``< p`` (one of them may be
``< 2p``); its REDC value ``(ab + mp) / R`` is then ``< 2p`` and one
conditional subtraction makes it canonical, as the kernel's
``mont_mul`` does (csrc/field.cuh).  ``4p > R = 2^256``, so lazy sums
stay below ``3p``; ``canon16`` takes any 256-bit value (``< 4p``) to
``< p``.

The public methods (``add``, ``sub``, ``mul``, ``sqr``, ``neg``, ``canon``,
``fold`` and what is built on them) go through fields/kernels.py's
``field_ew`` (K10): on a CUDA tensor a hand-written kernel, on a CPU tensor
this digit code, bit for bit the same.  The digit-level ``*16`` methods
stay plain on every device: the plain versions of the kernels are built
from them.  ``digit_calls()`` counts their calls on tensors off the CPU,
so a run on the card can show that no caller of the main path was left
on the digit code.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..device import resolve_device
from .params import FIELDS, NLIMBS, WINDOW, FieldParams, int_to_limbs, window_digits

ND = 2 * NLIMBS  # 16-bit digits per element
_DMASK = 0xFFFF

_DIGIT_CALLS = [0]  # calls of the *16 methods on a tensor that is not on the CPU
_DIGIT_LOCK = threading.Lock()


def digit_calls() -> int:
    """Calls of ``Field``'s digit-level methods on tensors off the CPU
    since the last ``reset_digit_calls()``."""
    return _DIGIT_CALLS[0]


def reset_digit_calls() -> None:
    with _DIGIT_LOCK:
        _DIGIT_CALLS[0] = 0


def _digit_level(fn):
    """Count a digit-level method's calls on tensors off the CPU."""

    @functools.wraps(fn)
    def counted(self, v, *args, **kwargs):
        if v.device.type != "cpu":
            with _DIGIT_LOCK:
                _DIGIT_CALLS[0] += 1
        return fn(self, v, *args, **kwargs)

    return counted


def to_digits(a: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 limb bit patterns -> (..., 16) int64 digits."""
    w = a.to(torch.int64) & 0xFFFFFFFF
    return torch.stack((w & _DMASK, w >> 16), dim=-1).flatten(-2)


def from_digits(d: torch.Tensor) -> torch.Tensor:
    """(..., 16) int64 digits (< 2^16) -> (..., 8) int32 limb bit patterns."""
    w = d[..., 0::2] | (d[..., 1::2] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _digits_of(v: int, n: int = ND) -> list[int]:
    return [(v >> (16 * k)) & _DMASK for k in range(n)]


def _shift_up(v: torch.Tensor, d: int) -> torch.Tensor:
    """Move digits d places toward the high end (multiply by 2^(16d)),
    keeping the length."""
    return torch.nn.functional.pad(v[..., :-d], (d, 0))


@functools.cache
def _bit_weights(n: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(positions 0..n-1, 2^position), int64 on device."""
    pos = torch.arange(n, dtype=torch.int64, device=device)
    return pos, torch.ones_like(pos) << pos


def resolve(v: torch.Tensor, folds: int = 3) -> torch.Tensor:
    """Carry-resolve nonnegative digits to canonical digits (< 2^16); the
    value is kept modulo 2^(16 * v.shape[-1]).  Each fold takes digits
    below 2^(16 + k) to below 2^16 + 2^k: three folds suffice for digits
    below 2^40, four for digits below 2^62.  The digits are then at most
    2^16: digit i generates a carry iff it is 2^16 and propagates one iff
    it is 2^16 - 1.  With those flags as the bits of G and P, the carry
    into digit i is bit i of ((G | P) + G) ^ P, the carry chain of one
    binary addition whose bits generate and propagate alike."""
    assert v.shape[-1] < 63  # G | P and its carry out fit in int64
    for _ in range(folds):  # -> digits <= 2^16
        v = (v & _DMASK) + _shift_up(v >> 16, 1)
    pos, weight = _bit_weights(v.shape[-1], v.device)
    gen = ((v >> 16) * weight).sum(-1, keepdim=True)
    prop = ((v == _DMASK).to(torch.int64) * weight).sum(-1, keepdim=True)
    carry_in = ((((gen | prop) + gen) ^ prop) >> pos) & 1
    return (v + carry_in) & _DMASK


def _window_pow(mul, sqr, one, base, e: int, window: int):
    """base^e by a fixed window over the ops ``mul`` and ``sqr``: a table of
    the 2^window powers (``one`` is the 0th), the first digit seeds the
    accumulator, then per digit ``window`` squarings and one multiply (none
    for a zero digit)."""
    table = [one, base]
    for _ in range(2, 1 << window):
        table.append(mul(table[-1], base))
    digits = window_digits(e, window)
    acc = table[digits[0]]
    for d in digits[1:]:
        for _ in range(window):
            acc = sqr(acc)
        if d:
            acc = mul(acc, table[d])
    return acc


class _DeviceConsts:
    """One field's digit constants and convolution index on one device."""

    def __init__(self, params: FieldParams, device: torch.device):
        p = params.modulus

        def t(vals):
            return torch.tensor(vals, dtype=torch.int64, device=device)

        self.p = t(_digits_of(p))
        self.pinv = t(_digits_of(params.pinv))
        self.one = t(_digits_of(params.mont_one))
        self.int_one = t(_digits_of(1))  # mul16(a, int_one) = a / R: leaves Montgomery form
        self.r2 = t(_digits_of(params.r * params.r % p))  # mul16(a, r2) = a * R: enters it
        self.comp = {  # 2^256 - k*p: adding it carries out iff v >= k*p
            k: t(_digits_of((1 << 256) - k * p)) for k in (1, 2)
        }
        # 2p as digits that are each >= every digit of a canonical b < p
        # (digit 0 >= 2^16, middle digits >= 2^16 - 1, top digit >= p's),
        # so d2p - b is digit-wise nonnegative and sums to 2p - b.
        d2p = np.asarray(_digits_of(2 * p), dtype=np.int64)
        d2p[0] += 1 << 16
        d2p[1:-1] += _DMASK
        d2p[-1] -= 1
        assert (d2p[:-1] >= _DMASK).all() and d2p[-1] >= p >> 240
        self.d2p = t(d2p.tolist())
        # Schoolbook convolution as one index_add: product a_i * b_j lands
        # in column i + j.
        idx = np.add.outer(np.arange(ND), np.arange(ND)).reshape(-1)
        self.conv_idx = torch.tensor(idx, dtype=torch.int64, device=device)


class Field:
    """Tensor op set for one Pasta prime field."""

    def __init__(self, params: FieldParams):
        self.params = params
        self._consts: dict[torch.device, _DeviceConsts] = {}
        self._encoded: dict[tuple[torch.device, int], torch.Tensor] = {}

    def consts(self, device) -> _DeviceConsts:
        device = torch.device(device)
        c = self._consts.get(device)
        if c is None:
            c = self._consts[device] = _DeviceConsts(self.params, device)
        return c

    # ------------------------------------------------------------------
    # digit-level ops: (..., 16) int64, see the module note for bounds
    # ------------------------------------------------------------------

    def _conv(self, a: torch.Tensor, b: torch.Tensor, c: _DeviceConsts) -> torch.Tensor:
        """Raw schoolbook product digits (..., 32), each < 2^36."""
        outer = (a.unsqueeze(-1) * b.unsqueeze(-2)).flatten(-2)
        shape = torch.broadcast_shapes(a.shape, b.shape)[:-1] + (2 * ND,)
        out = torch.zeros(shape, dtype=torch.int64, device=outer.device)
        return out.index_add_(-1, c.conv_idx, outer)

    @_digit_level
    def mul16(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a*b/R mod p: inputs < p, output < p."""
        c = self.consts(a.device)
        t = self._conv(a, b, c)  # digits < 2^36
        # m = t * (-1/p) mod R, from t's raw low digits (they are t mod R
        # up to multiples of R); columns < 16 * 2^36 * 2^16 = 2^56.
        m = resolve(self._conv(t[..., :ND], c.pinv, c)[..., :ND], folds=4)
        total = resolve(t + self._conv(m, c.p, c))  # < 2p * R < 2^512
        return self.cond_sub_p16(total[..., ND:])  # exact division by R

    @_digit_level
    def sqr16(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul16(a, a)

    @_digit_level
    def add16(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Raw sum (caller keeps it < 2^256)."""
        return resolve(a + b)

    def _cond_sub(self, v: torch.Tensor, k: int) -> torch.Tensor:
        """v - k*p if v >= k*p (v canonical digits)."""
        comp = self.consts(v.device).comp[k]
        w = resolve(torch.nn.functional.pad(v + comp, (0, 1)))
        return torch.where(w[..., ND:] > 0, w[..., :ND], v)

    @_digit_level
    def cond_sub_p16(self, v: torch.Tensor) -> torch.Tensor:
        """< 2p -> < p."""
        return self._cond_sub(v, 1)

    @_digit_level
    def canon16(self, v: torch.Tensor) -> torch.Tensor:
        """Any value < 2^256 (< 4p) -> canonical < p."""
        return self._cond_sub(self._cond_sub(v, 2), 1)

    @_digit_level
    def sub16(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a - b mod p for canonical a, b < p; output < p."""
        d2p = self.consts(a.device).d2p
        return self.canon16(resolve(a + (d2p - b)))  # a + 2p - b < 3p

    @_digit_level
    def pow16(self, base: torch.Tensor, e: int, window: int = WINDOW) -> torch.Tensor:
        """base^e (Montgomery), base < p, e > 0, by ``_window_pow``'s fixed
        window, by default the w=4 one the kernel runs (fields/kernels.py).
        Output < p."""
        one = self.consts(base.device).one.expand_as(base)
        return _window_pow(self.mul16, self.sqr16, one, base, e, window)

    @_digit_level
    def one16(self, like: torch.Tensor) -> torch.Tensor:
        return self.consts(like.device).one.expand_as(like)

    @_digit_level
    def dot16(self, a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
        """sum over batch axis ``dim`` of the Montgomery products a*b/R, for
        at most 8 terms: the raw products are summed before one reduction.
        Inputs < p; the REDC value is < (8 p^2 + R p) / R < 3p < 2^256, and
        ``canon16`` makes it canonical."""
        c = self.consts(a.device)
        shape = torch.broadcast_shapes(a.shape, b.shape)
        if shape[dim] > 8:
            raise ValueError(f"dot16 sums at most 8 products, got {shape[dim]}")
        t = self._conv(a, b, c).sum(dim)  # digits < 8 * 2^36
        m = resolve(self._conv(t[..., :ND], c.pinv, c)[..., :ND], folds=4)
        total = resolve(t + self._conv(m, c.p, c))  # digits < 2^40; value < 2^512
        return self.canon16(total[..., ND:])

    @_digit_level
    def reduce_wide16(self, v: torch.Tensor) -> torch.Tensor:
        """Nonnegative digit sums (..., 16), each below 2^46 (up to 2^30
        canonical values added digit by digit), -> their value mod p,
        canonical.  The value is lo + hi 2^256 with hi < 2^32; hi 2^256 mod p
        is the Montgomery product of hi and R^2 (mul16(hi, r2) = hi R)."""
        c = self.consts(v.device)
        wide = resolve(torch.nn.functional.pad(v, (0, 3)), folds=4)  # 19 digits, 304 bits
        hi = torch.nn.functional.pad(wide[..., ND:], (0, ND - 3))
        hi_r = self.mul16(hi, c.r2.expand_as(hi))
        return self.cond_sub_p16(self.add16(self.canon16(wide[..., :ND]), hi_r))

    @_digit_level
    def from_mont16(self, d: torch.Tensor) -> torch.Tensor:
        """Montgomery digits (any 256-bit value) -> canonical integer digits
        of the value they hold (a / R mod p)."""
        d = self.canon16(d)
        return self.mul16(d, self.consts(d.device).int_one.expand_as(d))

    @_digit_level
    def to_mont16(self, d: torch.Tensor) -> torch.Tensor:
        """Integer digits (any 256-bit value) -> canonical Montgomery digits
        of that integer mod p (a R mod p)."""
        d = self.canon16(d)
        return self.mul16(d, self.consts(d.device).r2.expand_as(d))

    # ------------------------------------------------------------------
    # public ops on (..., 8) int32 canonical Montgomery elements: K10 on a
    # CUDA tensor, the digit code above on a CPU one (fields/kernels.py)
    # ------------------------------------------------------------------

    def _ew(self, op: str, *operands: torch.Tensor) -> torch.Tensor:
        return _kernels.field_ew(self.params.name, op, *operands)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._ew("add", a, b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._ew("sub", a, b)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._ew("mul", a, b)

    def sqr(self, a: torch.Tensor) -> torch.Tensor:
        return self._ew("sqr", a)

    def fold(self, a: torch.Tensor, r: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The linear fold a + r b (one launch on the card)."""
        return self._ew("fold", a, r, b)

    def pow(self, a: torch.Tensor, e: int, window: int = WINDOW) -> torch.Tensor:
        """a^e for e > 0 by ``pow16``'s schedule, each step one op: on the
        card a chain of K10 launches."""
        acc = _window_pow(self.mul, self.sqr, self.const_like(a, 1), a, e, window)
        # One digit: acc is a table entry (``a`` itself, or the constant one).
        return acc.clone() if len(window_digits(e, window)) == 1 else acc

    def canon(self, a: torch.Tensor) -> torch.Tensor:
        """Reduce any 256-bit limb vector to its canonical value < p."""
        return self._ew("canon", a)

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """a^(p-2): the inverse, and 0 for 0."""
        return self.pow(a, self.params.modulus - 2)

    def const_like(self, ref: torch.Tensor, k: int) -> torch.Tensor:
        """The constant k (any int, reduced mod p) shaped and placed like
        ``ref``; each (device, k) is encoded and copied over once."""
        key = (ref.device, int(k) % self.params.modulus)
        c = self._encoded.get(key)
        if c is None:
            c = self._encoded[key] = self.encode(key[1], ref.device)
        return c.expand_as(ref)

    def zero_like(self, ref: torch.Tensor) -> torch.Tensor:
        """Zero shaped and placed like ``ref`` (0 is 0 in Montgomery form)."""
        return torch.zeros_like(ref)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self._ew("neg", a)

    def eq(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Lane-wise equality of the field values (bool over ``...``)."""
        return (self.canon(a) == self.canon(b)).all(dim=-1)

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return (self.canon(a) == 0).all(dim=-1)

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        """Montgomery limbs (any 256-bit pattern) -> canonical integer limbs
        (< p) of the value they hold: a / R mod p, the product of canon(a)
        and the integer 1 (R^-1 in Montgomery form)."""
        return self.mul(self.canon(a), self.const_like(a, self.params.r_inv))

    def to_mont(self, a: torch.Tensor) -> torch.Tensor:
        """Integer limbs (any 256-bit pattern) -> canonical Montgomery limbs
        of that integer mod p: a R mod p, the product of canon(a) and R^2 mod
        p (R in Montgomery form)."""
        return self.mul(self.canon(a), self.const_like(a, self.params.r))

    # ------------------------------------------------------------------
    # host-side conversions (exact Python ints)
    # ------------------------------------------------------------------

    def one(self, device=None) -> torch.Tensor:
        return self.encode(1, device)

    def encode(self, values, device=None) -> torch.Tensor:
        """Python int (or sequence of ints) -> Montgomery limbs: (8,) for
        an int, (n, 8) for a sequence, on ``device`` (None: the card,
        ``default_device()``)."""
        p, to_mont = self.params.modulus, self.params.to_mont
        if isinstance(values, (int, np.integer)):
            arr = int_to_limbs(to_mont(int(values) % p))
        else:
            buf = b"".join(to_mont(int(v) % p).to_bytes(32, "little") for v in values)
            arr = np.frombuffer(buf, dtype="<u4").reshape(-1, NLIMBS)
        return torch.from_numpy(arr.view(np.int32).copy()).to(resolve_device(device))

    def encode_canonical(self, values, device=None) -> torch.Tensor:
        """Ints in [0, 2^256) -> (n, 8) CANONICAL integer limbs (no Montgomery
        factor) on ``device`` (None: the card), by ``to_bytes`` and
        ``np.frombuffer``: no multiply on the host.  The device plane lifts
        them with K3's domain mode (``curves.kernels.canon_mont``, which
        reduces mod p), one launch in place of a bigint mulmod a value."""
        buf = b"".join(int(v).to_bytes(32, "little") for v in values)
        arr = np.frombuffer(buf, dtype="<u4").reshape(-1, NLIMBS)
        return torch.from_numpy(arr.view(np.int32).copy()).to(resolve_device(device))

    def encode_canonical_u64(self, words: np.ndarray, device=None) -> torch.Tensor:
        """``(n, 4)`` little-endian uint64 words of canonical values ->
        ``encode_canonical``'s ``(n, 8)`` int32 limbs on ``device``: a view
        of the same bytes and one host-to-device copy."""
        arr = np.ascontiguousarray(words, dtype="<u8").view(np.int32).reshape(-1, NLIMBS)
        return torch.from_numpy(arr).to(resolve_device(device))

    def decode(self, a: torch.Tensor):
        """Montgomery limbs -> canonical Python int(s): an int for (8,),
        a list for (..., 8) (flattened over the leading axes)."""
        buf = a.detach().cpu().contiguous().numpy().astype("<u4").tobytes()
        p, r_inv = self.params.modulus, self.params.r_inv
        vals = [
            int.from_bytes(buf[k : k + 32], "little") * r_inv % p
            for k in range(0, len(buf), 32)
        ]
        return vals[0] if a.dim() == 1 else vals


@functools.cache
def get_field(name: str) -> Field:
    return Field(FIELDS[name])


from . import kernels as _kernels  # noqa: E402  (fields/kernels.py imports this module)
