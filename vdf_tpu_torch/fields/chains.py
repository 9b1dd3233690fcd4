"""Fixed-exponent exponentiation programs (addition chains) and schedules.

Port of ``vdf_tpu.fields.chains``.  The VDF's slow direction is
``x^inv_alpha`` with a fixed 254-bit exponent; the reference offers four
strategies for it (``EvalMode``, src/minroot.rs:14-31, 77-196).  Each is a
straight-line *program* of square/multiply ops generated on the host:

  * ``ltr_sequential``  — plain left-to-right binary square-and-multiply.
  * ``ltr_add_chain``   — exploits the Pasta inv_alpha structure
    ``e = u * 2^128 + v`` with ``u = 0x33 repeated`` (a consequence of
    ``e = 5^{-1} mod (p-1)``): Horner over the repeating byte, then a
    sliding-window scan of the low 128 bits (~253 sq + ~50 mul).  Falls
    back to a generic sliding window for unstructured exponents.
  * ``rtl_sequential``  — right-to-left binary.
  * ``rtl_add_chain``   — RTL over the low 128 bits, then the repeating
    byte tail handled with one multiply per byte period.

Every generated program is checked against the exponent at build time
(``_check_program`` tracks each register's exponent as an integer), so a
generator bug cannot silently produce a wrong chain.  The programs are the
JAX package's, op for op.

Two executors run on ``(..., 8)`` Montgomery tensors with the port's
field arithmetic (fields/ops.py): on a CPU tensor on its digit form,
converting once a call; on the card through ``Field.sqr``/``Field.mul``,
one K10 launch a step.  ``pow_fixed`` runs a program register by register, and
``pow_window`` / ``pow_rtl`` run the uniform schedules that
``MinRootVDF.forward_step`` selects by mode (an LTR window scan, or RTL
binary).  The JAX package's ``pow_fixed_scan*`` forms exist to shrink an
XLA graph and are not ported: eager torch has no graph to shrink, and the
two schedules above do the same work.
"""

from __future__ import annotations

import functools

import torch

from .ops import Field, from_digits, to_digits

REPEAT_BYTE_SECTION_BITS = 128


class _Builder:
    """Straight-line SSA program builder: reg 0 is the input."""

    def __init__(self):
        self.ops: list[tuple] = []
        self.n = 1

    def sqr(self, a: int) -> int:
        self.ops.append(("sqr", self.n, a))
        self.n += 1
        return self.n - 1

    def mul(self, a: int, b: int) -> int:
        self.ops.append(("mul", self.n, a, b))
        self.n += 1
        return self.n - 1

    def sqr_n(self, a: int, n: int) -> int:
        for _ in range(n):
            a = self.sqr(a)
        return a


def _odd_power_table(b: _Builder, w: int) -> dict[int, int]:
    """Registers holding x^k for odd k < 2^w (x^2 built as a stepping stone)."""
    tbl = {1: 0}
    if w <= 1:
        return tbl
    x2 = b.sqr(0)
    cur = 0
    for odd in range(3, 1 << w, 2):
        cur = b.mul(cur, x2)
        tbl[odd] = cur
    return tbl


def _window_scan(b: _Builder, bits: str, acc: int | None, tbl: dict, w: int) -> int:
    """Continue an LTR scan over `bits` using sliding windows of width <= w."""
    i = 0
    while i < len(bits):
        if bits[i] == "0":
            if acc is not None:
                acc = b.sqr(acc)
            i += 1
        else:
            j = min(i + w, len(bits))
            while bits[j - 1] == "0":
                j -= 1
            val = int(bits[i:j], 2)
            if acc is None:
                acc = tbl[val]
            else:
                acc = b.sqr_n(acc, j - i)
                acc = b.mul(acc, tbl[val])
            i = j
    assert acc is not None
    return acc


def _repeat_byte_structure(e: int) -> tuple[int, int] | None:
    """If the bits of e above the low 128 form a repeating byte, return
    (byte, low128).  Both Pasta inv_alpha exponents have byte 0x33 there."""
    v = e & ((1 << REPEAT_BYTE_SECTION_BITS) - 1)
    u = e >> REPEAT_BYTE_SECTION_BITS
    if u == 0:
        return None
    byte = u & 0xFF
    n_bytes = (u.bit_length() + 7) // 8
    expect = int.from_bytes(bytes([byte]) * n_bytes, "little")
    if byte != 0 and expect == u:
        return byte, v
    return None


def gen_ltr_sequential(e: int) -> tuple[list[tuple], int]:
    b = _Builder()
    acc = 0
    for bit in bin(e)[3:]:
        acc = b.sqr(acc)
        if bit == "1":
            acc = b.mul(acc, 0)
    return b.ops, acc


def gen_rtl_sequential(e: int) -> tuple[list[tuple], int]:
    b = _Builder()
    s = 0
    acc = None
    nbits = e.bit_length()
    for k in range(nbits):
        if (e >> k) & 1:
            acc = s if acc is None else b.mul(acc, s)
        if k + 1 < nbits:
            s = b.sqr(s)
    assert acc is not None
    return b.ops, acc


def gen_sliding_window(e: int, w: int = 4) -> tuple[list[tuple], int]:
    b = _Builder()
    tbl = _odd_power_table(b, w)
    acc = _window_scan(b, bin(e)[2:], None, tbl, w)
    return b.ops, acc


def gen_ltr_add_chain(e: int, w: int = 4) -> tuple[list[tuple], int]:
    structure = _repeat_byte_structure(e)
    if structure is None:
        return gen_sliding_window(e, w)
    byte, v = structure
    n_bytes = ((e >> REPEAT_BYTE_SECTION_BITS).bit_length() + 7) // 8
    b = _Builder()
    tbl = _odd_power_table(b, w)
    # x^byte via the shared window table, then Horner over the byte string:
    # acc <- acc^(2^8) * x^byte, repeated.
    acc_byte = _window_scan(b, bin(byte)[2:], None, tbl, w)
    acc = acc_byte
    for _ in range(n_bytes - 1):
        acc = b.sqr_n(acc, 8)
        acc = b.mul(acc, acc_byte)
    # Continue LTR through the low 128 bits (leading zeros as squarings).
    low_bits = bin(v)[2:].zfill(REPEAT_BYTE_SECTION_BITS)
    acc = _window_scan(b, low_bits, acc, tbl, w)
    return b.ops, acc


def gen_rtl_add_chain(e: int) -> tuple[list[tuple], int]:
    structure = _repeat_byte_structure(e)
    if structure is None:
        return gen_rtl_sequential(e)
    byte, v = structure
    n_bytes = ((e >> REPEAT_BYTE_SECTION_BITS).bit_length() + 7) // 8
    b = _Builder()
    # RTL over the low 128 bits, keeping the running square.
    s = 0
    acc = None
    for k in range(REPEAT_BYTE_SECTION_BITS):
        if (v >> k) & 1:
            acc = s if acc is None else b.mul(acc, s)
        s = b.sqr(s)
    # s == x^(2^128).  t = s^byte (a short LTR chain), then one multiply per
    # byte period: acc *= t^(2^(8k)).
    t = None
    for bit in bin(byte)[2:]:
        t = b.sqr(t) if t is not None else None
        if bit == "1":
            t = s if t is None else b.mul(t, s)
    assert t is not None
    acc = t if acc is None else b.mul(acc, t)
    for _ in range(n_bytes - 1):
        t = b.sqr_n(t, 8)
        acc = b.mul(acc, t)
    return b.ops, acc


_GENERATORS = {
    "ltr_sequential": gen_ltr_sequential,
    "ltr_add_chain": gen_ltr_add_chain,
    "rtl_sequential": gen_rtl_sequential,
    "rtl_add_chain": gen_rtl_add_chain,
}


def _check_program(ops: list[tuple], out_reg: int, e: int) -> None:
    """Verify exactly: track each register's exponent as an integer."""
    exp = {0: 1}
    for op in ops:
        if op[0] == "sqr":
            exp[op[1]] = 2 * exp[op[2]]
        else:
            exp[op[1]] = exp[op[2]] + exp[op[3]]
    if exp[out_reg] != e:
        raise AssertionError(f"generated chain computes x^{exp[out_reg]}, not x^{e}")


@functools.lru_cache(maxsize=None)
def get_program(e: int, mode: str) -> tuple[tuple[tuple, ...], int]:
    """The checked program of ``mode`` for x^e: (ops, output register)."""
    if e <= 0:
        raise ValueError("exponent must be positive")
    ops, out = _GENERATORS[mode](e)
    _check_program(ops, out, e)
    return tuple(ops), out


def program_cost(e: int, mode: str) -> tuple[int, int]:
    """(num_squarings, num_muls) of the generated chain."""
    ops, _ = get_program(e, mode)
    sq = sum(1 for op in ops if op[0] == "sqr")
    return sq, len(ops) - sq


# ---------------------------------------------------------------------
# executors on (..., 8) Montgomery tensors
# ---------------------------------------------------------------------


class _Steps:
    """How an executor runs a program's steps on x's device: on a CPU tensor
    through the digit methods (one conversion in and one out), on any other
    through ``Field.sqr``/``Field.mul`` (K10 on the card, a launch a step)."""

    def __init__(self, field: Field, x: torch.Tensor):
        digits = x.device.type == "cpu"
        self.enter = to_digits if digits else (lambda a: a)
        self.leave = from_digits if digits else (lambda a: a)
        self.sqr = field.sqr16 if digits else field.sqr
        self.mul = field.mul16 if digits else field.mul


def _one(field: Field, x: torch.Tensor) -> torch.Tensor:
    return field.const_like(x, 1).contiguous()


def pow_fixed(field: Field, x: torch.Tensor, e: int, mode: str = "ltr_add_chain") -> torch.Tensor:
    """x^e elementwise over the field by the checked program for (e, mode),
    register by register (a register is dropped after its last read)."""
    if e == 0:
        return _one(field, x)
    ops, out = get_program(e, mode)
    last_read = {}
    for k, op in enumerate(ops):
        for reg in op[2:]:
            last_read[reg] = k
    run = _Steps(field, x)
    regs = {0: run.enter(x)}
    for k, op in enumerate(ops):
        if op[0] == "sqr":
            regs[op[1]] = run.sqr(regs[op[2]])
        else:
            regs[op[1]] = run.mul(regs[op[2]], regs[op[3]])
        for reg in op[2:]:
            if last_read[reg] == k and reg != out:
                regs.pop(reg, None)
    return run.leave(regs[out])


def pow_window(field: Field, x: torch.Tensor, e: int, window: int) -> torch.Tensor:
    """x^e by a uniform LTR scan of ``window``-bit digits (the JAX package's
    ``pow_fixed_scan`` schedule; ``Field.pow16``, whose w=4 form K1 runs;
    off the CPU ``Field.pow``, the same schedule an op a step)."""
    if e == 0:
        return _one(field, x)
    if x.device.type == "cpu":
        return from_digits(field.pow16(to_digits(x), e, window))
    return field.pow(x, e, window)


def pow_rtl(field: Field, x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e by RTL binary (the JAX package's ``pow_fixed_scan_rtl``
    schedule): a running square, multiplied into the accumulator at each
    set bit."""
    run = _Steps(field, x)
    s = run.enter(x)
    acc = run.enter(_one(field, x))
    nbits = e.bit_length()
    for k in range(nbits):
        if (e >> k) & 1:
            acc = run.mul(acc, s)
        if k + 1 < nbits:
            s = run.sqr(s)
    return run.leave(acc)
