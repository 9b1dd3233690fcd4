"""Field kernel wrappers K1/K2 and K10-K12, their plain versions, launch counters.

``minroot_eval`` and ``minroot_inverse`` (K1/K2) take the state as three
``(lanes, 8)`` int32 contiguous tensors on one device (fields/params.py
representation) and return three new ones, canonical.  ``field_ew``
(K10), ``field_segsum`` (K11) and ``r1cs_matvec`` (K12) carry the device
plane's field arithmetic: the elementwise ops of ``Field``, the exact
field sum over segments, and the sparse ``M @ z`` of an R1CS matrix.
Every wrapper checks its arguments (``KernelError``) and then:

  * on a CUDA tensor launches the hand-written kernel (csrc/minroot.cu,
    csrc/field_ops.cu, built by _build.py) on the current stream, or
    raises ``KernelError``;
  * on a CPU tensor runs the plain version, because that is where the
    caller put the data.  Nothing else takes the plain version: a tensor
    on any other device raises.

The plain versions are the digit code of fields/ops.py (the ``*16``
methods, which stay plain on every device): the K1/K2 ones run the
kernels' schedule (the same w=4 window, canonical values between rounds)
vectorised over lanes; the K10-K12 ones are what ``Field``,
``DeviceMatrix.matvec`` and the sumcheck's row sum computed before the
kernels existed.  The CPU tests and chip_smoke.py hold the kernels
against them, bit for bit.

``LAUNCHES`` counts the kernel launches, one per launch, so a run can
show that its main path went through the kernels; ``STREAMS`` counts them
by the CUDA stream they went to (``(kernel, stream handle)`` -> launches),
so a run can show which stream a launch used.  ``HOST_S``, keyed like
``LAUNCHES``, sums the host seconds of each public wrapper's calls, from
its entry to its return (the checks, the allocations and the launch; on a
CPU tensor the plain version): two clock reads a call.  All three are
updated under one lock (threads launch at once: nova/pipeline.py), and
``reset_launches`` clears them.
"""

from __future__ import annotations

import collections
import functools
import threading
import time

import torch

from ..errors import KernelError
from .ops import from_digits, get_field, to_digits
from .params import FIELDS, NLIMBS

LAUNCHES = {"minroot_eval": 0, "minroot_inverse": 0, "field_ew": 0, "field_segsum": 0,
            "r1cs_matvec": 0}
STREAMS: collections.Counter = collections.Counter()
HOST_S = dict.fromkeys(LAUNCHES, 0.0)
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
            HOST_S[name] = 0.0
        STREAMS.clear()


def host_timed(host_s: dict, lock: threading.Lock, key: str):
    """A wrapper's decorator: adds each call's host seconds, entry to
    return, to ``host_s[key]`` under ``lock``."""

    def wrap(fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            with lock:
                host_s[key] += dt
            return out

        return timed

    return wrap


_timed = functools.partial(host_timed, HOST_S, _COUNT_LOCK)


def count_launch(name: str, stream: int = 0) -> None:
    """One launch of kernel ``name`` on the stream with handle ``stream``."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        STREAMS[name, stream] += 1


def _check(field_name: str, t: int, tensors) -> None:
    if field_name not in FIELDS:
        raise KernelError(f"unknown field {field_name!r}")
    if t < 0:
        raise KernelError(f"t must be nonnegative, got {t}")
    x = tensors[0]
    for a in tensors:
        if not isinstance(a, torch.Tensor):
            raise KernelError(f"expected a tensor, got {type(a).__name__}")
        if a.dtype != torch.int32 or a.dim() != 2 or a.shape[1] != NLIMBS:
            raise KernelError(
                f"expected (lanes, {NLIMBS}) int32, got {tuple(a.shape)} {a.dtype}"
            )
        if a.shape != x.shape or a.device != x.device:
            raise KernelError("x, y and i must share shape and device")
        if not a.is_contiguous():
            raise KernelError("state tensors must be contiguous")


def _launch(name: str, field_name: str, x, y, i, t: int):
    from .._build import FIELD_INDEX, load_kernels

    if x.device.type != "cuda":
        raise KernelError(f"no kernel for device {x.device}")
    kernels = load_kernels()
    outs = [torch.empty_like(a) for a in (x, y, i)]
    if x.shape[0] == 0:
        return tuple(outs)
    stream = kernels.launch(f"vdf_{name}", x.device, FIELD_INDEX[field_name],
                            *(a.data_ptr() for a in (x, y, i, *outs)), x.shape[0], t)
    count_launch(name, stream)
    return tuple(outs)


@_timed("minroot_eval")
def minroot_eval(field_name: str, x, y, i, t: int):
    """K1: t forward rounds per lane (replaces minroot_eval_tpu)."""
    _check(field_name, t, (x, y, i))
    if x.device.type == "cpu":
        return minroot_eval_plain(field_name, x, y, i, t)
    return _launch("minroot_eval", field_name, x, y, i, t)


@_timed("minroot_inverse")
def minroot_inverse(field_name: str, x, y, i, t: int):
    """K2: t inverse rounds per lane (replaces minroot_inverse_tpu)."""
    _check(field_name, t, (x, y, i))
    if x.device.type == "cpu":
        return minroot_inverse_plain(field_name, x, y, i, t)
    return _launch("minroot_inverse", field_name, x, y, i, t)


def minroot_eval_plain(field_name: str, x, y, i, t: int):
    """Plain version of K1: x' = (x+y)^inv_alpha, y' = x+i, i' = i+1."""
    f = get_field(field_name)
    e = f.params.inv_alpha
    x, y, i = (f.canon16(to_digits(a)) for a in (x, y, i))
    one = f.one16(x)
    for _ in range(t):
        x, y, i = (
            f.pow16(f.cond_sub_p16(f.add16(x, y)), e),
            f.cond_sub_p16(f.add16(x, i)),
            f.cond_sub_p16(f.add16(i, one)),
        )
    return tuple(from_digits(a) for a in (x, y, i))


def minroot_inverse_plain(field_name: str, x, y, i, t: int):
    """Plain version of K2: i' = i-1, x' = y-i', y' = x^5-x'."""
    f = get_field(field_name)
    x, y, i = (f.canon16(to_digits(a)) for a in (x, y, i))
    one = f.one16(x)
    for _ in range(t):
        i = f.sub16(i, one)
        nx = f.sub16(y, i)
        y = f.sub16(f.mul16(f.sqr16(f.sqr16(x)), x), nx)
        x = nx
    return tuple(from_digits(a) for a in (x, y, i))


# ---------------------------------------------------------------------
# K10-K12: the device plane's field arithmetic
# ---------------------------------------------------------------------

# K10's ops: name -> (op code of csrc/field_ops.cuh, operands).  "fold" is
# the linear fold a + r b, operands (a, r, b).
EW_OPS = {"add": (0, 2), "sub": (1, 2), "mul": (2, 2), "sqr": (3, 1), "neg": (4, 1),
          "canon": (5, 1), "fold": (6, 3)}
MAX_SEGMENT = 1 << 30  # K11's terms a segment: 2^30 values of 256 bits fit its 288-bit sums


def _check_field(field_name: str) -> None:
    if field_name not in FIELDS:
        raise KernelError(f"unknown field {field_name!r}")


def _check_elements(what: str, a, device=None) -> None:
    """``a``: a (..., 8) int32 tensor (on ``device`` when given)."""
    if not isinstance(a, torch.Tensor):
        raise KernelError(f"{what}: expected a tensor, got {type(a).__name__}")
    if a.dtype != torch.int32 or a.dim() == 0 or a.shape[-1] != NLIMBS:
        raise KernelError(f"{what}: expected (..., {NLIMBS}) int32, got {tuple(a.shape)} "
                          f"{a.dtype}")
    if device is not None and a.device != device:
        raise KernelError(f"{what}: on {a.device}, the other operands on {device}")


def _check_index(what: str, a, device, length: int | None = None) -> None:
    if not isinstance(a, torch.Tensor) or a.dtype != torch.int64 or a.dim() != 1:
        got = f"{tuple(a.shape)} {a.dtype}" if isinstance(a, torch.Tensor) else type(a).__name__
        raise KernelError(f"{what}: expected a 1-D int64 tensor, got {got}")
    if length is not None and a.shape[0] != length:
        raise KernelError(f"{what}: expected {length} entries, got {a.shape[0]}")
    if a.device != device:
        raise KernelError(f"{what}: on {a.device}, the other operands on {device}")


def _one_element(a: torch.Tensor) -> torch.Tensor | None:
    """The single element an operand broadcasts (stride 0 or size 1 on every
    leading axis), as an (8,) tensor; None for any other operand."""
    if any(st != 0 and sz != 1 for sz, st in zip(a.shape[:-1], a.stride()[:-1])):
        return None
    return a[(0,) * (a.dim() - 1)].contiguous()


def _device_of(operands) -> torch.device:
    dev = operands[0].device
    if dev.type == "cpu" or dev.type == "cuda":
        return dev
    raise KernelError(f"no kernel for device {dev}")


@_timed("field_ew")
def field_ew(field_name: str, op: str, *operands) -> torch.Tensor:
    """K10: ``op`` elementwise over (..., 8) Montgomery limbs, broadcast as
    torch broadcasts (replaces the XLA field ops of vdf_tpu/fields/ops.py
    and the fold a + r b of vdf_tpu/nova/ivc.py:678).  An operand that is
    one element (``r.expand(...)`` too) reaches the kernel as that element
    with a stride of 0; other operands of another shape than the result
    are broadcast into a contiguous copy."""
    _check_field(field_name)
    if op not in EW_OPS:
        raise KernelError(f"unknown field op {op!r}; one of {sorted(EW_OPS)}")
    code, arity = EW_OPS[op]
    if len(operands) != arity:
        raise KernelError(f"field op {op!r} takes {arity} operands, got {len(operands)}")
    for k, a in enumerate(operands):
        _check_elements(f"{op} operand {k}", a, operands[0].device if k else None)
    device = _device_of(operands)
    if device.type == "cpu":
        return field_ew_plain(field_name, op, *operands)
    shape = torch.broadcast_shapes(*(a.shape for a in operands))
    out = torch.empty(shape, dtype=torch.int32, device=device)
    n = out.numel() // NLIMBS
    if n == 0:
        return out
    ptrs, bcast, keep = [], 0, []  # keep: the copies stay allocated until the launch
    for k, a in enumerate(operands):
        one = _one_element(a)
        if one is not None and n > 1:
            a = one
            bcast |= 1 << k
        elif a.shape != shape:
            a = a.expand(shape).contiguous()
        else:
            a = a.contiguous()
        keep.append(a)
        ptrs.append(a.data_ptr())
    ptrs += [None] * (3 - len(ptrs))
    _launch_field("vdf_field_ew", "field_ew", field_name, device, code, *ptrs,
                  out.data_ptr(), n, bcast)
    return out


def field_ew_plain(field_name: str, op: str, *operands) -> torch.Tensor:
    """Plain version of K10: fields/ops.py's digit code."""
    f = get_field(field_name)
    d = [to_digits(a) for a in operands]
    if op == "add":
        v = f.cond_sub_p16(f.add16(d[0], d[1]))
    elif op == "sub":
        v = f.sub16(d[0], d[1])
    elif op == "mul":
        v = f.mul16(d[0], d[1])
    elif op == "sqr":
        v = f.mul16(d[0], d[0])
    elif op == "neg":
        v = f.sub16(torch.zeros_like(d[0]), f.canon16(d[0]))
    elif op == "canon":
        v = f.canon16(d[0])
    elif op == "fold":
        v = f.cond_sub_p16(f.add16(d[0], f.mul16(d[1], d[2])))
    else:
        raise KernelError(f"unknown field op {op!r}; one of {sorted(EW_OPS)}")
    return from_digits(v)


@_timed("field_segsum")
def field_segsum(field_name: str, x, offsets=None, segments: int | None = None) -> torch.Tensor:
    """K11: the exact field sum of the (n, 8) elements ``x`` over segments
    -> (segments, 8) canonical (replaces vdf_tpu/spartan/sumcheck.py:20
    ``_sum_rows`` and the gamma-matvec's ``segment_sum``).  The segments are
    given by ``offsets`` (an int64 (S + 1,) CSR index into x's rows,
    nondecreasing, within [0, n]) or, with ``offsets`` None, are ``segments``
    equal runs of x's rows (the sum along an axis).  An empty segment sums
    to 0.  A segment of at most 2^30 elements is exact for any 256-bit
    patterns; canonical inputs give the field sum."""
    _check_field(field_name)
    _check_elements("segsum input", x)
    device = _device_of([x])
    if x.dim() != 2:
        raise KernelError(f"segsum input: expected (n, {NLIMBS}), got {tuple(x.shape)}")
    n = x.shape[0]
    if offsets is None:
        if segments is None or segments < 0 or (n and (segments == 0 or n % segments)):
            raise KernelError(f"segsum: {n} rows do not split into {segments} equal segments")
        seg_len = n // segments if segments else 0
        if seg_len > MAX_SEGMENT:
            raise KernelError(f"segsum: segments of {seg_len} rows exceed {MAX_SEGMENT}")
    else:
        _check_index("segsum offsets", offsets, device)
        if offsets.shape[0] < 1 or segments not in (None, offsets.shape[0] - 1):
            raise KernelError("segsum: offsets need segments + 1 entries")
        if n > MAX_SEGMENT:
            raise KernelError(f"segsum: {n} rows may exceed {MAX_SEGMENT} in a segment")
        segments, seg_len = offsets.shape[0] - 1, 0
    if device.type == "cpu":
        return field_segsum_plain(field_name, x, offsets, segments)
    out = torch.empty((segments, NLIMBS), dtype=torch.int32, device=device)
    if segments == 0:
        return out
    x = x.contiguous()
    off = None if offsets is None else offsets.contiguous()
    _launch_field("vdf_field_segsum", "field_segsum", field_name, device, x.data_ptr(),
                  None if off is None else off.data_ptr(), out.data_ptr(), segments, seg_len)
    return out


def field_segsum_plain(field_name: str, x, offsets=None, segments: int | None = None):
    """Plain version of K11: 16-bit digit sums in int64, one reduce_wide16."""
    f = get_field(field_name)
    d = to_digits(x)
    if offsets is None:
        acc = d.reshape(segments, -1, d.shape[-1]).sum(1)
    else:
        segments = offsets.shape[0] - 1
        lo, hi = int(offsets[0]), int(offsets[-1])
        ids = torch.repeat_interleave(torch.arange(segments, device=x.device), offsets.diff())
        acc = torch.zeros((segments, d.shape[-1]), dtype=torch.int64, device=x.device)
        acc.index_add_(0, ids, d[lo:hi])
    return from_digits(f.reduce_wide16(acc))


@_timed("r1cs_matvec")
def r1cs_matvec(field_name: str, rows, offsets, cols, vals, z) -> torch.Tensor:
    """K12: ``M @ z`` for a sparse matrix of nnz entries in row order,
    ``rows``/``cols`` (nnz,) int64 and ``vals`` (nnz, 8) Montgomery, with
    ``offsets`` (num_rows + 1,) the CSR offsets of the rows into the entries;
    z (num_vars, 8) -> (num_rows, 8) canonical (replaces
    vdf_tpu/nova/r1cs_device.py:28 ``DeviceMatrix.matvec``).  The kernel
    reads the offsets, the plain version the row of each entry."""
    _check_field(field_name)
    _check_elements("matvec z", z)
    device = _device_of([z])
    if z.dim() != 2:
        raise KernelError(f"matvec z: expected (num_vars, {NLIMBS}), got {tuple(z.shape)}")
    _check_elements("matvec vals", vals, device)
    if vals.dim() != 2:
        raise KernelError(f"matvec vals: expected (nnz, {NLIMBS}), got {tuple(vals.shape)}")
    nnz = vals.shape[0]
    _check_index("matvec rows", rows, device, nnz)
    _check_index("matvec cols", cols, device, nnz)
    _check_index("matvec offsets", offsets, device)
    num_rows = offsets.shape[0] - 1
    if num_rows < 0:
        raise KernelError("matvec offsets: expected num_rows + 1 entries, got none")
    if device.type == "cpu":
        return r1cs_matvec_plain(field_name, rows, cols, vals, z, num_rows)
    out = torch.empty((num_rows, NLIMBS), dtype=torch.int32, device=device)
    if num_rows == 0:
        return out
    args = [a.contiguous() for a in (offsets, cols, vals, z)]
    _launch_field("vdf_r1cs_matvec", "r1cs_matvec", field_name, device,
                  *(a.data_ptr() for a in args), out.data_ptr(), num_rows)
    return out


def r1cs_matvec_plain(field_name: str, rows, cols, vals, z, num_rows: int) -> torch.Tensor:
    """Plain version of K12: the canonical products' 16-bit digits summed by
    row in int64 (``index_add_`` on integers is exact in any order), one
    reduce_wide16."""
    f = get_field(field_name)
    prods = f.mul16(to_digits(vals), to_digits(z[cols]))
    acc = torch.zeros((num_rows, prods.shape[-1]), dtype=torch.int64, device=z.device)
    acc.index_add_(0, rows, prods)
    return from_digits(f.reduce_wide16(acc))


def _launch_field(launcher: str, name: str, field_name: str, device, *args) -> None:
    from .._build import FIELD_INDEX, load_kernels

    stream = load_kernels().launch(launcher, device, FIELD_INDEX[field_name], *args)
    count_launch(name, stream)
