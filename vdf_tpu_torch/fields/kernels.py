"""MinRoot kernel wrappers K1/K2, their plain versions, launch counters.

``minroot_eval`` and ``minroot_inverse`` take the state as three
``(lanes, 8)`` int32 contiguous tensors on one device (fields/params.py
representation) and return three new ones, canonical:

  * on a CUDA tensor they launch the hand-written kernel
    (csrc/minroot.cu, built by _build.py) on the current stream, or
    raise ``KernelError``;
  * on a CPU tensor they run the plain version, because that is where
    the caller put the data.  Nothing else takes the plain version.

The plain versions run the kernels' schedule (the same w=4 window,
canonical values between rounds) with fields/ops.py, vectorised over
lanes, on any device; the CPU tests and chip_smoke.py hold the kernels
against them.

``LAUNCHES`` counts the kernel launches, one per launch, so a run can
show that its main path went through the kernels; ``STREAMS`` counts them
by the CUDA stream they went to (``(kernel, stream handle)`` -> launches),
so a run can show which stream a launch used.  Both are updated under one
lock: threads launch at once (nova/pipeline.py).
"""

from __future__ import annotations

import collections
import threading

import torch

from ..errors import KernelError
from .ops import from_digits, get_field, to_digits
from .params import FIELDS, NLIMBS

LAUNCHES = {"minroot_eval": 0, "minroot_inverse": 0}
STREAMS: collections.Counter = collections.Counter()
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        STREAMS.clear()


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


def minroot_eval(field_name: str, x, y, i, t: int):
    """K1: t forward rounds per lane (replaces minroot_eval_tpu)."""
    _check(field_name, t, (x, y, i))
    if x.device.type == "cpu":
        return minroot_eval_plain(field_name, x, y, i, t)
    return _launch("minroot_eval", field_name, x, y, i, t)


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
