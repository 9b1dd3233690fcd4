"""Bucket-accumulation kernel wrappers K3-K7 and K9, their plain versions,
counters.

Each wrapper checks its tensors and then, as fields/kernels.py does:

  * on CUDA tensors launches the hand-written kernel (csrc/msm_kernels.cuh,
    launchers in csrc/msm.cu, built by _build.py) on the current stream,
    or raises ``KernelError``;
  * on CPU tensors runs the plain version, because that is where the
    caller put the data.  Nothing else takes the plain version.

The plain versions run each kernel's schedule in torch (curves/point.py's
``add16``/``double16``, the same adds in the same order), vectorised over
the kernel's threads, on any device; the CPU tests and chip_smoke.py hold
the kernels against them bit for bit.

Layouts (int32 limb bit patterns, points stacked ``(..., 3, 8)``):

  canon_digits  K3 mode 0  scalars (K, n, 8) Montgomery over the scalar
                           field -> sort keys (K, m_pad), position
                           m = w n + i holding (digit_w(s_i), item m);
                           positions past W n hold the padding key (digit 0,
                           item 0); with ``window_rows`` keys (K, W, m_pad),
                           row w holding (digit_w(s_i), item i) for i < n
                           and the padding key beyond: one batch row of
                           K4-K6 a window, over the unshifted points (the
                           variable-base MSM).  A key is int32
                           ((digit << 20) | item) ^ 2^31 where a row's items
                           are below 2^20 (KEY32_ITEMS; offset binary, so
                           signed order is (digit, item) order), else int64
                           digit << 32 | item (key_width); key_digit and
                           key_item read either
  canon_mont    K3 mode 1  integers (N, 8) -> Montgomery form (N, 8)
  shift_gens    K7         generators (n, 3, 8) -> table (W n, 3, 8),
                           item w n + i = 2^(12 w) G_i; in one of two
                           forms (shift_form), the same bits
  bucket_scan   K4         table, sorted keys (K, m_pad) of either width,
                           rows ->
                           tails (K, NB, 3, 8), tail_col (K, NB) int32,
                           col_sums (K, cols, 3, 8), col_flags (K, cols);
                           in one of two forms (scan_form), the same bits
  column_carries K5        col_sums, col_flags -> carries (K, cols, 3, 8)
  bucket_sums   K6         tails, tail_col, carries -> (K, 3, 8):
                           sum_b b B_b for each batch row
  horner        K9         window sums (B, W, 3, 8), least significant
                           first -> (B, 3, 8): sum_w 2^(12 w) S_w

``LAUNCHES`` counts wrapper calls that launched their kernel (K5 is three
passes a call and K6 two, each counted once), and ``HOST_S``, keyed like
it, sums each wrapper's host seconds from its entry to its return (as
fields/kernels.py's), under a lock: threads launch at once
(nova/pipeline.py).
"""

from __future__ import annotations

import functools
import threading

import torch

from ..errors import KernelError
from ..fields import FIELDS, NLIMBS, get_field
from ..fields.kernels import host_timed
from ..fields.ops import from_digits, to_digits
from .point import (
    add16,
    double16,
    identity16,
    point_from_digits,
    point_to_digits,
    select16,
)

WINDOWS = 22  # W: 22 windows of 12 bits cover any Pasta scalar
WINDOW_BITS = 12  # c
NB = 1 << WINDOW_BITS  # buckets a batch row
PBLOCK = 128  # threads a block of the point kernels (csrc/msm_kernels.cuh)
# K4's two forms, as vdf_scan numbers them: one thread a column, or one group
# of 8 threads a column (csrc/curve.cuh's GROUP) on the group law.
SCAN_FORMS = ("thread", "group")
# K4 takes the group form below this many columns an SM: there the one-thread
# form leaves the schedulers idle; above it the group form's extra
# instructions cost more than its shorter chain saves (tools/msm_stage_sweep.py:
# the group form wins at 62 columns an SM, the thread form at 124).  The
# group form stages a column's keys in shared memory, SCAN_MAX_ROWS at most.
SCAN_GROUP_BELOW = 96
SCAN_MAX_ROWS = 64
# K7's two forms, as vdf_shift_gens numbers them: one thread a generator (12
# lazy doublings a call), or one group of 8 threads a generator on the group
# law.  K7 takes the group form below SHIFT_GROUP_BELOW generators an SM: the
# thread form's chain is as long at any n up to 124 an SM, the group form's
# shorter chain costs more issue as n grows (tools/k7_sweep.py: the group
# form 1.7x faster at 31 an SM, 1% slower at 62; they cross near 61).
SHIFT_FORMS = ("thread", "group")
SHIFT_GROUP_BELOW = 60
# K3's keys: int32 while a key row's items fit the 20-bit item field, else
# int64 (csrc/msm_kernels.cuh, K3's note).
KEY_ITEM_BITS = 20
KEY32_ITEMS = 1 << KEY_ITEM_BITS
KEY_DTYPES = {32: torch.int32, 64: torch.int64}
# K6: where its schedule is cut between the two launches (chunks of
# 2^BUCKET_CHUNK_BITS buckets, a block of BUCKET_THREADS each), and the
# points of scratch a batch row takes.  The cut changes no output bit.
BUCKET_CHUNK_BITS = 7
BUCKET_THREADS = 128
BUCKET_SCRATCH = 3 * NB
# Batch rows K6's plain version takes at once: with more, its digit tensors
# fall out of a CPU's caches and a row costs half as much again.
PLAIN_ROWS = 4

LAUNCHES = {
    "canon_digits": 0,
    "canon_mont": 0,
    "shift_gens": 0,
    "scan": 0,
    "colscan": 0,
    "bucket": 0,
    "horner": 0,
}


HOST_S = dict.fromkeys(LAUNCHES, 0.0)
_COUNT_LOCK = threading.Lock()
_timed = functools.partial(host_timed, HOST_S, _COUNT_LOCK)


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
            HOST_S[name] = 0.0


def count_launch(counter: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[counter] += 1


# ---------------------------------------------------------------------
# checks and launch
# ---------------------------------------------------------------------


def _check(field_name: str, **tensors) -> torch.device:
    """Field known; every tensor a contiguous tensor on one device."""
    if field_name not in FIELDS:
        raise KernelError(f"unknown field {field_name!r}")
    device = None
    for name, a in tensors.items():
        if not isinstance(a, torch.Tensor):
            raise KernelError(f"{name}: expected a tensor, got {type(a).__name__}")
        if not a.is_contiguous():
            raise KernelError(f"{name} must be contiguous")
        if device is None:
            device = a.device
        elif a.device != device:
            raise KernelError(f"{name} is on {a.device}, not {device}")
    return device


def _check_shape(name: str, a: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    """shape: ints, or None for any size."""
    ok = a.dtype == dtype and a.dim() == len(shape) and all(
        s is None or a.shape[k] == s for k, s in enumerate(shape)
    )
    if not ok:
        want = tuple("*" if s is None else s for s in shape)
        raise KernelError(f"{name}: expected {want} {dtype}, got {tuple(a.shape)} {a.dtype}")


def _device_kind(device: torch.device) -> str:
    if device.type not in ("cpu", "cuda"):
        raise KernelError(f"no kernel for device {device}")
    return device.type


def _launch(name: str, counter: str, device: torch.device, *args) -> None:
    from .._build import load_kernels

    load_kernels().launch(name, device, *args)
    count_launch(counter)


def _field_index(field_name: str) -> int:
    from .._build import FIELD_INDEX

    return FIELD_INDEX[field_name]


def _check_aligned(name: str, a: torch.Tensor) -> None:
    """The kernels read and write rows of 32 or 96 bytes in 16-byte pieces."""
    if a.data_ptr() % 16:
        raise KernelError(f"{name} must start on a 16-byte boundary")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(device) -> int:
    """SMs of the CUDA ``device`` (the current one when it names no index)."""
    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def _identity_rows(field_name: str, shape: tuple, device) -> torch.Tensor:
    """(*shape, 3, 8) filled with the identity (0 : 1 : 0)."""
    ident = torch.zeros(3, NLIMBS, dtype=torch.int32, device=device)
    ident[1] = get_field(field_name).one(device)
    return ident.expand(*shape, 3, NLIMBS).contiguous()


# ---------------------------------------------------------------------
# K3: canonical digits (mode 0) and Montgomery domain (mode 1)
# ---------------------------------------------------------------------


def key_width(items: int, key_bits: int | None = None) -> int:
    """K3's key width for rows of ``items`` items: ``key_bits`` (32 or 64)
    if given, else 32 where the items fit 20 bits and 64 beyond."""
    if key_bits is None:
        return 32 if items <= KEY32_ITEMS else 64
    if key_bits not in KEY_DTYPES or (key_bits == 32 and items > KEY32_ITEMS):
        raise KernelError(f"no {key_bits}-bit keys for rows of {items} items")
    return key_bits


def key_bits_of(keys: torch.Tensor) -> int:
    """The width of K3's keys in ``keys``, from its dtype."""
    for bits, dtype in KEY_DTYPES.items():
        if keys.dtype == dtype:
            return bits
    raise KernelError(f"keys: expected int32 or int64, got {keys.dtype}")


def make_keys(digits: torch.Tensor, items: torch.Tensor, key_bits: int) -> torch.Tensor:
    """Keys of (digit, item) pairs (int64 tensors) in ``key_bits``."""
    if key_bits == 64:
        return (digits << 32) | items
    return (((digits << KEY_ITEM_BITS) | items) - (1 << 31)).to(torch.int32)


def key_digit(keys: torch.Tensor) -> torch.Tensor:
    """The digits of K3's keys of either width, int64."""
    if key_bits_of(keys) == 64:
        return keys >> 32
    return (keys.to(torch.int64) + (1 << 31)) >> KEY_ITEM_BITS


def key_item(keys: torch.Tensor) -> torch.Tensor:
    """The items of K3's keys of either width, int64."""
    if key_bits_of(keys) == 64:
        return keys & 0xFFFFFFFF
    return (keys.to(torch.int64) + (1 << 31)) & (KEY32_ITEMS - 1)


@_timed("canon_digits")
def canon_digits(field_name: str, scalars: torch.Tensor, m_pad: int,
                 window_rows: bool = False, key_bits: int | None = None) -> torch.Tensor:
    """K3 mode 0 (replaces pallas_msm._canon_kernel, to_canonical):
    scalars (K, n, 8) over ``field_name`` -> sort keys, (K, m_pad)
    window-major, or (K, W, m_pad) with ``window_rows``; int32 or int64 as
    key_width picks for the row's items (W n, or n with ``window_rows``)."""
    device = _check(field_name, scalars=scalars)
    _check_shape("scalars", scalars, torch.int32, (None, None, NLIMBS))
    k, n = scalars.shape[:2]
    least = n if window_rows else WINDOWS * n
    if n < 1 or m_pad < least:
        raise KernelError(f"need n >= 1 and m_pad >= {least}, got n={n}, m_pad={m_pad}")
    bits = key_width(least, key_bits)
    if _device_kind(device) == "cpu":
        return canon_digits_plain(field_name, scalars, m_pad, window_rows, bits)
    _check_aligned("scalars", scalars)
    shape = (k, WINDOWS, m_pad) if window_rows else (k, m_pad)
    keys = torch.empty(shape, dtype=KEY_DTYPES[bits], device=device)
    if k:
        _launch("vdf_canon_digits", "canon_digits", device, _field_index(field_name),
                scalars.data_ptr(), keys.data_ptr(), n, k * n, m_pad, int(window_rows), bits)
    return keys


def canon_digits_plain(field_name: str, scalars: torch.Tensor, m_pad: int,
                       window_rows: bool = False, key_bits: int | None = None) -> torch.Tensor:
    k, n = scalars.shape[:2]
    span = n if window_rows else WINDOWS * n  # items a key row
    bits = key_width(span, key_bits)
    f = get_field(field_name)
    limbs = from_digits(f.from_mont16(to_digits(scalars.reshape(-1, NLIMBS))))
    words = limbs.to(torch.int64) & 0xFFFFFFFF  # (k n, 8)
    digits = []
    for w in range(WINDOWS):
        bit = w * WINDOW_BITS
        limb, off = bit // 32, bit % 32
        d = words[:, limb] >> off
        if off > 32 - WINDOW_BITS and limb + 1 < NLIMBS:
            d = d | (words[:, limb + 1] << (32 - off))
        digits.append(d & (NB - 1))
    d = torch.stack(digits).reshape(WINDOWS, k, n).transpose(0, 1)  # (k, W, n)
    d = torch.nn.functional.pad(d if window_rows else d.reshape(k, span), (0, m_pad - span))
    items = torch.arange(m_pad, dtype=torch.int64, device=scalars.device)
    return make_keys(d, torch.where(items < span, items, 0), bits)  # padding: (0, 0)


@_timed("canon_mont")
def canon_mont(field_name: str, values: torch.Tensor) -> torch.Tensor:
    """K3 mode 1 (replaces pallas_msm._canon_kernel, domain mode): integer
    limbs (N, 8), any 256-bit pattern -> Montgomery form of value mod p."""
    device = _check(field_name, values=values)
    _check_shape("values", values, torch.int32, (None, NLIMBS))
    if _device_kind(device) == "cpu":
        return canon_mont_plain(field_name, values)
    _check_aligned("values", values)
    out = torch.empty_like(values)
    if values.shape[0]:
        _launch("vdf_canon_mont", "canon_mont", device, _field_index(field_name),
                values.data_ptr(), out.data_ptr(), values.shape[0])
    return out


def canon_mont_plain(field_name: str, values: torch.Tensor) -> torch.Tensor:
    return from_digits(get_field(field_name).to_mont16(to_digits(values)))


# ---------------------------------------------------------------------
# K7: the pre-shifted generator table
# ---------------------------------------------------------------------


def shift_form(n: int, device) -> str:
    """K7's form for ``n`` generators on the CUDA ``device``: "group" where
    they give each SM fewer than SHIFT_GROUP_BELOW (the engine's key of
    4,096), else "thread"."""
    return "group" if n < SHIFT_GROUP_BELOW * _sms(device) else "thread"


@_timed("shift_gens")
def shift_gens(field_name: str, gens: torch.Tensor) -> torch.Tensor:
    """K7 (replaces pallas_msm._shift_gens_kernel): generators (n, 3, 8)
    over ``field_name`` -> (W n, 3, 8), item w n + i = 2^(12 w) G_i, the
    same bits in either of K7's forms, which shift_form picks."""
    device = _check(field_name, gens=gens)
    _check_shape("gens", gens, torch.int32, (None, 3, NLIMBS))
    if _device_kind(device) == "cpu":
        return shift_gens_plain(field_name, gens)
    _check_aligned("gens", gens)
    n = gens.shape[0]
    table = torch.empty((WINDOWS * n, 3, NLIMBS), dtype=torch.int32, device=device)
    if n:
        form = SHIFT_FORMS.index(shift_form(n, device))
        _launch("vdf_shift_gens", "shift_gens", device, _field_index(field_name),
                gens.data_ptr(), table.data_ptr(), n, form)
    return table


def shift_gens_plain(field_name: str, gens: torch.Tensor) -> torch.Tensor:
    f = get_field(field_name)
    p = tuple(f.canon16(c) for c in point_to_digits(gens))
    rows = []
    for w in range(WINDOWS):
        rows.append(point_from_digits(p))
        if w + 1 < WINDOWS:
            for _ in range(WINDOW_BITS):
                p = double16(field_name, p)
    return torch.cat(rows)


# ---------------------------------------------------------------------
# K4: run sums down each column
# ---------------------------------------------------------------------


def scan_form(columns: int, rows: int, device) -> str:
    """K4's form for a grid of ``columns`` (batch * cols) of ``rows`` on the
    CUDA ``device``: "group" where the grid gives each SM fewer than
    SCAN_GROUP_BELOW columns (the engine's commits of ~4,096 columns) and the
    columns are at most SCAN_MAX_ROWS high, else "thread" (a commit at
    n = 2^14, 16,384 columns; the MSM's 1.05M)."""
    if rows > SCAN_MAX_ROWS:
        return "thread"
    return "group" if columns < SCAN_GROUP_BELOW * _sms(device) else "thread"


@_timed("scan")
def bucket_scan(field_name: str, table: torch.Tensor, keys: torch.Tensor, rows: int):
    """K4 (replaces pallas_msm._scan_kernel and the tail compaction after
    it).  ``keys`` (K, m_pad) of either of K3's widths, sorted along each
    row, every item below ``table``'s length (as canon_digits and a sort
    give them); m_pad = cols * rows.  Returns (tails, tail_col, col_sums,
    col_flags), the same bits in either of K4's forms, which scan_form
    picks, and from either key width."""
    device = _check(field_name, table=table, keys=keys)
    _check_shape("table", table, torch.int32, (None, 3, NLIMBS))
    _check_shape("keys", keys, KEY_DTYPES[key_bits_of(keys)], (None, None))
    k, m_pad = keys.shape
    if rows < 1 or m_pad < 1 or m_pad % rows:
        raise KernelError(f"m_pad={m_pad} is not a positive multiple of rows={rows}")
    if _device_kind(device) == "cpu":
        return bucket_scan_plain(field_name, table, keys, rows)
    cols = m_pad // rows
    tails = _identity_rows(field_name, (k, NB), device)
    tail_col = torch.full((k, NB), -1, dtype=torch.int32, device=device)
    col_sums = torch.empty((k, cols, 3, NLIMBS), dtype=torch.int32, device=device)
    col_flags = torch.empty((k, cols), dtype=torch.int32, device=device)
    if k:
        form = SCAN_FORMS.index(scan_form(k * cols, rows, device))
        _launch("vdf_scan", "scan", device, _field_index(field_name), table.data_ptr(),
                keys.data_ptr(), tails.data_ptr(), tail_col.data_ptr(), col_sums.data_ptr(),
                col_flags.data_ptr(), m_pad, rows, cols, k, form, key_bits_of(keys))
    return tails, tail_col, col_sums, col_flags


def bucket_scan_plain(field_name: str, table: torch.Tensor, keys: torch.Tensor, rows: int):
    k, m_pad = keys.shape
    cols = m_pad // rows
    device = keys.device
    d = key_digit(keys)
    edge = torch.full((k, 1), -1, dtype=torch.int64, device=device)
    heads = (d != torch.cat([edge, d[:, :-1]], 1)).reshape(k, cols, rows)
    is_tail = ((d != torch.cat([d[:, 1:], edge], 1)) & (d != 0)).reshape(k, cols, rows)
    d = d.reshape(k, cols, rows)
    pts = table[key_item(keys).reshape(k, cols, rows)]  # (k, cols, rows, 3, 8)
    # Tails scatter into NB + 1 rows a batch row; row NB takes the rest.
    tails = _identity_rows(field_name, (k, NB + 1), device).reshape(-1, 3, NLIMBS)
    tail_col = torch.full((k * (NB + 1),), -1, dtype=torch.int32, device=device)
    base = torch.arange(k, device=device)[:, None] * (NB + 1)
    col = torch.arange(cols, dtype=torch.int32, device=device).expand(k, cols)
    seen = torch.zeros((k, cols), dtype=torch.bool, device=device)
    acc = None
    for r in range(rows):
        p = point_to_digits(pts[:, :, r])
        head = heads[:, :, r]
        acc = p if r == 0 else select16(head, p, add16(field_name, acc, p))
        seen = seen | head
        dest = torch.where(is_tail[:, :, r], base + d[:, :, r], base + NB).reshape(-1)
        tails.index_copy_(0, dest, point_from_digits(acc).reshape(-1, 3, NLIMBS))
        tail_col.index_copy_(0, dest, torch.where(seen, -1, col).reshape(-1))
    return (
        tails.reshape(k, NB + 1, 3, NLIMBS)[:, :NB].contiguous(),
        tail_col.reshape(k, NB + 1)[:, :NB].contiguous(),
        point_from_digits(acc),
        seen.to(torch.int32),
    )


# ---------------------------------------------------------------------
# K5: carries into the columns
# ---------------------------------------------------------------------


def carry_columns(cols: int) -> int:
    """L, the consecutive columns a thread of K5 owns, from the row length
    alone: one while a row is at most PBLOCK tiles of PBLOCK columns (the
    commit's shape, where the depth of 7 + 7 + 1 adds is what costs), four
    beyond (the MSM's, where the adds and the bytes are: fewer adds than
    with one or two, and a tile of 512 records leaves room for four blocks
    on an SM, where eight a thread leave room for two)."""
    return 1 if cols <= PBLOCK * PBLOCK else 4


@_timed("colscan")
def column_carries(field_name: str, col_sums: torch.Tensor, col_flags: torch.Tensor):
    """K5 (replaces pallas_msm._colscan_kernel): the carry flowing into
    each column, (K, cols, 3, 8); the identity for column 0."""
    device = _check(field_name, col_sums=col_sums, col_flags=col_flags)
    _check_shape("col_sums", col_sums, torch.int32, (None, None, 3, NLIMBS))
    _check_shape("col_flags", col_flags, torch.int32, tuple(col_sums.shape[:2]))
    k, cols = col_flags.shape
    if cols < 1:
        raise KernelError("need at least one column")
    if _device_kind(device) == "cpu":
        return column_carries_plain(field_name, col_sums, col_flags)
    carries = torch.empty_like(col_sums)
    if k:
        per_thread = carry_columns(cols)
        tiles = -(-cols // (PBLOCK * per_thread))
        thread_v = torch.empty((k, tiles * PBLOCK, 3, NLIMBS), dtype=torch.int32, device=device)
        thread_f = torch.empty((k, tiles * PBLOCK), dtype=torch.int32, device=device)
        tile_incl = torch.empty((k, tiles, 3, NLIMBS), dtype=torch.int32, device=device)
        _launch("vdf_colscan", "colscan", device, _field_index(field_name),
                col_sums.data_ptr(), col_flags.data_ptr(), thread_v.data_ptr(),
                thread_f.data_ptr(), tile_incl.data_ptr(), carries.data_ptr(), cols, k,
                per_thread)
    return carries


def _scan_block(field_name: str, v, f: torch.Tensor):
    """Segmented Hillis-Steele over the PBLOCK entries of axis -2 of the
    digit-tuple point ``v`` (flags ``f`` over axis -1): at distance d, entry
    t >= d without a flag becomes v[t - d] + v[t].  Stops at the first level
    in which no entry adds, as every block of the kernel does (a level
    without adds changes nothing in a block)."""
    t = torch.arange(PBLOCK, device=f.device)
    d = 1
    while d < PBLOCK:
        adds = (t >= d) & ~f
        if not bool(adds.any()):
            break
        left = tuple(torch.roll(a, d, dims=-2) for a in v)
        v = select16(adds, add16(field_name, left, v), v)
        f = torch.where(t >= d, f | torch.roll(f, d, dims=-1), f)
        d *= 2
    return v, f


def _pad_axis(p, f: torch.Tensor, axis: int, size: int, field_name: str):
    """Pad the digit-tuple point ``p`` and its flags along ``axis`` (counted
    over the flags' axes) to ``size`` entries of (flagged, identity)."""
    extra = size - f.shape[axis]
    if extra == 0:
        return p, f
    shape = list(f.shape)
    shape[axis] = extra
    fill = identity16(field_name, p[0].new_zeros(*shape, p[0].shape[-1]))
    p = tuple(torch.cat([a, b], dim=axis) for a, b in zip(p, fill))
    return p, torch.cat([f, f.new_ones(shape)], dim=axis)


def column_carries_plain(field_name: str, col_sums: torch.Tensor, col_flags: torch.Tensor,
                         per_thread: int | None = None):
    """The kernel's three passes, vectorised over its threads: tiles of
    PBLOCK * L columns, a thread's L columns folded from the left, the
    thread totals scanned a tile, the tile totals scanned a row, then each
    thread's walk from the scan before its first column.  ``per_thread`` is
    L (the tests cross tile edges at small sizes with it); by default the
    kernel's own choice."""
    k, cols = col_flags.shape
    L = carry_columns(cols) if per_thread is None else per_thread
    span = PBLOCK * L
    tiles = -(-cols // span)
    f = col_flags != 0
    f[:, 0] = True  # nothing lies to the left of a row's first column
    v, f = _pad_axis(point_to_digits(col_sums), f, 1, tiles * span, field_name)
    v = tuple(a.reshape(k, tiles, PBLOCK, L, -1) for a in v)
    f = f.reshape(k, tiles, PBLOCK, L)

    # Pass 1: each thread's fold, then the scan of a tile's thread totals.
    acc, flag = _at(v, 0), f[..., 0]
    for j in range(1, L):
        acc = select16(f[..., j], _at(v, j), add16(field_name, acc, _at(v, j)))
        flag = flag | f[..., j]
    thread_v, thread_f = _scan_block(field_name, acc, flag)  # (k, tiles, PBLOCK, 16)

    # Pass 2: the tile totals of a row, PBLOCK at a time.
    tot_v, tot_f = _at(thread_v, PBLOCK - 1), thread_f[..., PBLOCK - 1]  # (k, tiles, 16)
    parts, before = [], None
    for t0 in range(0, tiles, PBLOCK):
        n = min(PBLOCK, tiles - t0)
        cv, cf = _pad_axis(tuple(a[:, t0 : t0 + n] for a in tot_v), tot_f[:, t0 : t0 + n], 1,
                           PBLOCK, field_name)
        cv, cf = _scan_block(field_name, cv, cf)
        if before is not None:
            joined = add16(field_name, tuple(b[:, None].expand_as(a) for a, b in zip(cv, before)),
                           cv)
            cv = select16(cf, cv, joined)
        parts.append(tuple(a[:, :n] for a in cv))
        before = tuple(a[:, n - 1] for a in cv)
    tile_incl = tuple(torch.cat(c, dim=1) for c in zip(*parts))  # (k, tiles, 16)

    # Pass 3: the scan up to the column before a thread's first, then its walk.
    ident = identity16(field_name, tile_incl[0][:, :1])
    tile_before = tuple(torch.cat([i, a[:, :-1]], dim=1)[:, :, None].expand_as(b)
                        for i, a, b in zip(ident, tile_incl, thread_v))
    prev_v = tuple(torch.roll(a, 1, dims=-2) for a in thread_v)
    prev_f = torch.roll(thread_f, 1, dims=-1)
    first = torch.arange(PBLOCK, device=f.device).expand_as(thread_f) == 0
    e = select16(prev_f, prev_v, add16(field_name, tile_before, prev_v))
    e = select16(first, tile_before, e)  # for the row's first tile: the identity
    out = []
    for j in range(L):
        out.append(point_from_digits(e))
        if j + 1 < L:
            e = select16(f[..., j], _at(v, j), add16(field_name, e, _at(v, j)))
    carries = torch.stack(out, dim=3)  # (k, tiles, PBLOCK, L, 3, 8)
    return carries.reshape(k, tiles * span, 3, NLIMBS)[:, :cols].contiguous()


# ---------------------------------------------------------------------
# K6: sum_b b B_b
# ---------------------------------------------------------------------


@_timed("bucket")
def bucket_sums(field_name: str, tails: torch.Tensor, tail_col: torch.Tensor,
                carries: torch.Tensor) -> torch.Tensor:
    """K6 (replaces pallas_msm._bucket_kernel): B_b = tail + carry, bucket
    0 the identity, then sum_b b B_b for each batch row -> (K, 3, 8)."""
    device = _check(field_name, tails=tails, tail_col=tail_col, carries=carries)
    _check_shape("tails", tails, torch.int32, (None, NB, 3, NLIMBS))
    k = tails.shape[0]
    _check_shape("tail_col", tail_col, torch.int32, (k, NB))
    _check_shape("carries", carries, torch.int32, (k, None, 3, NLIMBS))
    cols = carries.shape[1]
    if cols < 1:
        raise KernelError("need at least one column")
    if _device_kind(device) == "cpu":
        return bucket_sums_plain(field_name, tails, tail_col, carries)
    out = torch.empty((k, 3, NLIMBS), dtype=torch.int32, device=device)
    if k:
        scratch = torch.empty((k, BUCKET_SCRATCH, 3, NLIMBS), dtype=torch.int32, device=device)
        _launch("vdf_bucket", "bucket", device, _field_index(field_name), tails.data_ptr(),
                tail_col.data_ptr(), carries.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                cols, k, BUCKET_CHUNK_BITS, BUCKET_THREADS)
    return out


def _at(p, t: int):
    """Entry t along the last batch axis of a digit-tuple point."""
    return tuple(a[..., t, :] for a in p)


def bucket_sums_plain(field_name: str, tails: torch.Tensor, tail_col: torch.Tensor,
                      carries: torch.Tensor) -> torch.Tensor:
    """The kernel's halving schedule: V0 = the buckets; step s = 1 .. 11
    pairs neighbours of V(s-1) into Vs and, in the same step, takes one level
    of the tree of each O_j, j <= s (O_j: the sum of the odd entries of
    V(j-1)); then O_1 + 2 (O_2 + ... + 2 O_12) from the top down.  All adds
    of a step go through one add16 call."""
    k = tails.shape[0]
    if k > PLAIN_ROWS:
        return torch.cat([bucket_sums_plain(field_name, tails[r : r + PLAIN_ROWS],
                                            tail_col[r : r + PLAIN_ROWS],
                                            carries[r : r + PLAIN_ROWS])
                          for r in range(0, k, PLAIN_ROWS)])
    v = point_to_digits(tails)
    rows, buckets = torch.nonzero(tail_col >= 0, as_tuple=True)
    if rows.numel():  # the buckets that take a carry, and no others
        cols = tail_col[rows, buckets].to(torch.int64)
        joined = add16(field_name, tuple(a[rows, buckets] for a in v),
                       point_to_digits(carries[rows, cols]))
        v = tuple(a.index_put((rows, buckets), b) for a, b in zip(v, joined))
    first = torch.arange(NB, device=tails.device).expand(k, NB) == 0
    v = select16(first, identity16(field_name, v[0]), v)

    trees = []  # trees[j - 1]: the newest level of O_j's tree
    for s in range(1, WINDOW_BITS):
        left = [tuple(a[:, 0::2] for a in v), *(tuple(a[:, 0::2] for a in t) for t in trees),
                tuple(a[:, 1::4] for a in v)]
        right = [tuple(a[:, 1::2] for a in v), *(tuple(a[:, 1::2] for a in t) for t in trees),
                 tuple(a[:, 3::4] for a in v)]
        sums = add16(field_name, tuple(torch.cat(c, dim=1) for c in zip(*left)),
                     tuple(torch.cat(c, dim=1) for c in zip(*right)))
        half = NB >> (s + 1)
        v = tuple(a[:, : 2 * half] for a in sums)
        trees = [tuple(a[:, (2 + j) * half : (3 + j) * half] for a in sums) for j in range(s)]
    acc = _at(v, 1)  # O_12 = V11_1
    for t in reversed(trees):
        acc = add16(field_name, double16(field_name, acc), _at(t, 0))
    return point_from_digits(acc)


# ---------------------------------------------------------------------
# K9: sum_w 2^(12 w) S_w
# ---------------------------------------------------------------------


@_timed("horner")
def horner(field_name: str, sums: torch.Tensor) -> torch.Tensor:
    """K9 (replaces pallas_msm._horner_kernel): window sums (B, W, 3, 8),
    least significant window first -> (B, 3, 8), sum_w 2^(12 w) S_w: from
    the identity, 12 doublings and one complete add a window, top down; on
    the card a group of 8 threads a batch row."""
    device = _check(field_name, sums=sums)
    _check_shape("sums", sums, torch.int32, (None, WINDOWS, 3, NLIMBS))
    if _device_kind(device) == "cpu":
        return horner_plain(field_name, sums)
    b = sums.shape[0]
    out = torch.empty((b, 3, NLIMBS), dtype=torch.int32, device=device)
    if b:
        _launch("vdf_horner", "horner", device, _field_index(field_name), sums.data_ptr(),
                out.data_ptr(), b)
    return out


def horner_plain(field_name: str, sums: torch.Tensor) -> torch.Tensor:
    f = get_field(field_name)
    s16 = tuple(f.canon16(c) for c in point_to_digits(sums))  # each (B, W, 16)
    acc = identity16(field_name, s16[0][:, 0])
    for w in range(WINDOWS - 1, -1, -1):
        for _ in range(WINDOW_BITS):
            acc = double16(field_name, acc)
        acc = add16(field_name, acc, _at(s16, w))
    return point_from_digits(acc)
