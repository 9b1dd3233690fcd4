"""Fixed-base commit kernel wrappers K3-K7, their plain versions, counters.

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
                           field -> keys (K, m_pad) int64, item
                           m = w n + i holding digit_w(s_i) << 32 | m;
                           items past W n are 0 (digit 0, item 0)
  canon_mont    K3 mode 1  integers (N, 8) -> Montgomery form (N, 8)
  shift_gens    K7         generators (n, 3, 8) -> table (W n, 3, 8),
                           item w n + i = 2^(12 w) G_i
  bucket_scan   K4         table, sorted keys (K, m_pad), rows ->
                           tails (K, NB, 3, 8), tail_col (K, NB) int32,
                           col_sums (K, cols, 3, 8), col_flags (K, cols)
  column_carries K5        col_sums, col_flags -> carries (K, cols, 3, 8)
  bucket_sums   K6         tails, tail_col, carries -> (K, 3, 8):
                           sum_b b B_b for each batch row

``LAUNCHES`` counts wrapper calls that launched their kernel (K5 and K6
launch several passes a call and count once).
"""

from __future__ import annotations

import torch

from ..errors import KernelError
from ..fields import FIELDS, NLIMBS, get_field
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
RADIX = 16  # K6's level width: NB = RADIX^3

LAUNCHES = {
    "canon_digits": 0,
    "canon_mont": 0,
    "shift_gens": 0,
    "scan": 0,
    "colscan": 0,
    "bucket": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    LAUNCHES[counter] += 1


def _field_index(field_name: str) -> int:
    from .._build import FIELD_INDEX

    return FIELD_INDEX[field_name]


def _identity_rows(field_name: str, shape: tuple, device) -> torch.Tensor:
    """(*shape, 3, 8) filled with the identity (0 : 1 : 0)."""
    ident = torch.zeros(3, NLIMBS, dtype=torch.int32, device=device)
    ident[1] = get_field(field_name).one(device)
    return ident.expand(*shape, 3, NLIMBS).contiguous()


# ---------------------------------------------------------------------
# K3: canonical digits (mode 0) and Montgomery domain (mode 1)
# ---------------------------------------------------------------------


def canon_digits(field_name: str, scalars: torch.Tensor, m_pad: int) -> torch.Tensor:
    """K3 mode 0 (replaces pallas_msm._canon_kernel, to_canonical):
    scalars (K, n, 8) over ``field_name`` -> window-major sort keys."""
    device = _check(field_name, scalars=scalars)
    _check_shape("scalars", scalars, torch.int32, (None, None, NLIMBS))
    k, n = scalars.shape[:2]
    if n < 1 or m_pad < WINDOWS * n:
        raise KernelError(f"need n >= 1 and m_pad >= {WINDOWS} n, got n={n}, m_pad={m_pad}")
    if _device_kind(device) == "cpu":
        return canon_digits_plain(field_name, scalars, m_pad)
    keys = torch.zeros((k, m_pad), dtype=torch.int64, device=device)
    if k:
        _launch("vdf_canon_digits", "canon_digits", device, _field_index(field_name),
                scalars.data_ptr(), keys.data_ptr(), n, k * n, m_pad)
    return keys


def canon_digits_plain(field_name: str, scalars: torch.Tensor, m_pad: int) -> torch.Tensor:
    k, n = scalars.shape[:2]
    limbs = get_field(field_name).from_mont(scalars.reshape(-1, NLIMBS))
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
    items = torch.arange(WINDOWS * n, dtype=torch.int64, device=scalars.device)
    keys = (d << 32).reshape(k, WINDOWS * n) | items
    return torch.nn.functional.pad(keys, (0, m_pad - WINDOWS * n))


def canon_mont(field_name: str, values: torch.Tensor) -> torch.Tensor:
    """K3 mode 1 (replaces pallas_msm._canon_kernel, domain mode): integer
    limbs (N, 8), any 256-bit pattern -> Montgomery form of value mod p."""
    device = _check(field_name, values=values)
    _check_shape("values", values, torch.int32, (None, NLIMBS))
    if _device_kind(device) == "cpu":
        return canon_mont_plain(field_name, values)
    out = torch.empty_like(values)
    if values.shape[0]:
        _launch("vdf_canon_mont", "canon_mont", device, _field_index(field_name),
                values.data_ptr(), out.data_ptr(), values.shape[0])
    return out


def canon_mont_plain(field_name: str, values: torch.Tensor) -> torch.Tensor:
    return get_field(field_name).to_mont(values)


# ---------------------------------------------------------------------
# K7: the pre-shifted generator table
# ---------------------------------------------------------------------


def shift_gens(field_name: str, gens: torch.Tensor) -> torch.Tensor:
    """K7 (replaces pallas_msm._shift_gens_kernel): generators (n, 3, 8)
    over ``field_name`` -> (W n, 3, 8), item w n + i = 2^(12 w) G_i."""
    device = _check(field_name, gens=gens)
    _check_shape("gens", gens, torch.int32, (None, 3, NLIMBS))
    if _device_kind(device) == "cpu":
        return shift_gens_plain(field_name, gens)
    n = gens.shape[0]
    table = torch.empty((WINDOWS * n, 3, NLIMBS), dtype=torch.int32, device=device)
    if n:
        _launch("vdf_shift_gens", "shift_gens", device, _field_index(field_name),
                gens.data_ptr(), table.data_ptr(), n)
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


def bucket_scan(field_name: str, table: torch.Tensor, keys: torch.Tensor, rows: int):
    """K4 (replaces pallas_msm._scan_kernel and the tail compaction after
    it).  ``keys`` (K, m_pad) sorted along each row, every item below
    ``table``'s length (as canon_digits and a sort give them); m_pad =
    cols * rows.  Returns (tails, tail_col, col_sums, col_flags)."""
    device = _check(field_name, table=table, keys=keys)
    _check_shape("table", table, torch.int32, (None, 3, NLIMBS))
    _check_shape("keys", keys, torch.int64, (None, None))
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
        _launch("vdf_scan", "scan", device, _field_index(field_name), table.data_ptr(),
                keys.data_ptr(), tails.data_ptr(), tail_col.data_ptr(), col_sums.data_ptr(),
                col_flags.data_ptr(), m_pad, rows, cols, k)
    return tails, tail_col, col_sums, col_flags


def bucket_scan_plain(field_name: str, table: torch.Tensor, keys: torch.Tensor, rows: int):
    k, m_pad = keys.shape
    cols = m_pad // rows
    device = keys.device
    d = keys >> 32
    edge = torch.full((k, 1), -1, dtype=torch.int64, device=device)
    heads = (d != torch.cat([edge, d[:, :-1]], 1)).reshape(k, cols, rows)
    is_tail = ((d != torch.cat([d[:, 1:], edge], 1)) & (d != 0)).reshape(k, cols, rows)
    d = d.reshape(k, cols, rows)
    pts = table[(keys & 0xFFFFFFFF).reshape(k, cols, rows)]  # (k, cols, rows, 3, 8)
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
        scratch_v = torch.empty((2, k, cols, 3, NLIMBS), dtype=torch.int32, device=device)
        scratch_f = torch.empty((2, k, cols), dtype=torch.int32, device=device)
        _launch("vdf_colscan", "colscan", device, _field_index(field_name),
                col_sums.data_ptr(), col_flags.data_ptr(), scratch_v.data_ptr(),
                scratch_f.data_ptr(), carries.data_ptr(), cols, k)
    return carries


def column_carries_plain(field_name: str, col_sums: torch.Tensor, col_flags: torch.Tensor):
    k, cols = col_flags.shape
    v = point_to_digits(col_sums)
    f = col_flags != 0
    c = torch.arange(cols, device=col_flags.device).expand(k, cols)
    d = 1
    while d < cols:  # one Hillis-Steele level: v[c] = v[c-d] + v[c] unless flagged
        sv = tuple(torch.roll(a, d, dims=1) for a in v)
        comb = select16(f, v, add16(field_name, sv, v))
        keep = c < d
        v = select16(keep, v, comb)
        f = torch.where(keep, f, f | torch.roll(f, d, dims=1))
        d *= 2
    incl = point_from_digits(v)
    first = _identity_rows(field_name, (k, 1), col_sums.device)
    return torch.cat([first, incl[:, :-1]], 1)


# ---------------------------------------------------------------------
# K6: sum_b b B_b
# ---------------------------------------------------------------------


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
        lvl1 = torch.empty((k, NB // RADIX, 2, 3, NLIMBS), dtype=torch.int32, device=device)
        lvl2 = torch.empty((k, RADIX, 3, 3, NLIMBS), dtype=torch.int32, device=device)
        _launch("vdf_bucket", "bucket", device, _field_index(field_name), tails.data_ptr(),
                tail_col.data_ptr(), carries.data_ptr(), lvl1.data_ptr(), lvl2.data_ptr(),
                out.data_ptr(), cols, k)
    return out


def _add_many(field_name: str, *pairs):
    """Several independent point adds in one add16 call."""
    p = tuple(torch.stack([a[c] for a, _ in pairs]) for c in range(3))
    q = tuple(torch.stack([b[c] for _, b in pairs]) for c in range(3))
    r = add16(field_name, p, q)
    return [tuple(r[c][j] for c in range(3)) for j in range(len(pairs))]


def _at(p, t: int):
    """Entry t along the last batch axis of a digit-tuple point."""
    return tuple(a[..., t, :] for a in p)


def bucket_sums_plain(field_name: str, tails: torch.Tensor, tail_col: torch.Tensor,
                      carries: torch.Tensor) -> torch.Tensor:
    k = tails.shape[0]
    has = tail_col >= 0
    idx = tail_col.clamp(min=0).to(torch.int64)[:, :, None, None].expand(k, NB, 3, NLIMBS)
    t16 = point_to_digits(tails)
    b16 = select16(has, add16(field_name, t16, point_to_digits(carries.gather(1, idx))), t16)
    first = torch.arange(NB, device=tails.device).expand(k, NB) == 0
    b16 = select16(first, identity16(field_name, b16[0]), b16)

    # Level 1: chunks of RADIX buckets V_t -> run = sum V_t, acc = sum t V_t.
    v = tuple(a.reshape(k, NB // RADIX, RADIX, -1) for a in b16)
    run, acc = _at(v, RADIX - 1), _at(v, RADIX - 1)
    (run,) = _add_many(field_name, (run, _at(v, RADIX - 2)))
    for t in range(RADIX - 3, -1, -1):
        acc, run = _add_many(field_name, (acc, run), (run, _at(v, t)))

    # Level 2: chunks of RADIX (run1, acc1) -> run, acc of runs, sum of accs.
    v = tuple(a.reshape(k, RADIX, RADIX, -1) for a in run)
    e = tuple(a.reshape(k, RADIX, RADIX, -1) for a in acc)
    run, acc, s = _at(v, RADIX - 1), _at(v, RADIX - 1), _at(e, RADIX - 1)
    run, s = _add_many(field_name, (run, _at(v, RADIX - 2)), (s, _at(e, RADIX - 2)))
    for t in range(RADIX - 3, -1, -1):
        acc, run, s = _add_many(field_name, (acc, run), (run, _at(v, t)), (s, _at(e, t)))

    # Level 3: one row of RADIX (run2, acc2, sum2) -> A3, A2, A1; Horner.
    v, e2, e1 = run, acc, s
    run, acc = _at(v, RADIX - 1), _at(v, RADIX - 1)
    a2, a1 = _at(e2, RADIX - 1), _at(e1, RADIX - 1)
    run, a2, a1 = _add_many(field_name, (run, _at(v, RADIX - 2)), (a2, _at(e2, RADIX - 2)),
                            (a1, _at(e1, RADIX - 2)))
    for t in range(RADIX - 3, -1, -1):
        if t > 0:  # the level's total has no weight
            acc, run, a2, a1 = _add_many(field_name, (acc, run), (run, _at(v, t)),
                                         (a2, _at(e2, t)), (a1, _at(e1, t)))
        else:
            acc, a2, a1 = _add_many(field_name, (acc, run), (a2, _at(e2, t)),
                                    (a1, _at(e1, t)))
    for _ in range(4):  # RADIX = 2^4
        acc = double16(field_name, acc)
    (acc,) = _add_many(field_name, (acc, a2))
    for _ in range(4):
        acc = double16(field_name, acc)
    (acc,) = _add_many(field_name, (acc, a1))
    return point_from_digits(acc)
