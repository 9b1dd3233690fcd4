#!/usr/bin/env python3
"""Time the choices behind K4 (column scan), K5 (column carries), K6 (bucket
sums) and the column height ROWS on one GPU.

    python3 tools/msm_stage_sweep.py

At the commit's shape (Pallas, n = 2^14, one batch row) and at the MSM's
(n = 2^20, 22 batch rows), on chip_smoke.py's inputs:

  * K4 through its C launcher (the wrapper's host time would hide the
    kernel's at small grids) in its thread form and in its group form (8
    threads a column), at grids from 1,024 to 1.05M columns: commits at n =
    2^10, 2^12, 2^13 and 2^14 (K = 1 and 2), and the first 1, 2, 4, 8, 16
    and 22 window rows of the MSM, every form equal bit for bit to the
    wrapper's output.  The wrapper takes the group form below
    ``SCAN_GROUP_BELOW`` columns an SM (``scan_form``);
  * K5 with L = 1, 2, 4, 8, 16 columns a thread (the wrapper's own choice is
    ``curves.kernels.carry_columns``), the carries equal bit for bit in
    affine terms to the wrapper's (the projective bits follow L);
  * K6 with its schedule cut at chunks of 2^12 (one block a batch row), 2^9,
    2^7, 2^6 and 2^5 buckets and 32 to 512 threads a block (the wrapper's
    choice: ``BUCKET_CHUNK_BITS``, ``BUCKET_THREADS``), the output bit for
    bit the same for every cut;
  * the whole pipeline, keys -> sort -> K4 -> K5 -> K6 (-> K9), with ROWS =
    11, 16 and 22 items a column, each result equal in affine.

Each reading is the mean of REPS back-to-back calls between two CUDA events,
taken RUNS times; the median is printed in milliseconds, one JSON line a
reading, after the card's name and power limit.  Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

RUNS = 3
REPS = 5
CARRY_COLUMNS = (1, 2, 4, 8, 16)
BUCKET_CUTS = ((12, 512), (12, 256), (9, 512), (9, 128), (7, 128), (6, 64), (5, 32))
ROWS_SWEEP = (11, 16, 22)


def _median_ms(fn) -> float:
    import torch

    fn()  # warm-up
    runs = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / REPS)
    return statistics.median(runs)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("msm_stage_sweep: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as S
    from vdf_tpu_torch.curves import CURVES, Point, get_curve
    from vdf_tpu_torch.curves.bucket_msm import ROWS
    from vdf_tpu_torch.curves import kernels as CK

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)

    device = torch.device("cuda", 0)
    curve_name = "pallas"
    c = get_curve(curve_name)
    bf, sf = CURVES[curve_name].base_field, CURVES[curve_name].scalar_field

    def affine(pts):
        return c.to_affine_ints(Point(*(pts[:, k].contiguous() for k in range(3))))

    def emit(**row):
        print(json.dumps(row), flush=True)

    gens, ints, s, _, sorted_keys = S._commit_inputs(curve_name, S.COMMIT_N, 1, device)
    commit_args = S._commit_stage_args(curve_name, gens, ints, s, sorted_keys)
    table = CK.shift_gens(bf, gens)
    _, pts, scalars, _ = S._msm_inputs(curve_name, S.MSM_N, device)
    msm_args, _ = S._msm_stage_args(curve_name, pts, scalars)

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    k4_grids = []
    for bits in (10, 12, 13, 14):
        for k in ((1, 2) if bits == 14 else (1,)):
            g, _, _, _, keys = S._commit_inputs(curve_name, 1 << bits, k, device)
            k4_grids.append((f"commit n=2^{bits} K={k}", CK.shift_gens(bf, g), keys))
    a = msm_args["scan"]
    for rows in (1, 2, 4, 8, 16, CK.WINDOWS):
        k4_grids.append((f"msm n=2^20, {rows} window rows", a[1], a[2][:rows]))
    for shape, table_or_points, keys in k4_grids:
        batch, m_pad = keys.shape
        cols = m_pad // ROWS
        want = CK.bucket_scan(bf, table_or_points, keys, ROWS)
        chosen = CK.scan_form(batch * cols, ROWS, device)
        scan_args = (bf, table_or_points, keys, ROWS)
        for form in CK.SCAN_FORMS:
            out = S._scan_launch(scan_args, form)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(out, want)):
                raise SystemExit(f"K4 ({form} form) disagrees at {shape}")
            emit(kernel="K4", shape=shape, columns=batch * cols, columns_an_sm=batch * cols / sms,
                 form=form, own_choice=form == chosen,
                 ms=_median_ms(lambda form=form, out=out: S._scan_launch(scan_args, form, out)))

    for shape, args in (("commit n=2^14", commit_args), ("msm n=2^20", msm_args)):
        a = args["colscan"]
        own_rule = CK.carry_columns
        own = own_rule(a[2].shape[1])
        want = CK.column_carries(*a)
        sample = slice(0, None, max(1, a[2].shape[1] // 500))  # ~500 columns a row in affine
        for per_thread in CARRY_COLUMNS:
            CK.carry_columns = lambda cols, v=per_thread: v
            got = CK.column_carries(*a)
            if affine(got[:, sample].reshape(-1, 3, 8)) != affine(want[:, sample].reshape(-1, 3, 8)):
                raise SystemExit(f"K5 with L={per_thread} disagrees at the {shape} shape")
            emit(kernel="K5", shape=shape, columns_a_thread=per_thread, own_choice=per_thread == own,
                 ms=_median_ms(lambda: CK.column_carries(*a)))
        CK.carry_columns = own_rule

        a = args["bucket"]
        own = (CK.BUCKET_CHUNK_BITS, CK.BUCKET_THREADS)
        want = CK.bucket_sums(*a)
        for cut in BUCKET_CUTS:
            CK.BUCKET_CHUNK_BITS, CK.BUCKET_THREADS = cut
            if not torch.equal(CK.bucket_sums(*a), want):
                raise SystemExit(f"K6 cut at {cut} disagrees at the {shape} shape")
            emit(kernel="K6", shape=shape, chunk_bits=cut[0], threads=cut[1], own_choice=cut == own,
                 ms=_median_ms(lambda: CK.bucket_sums(*a)))
        CK.BUCKET_CHUNK_BITS, CK.BUCKET_THREADS = own

    def pipeline(table_or_points, scalar_rows, items, rows, window_rows):
        m_pad = -(-items // rows) * rows
        keys = CK.canon_digits(sf, scalar_rows, m_pad, window_rows)
        keys = torch.sort(keys[0] if window_rows else keys, dim=-1).values
        tails, tail_col, sums, flags = CK.bucket_scan(bf, table_or_points, keys, rows)
        out = CK.bucket_sums(bf, tails, tail_col, CK.column_carries(bf, sums, flags))
        return CK.horner(bf, out[None].contiguous()) if window_rows else out

    for shape, first, scalar_rows, items, window_rows in (
        ("commit n=2^14", table, s, CK.WINDOWS * S.COMMIT_N, False),
        ("msm n=2^20", pts, scalars[None], S.MSM_N, True),
    ):
        results = {}
        for rows in ROWS_SWEEP:
            results[rows] = affine(pipeline(first, scalar_rows, items, rows, window_rows))
            emit(pipeline=shape, rows=rows,
                 ms=_median_ms(lambda: pipeline(first, scalar_rows, items, rows, window_rows)))
        if len({tuple(v) for v in results.values()}) != 1:
            raise SystemExit(f"the {shape} pipeline disagrees between ROWS {ROWS_SWEEP}")


if __name__ == "__main__":
    main()
