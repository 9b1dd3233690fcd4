#!/usr/bin/env python3
"""Split the time of K4's one-thread body into key reads, gathers, adds and
stores on one GPU.

    python3 tools/k4_split.py

Builds a scratch kernel beside the port's: K4's one-thread body as it was
first written (one thread a column walking ``rows`` sorted keys; for each it
reads the next key, gathers a 96-byte record word by word, then adds), on
the one-thread add of the tree it is built from (csrc/msm_kernels.cuh
``add_pt``), in five variants:

  full     the body, equal bit for bit to bucket_scan;
  gathers  the same key reads and record loads and the same stores, each add
           replaced by a copy;
  adds     one record loaded once and added on every row after the first:
           no key reads, no gathers, the column sum stored;
  keys     the key walk alone (heads and tails found, nothing loaded or
           added), the column flags stored;
  walk+stores  the key walk with the stores of a constant point to the
           tails and the column sums (stores alone = this - keys).

Shapes, on chip_smoke.py's inputs: the commit (Pallas, n = 2^14, K = 1 and
K = 2: 16,384 columns a row over a 34.6 MB table) and the MSM (n = 2^20, 22
rows of 47,663 columns over 100 MB of points).  Each reading is the mean of
REPS launches between two CUDA events, taken RUNS times; the median is
printed in milliseconds.  At the commit's shape every variant is also timed
"cold": each launch after writing a 64 MB buffer (the 50 MB L2 is then
holding the buffer, not the table), with events around the launch alone.
The port's own K4 forms are timed by tools/msm_stage_sweep.py.  One JSON
line a reading, after the card's name and power limit.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

RUNS = 3
REPS = 5
FLUSH_BYTES = 64 << 20
VARIANTS = ("full", "gathers", "adds", "keys", "walk+stores")

SOURCE = r"""
#include <cuda_runtime.h>
#include "msm_kernels.cuh"

using namespace vdf;

// K4's one-thread body as first written, with MODE picking what it does:
// 0 full, 1 gathers (adds -> copies), 2 adds alone, 3 key walk alone,
// 4 key walk + stores of a constant point.
template <int K, int MODE>
__global__ void __launch_bounds__(PBLOCK)
    split_kernel(const uint32_t* __restrict__ table, const int64_t* __restrict__ keys,
                 uint32_t* __restrict__ tails, int32_t* __restrict__ tail_col,
                 uint32_t* __restrict__ col_sums, int32_t* __restrict__ col_flags,
                 int64_t m_pad, int64_t rows, int64_t cols, int64_t batch) {
  const int64_t g = (int64_t)blockIdx.x * PBLOCK + threadIdx.x;
  if (g >= batch * cols) return;
  const int64_t k = g / cols, c = g % cols;
  const int64_t* row = keys + k * m_pad;
  const int64_t pos0 = c * rows;
  Pt acc, p;
  if (MODE == 2) {
    load_pt(p, table, g % 1024);
    copy_pt(acc, p);
#pragma unroll 1
    for (int64_t r = 1; r < rows; ++r) add_pt<K>(acc, acc, p);
    store_pt(col_sums, g, acc);
    return;
  }
  if (MODE == 3 || MODE == 4) set_identity<K>(acc);
  int64_t prev_d = pos0 > 0 ? row[pos0 - 1] >> 32 : -1;
  int64_t key = row[pos0];
  bool seen_head = false;
  int64_t sum = 0;
#pragma unroll 1
  for (int64_t r = 0; r < rows; ++r) {
    const int64_t pos = pos0 + r;
    const int64_t next = pos + 1 < m_pad ? row[pos + 1] : -1;
    const int64_t d = key >> 32;
    const bool head = d != prev_d;
    if (MODE <= 1) {
      load_pt(p, table, key & 0xFFFFFFFF);
      if (r == 0 || head || MODE == 1) {
        copy_pt(acc, p);
      } else {
        add_pt<K>(acc, acc, p);
      }
    } else {
      sum += key & 0xFFFFFFFF;
    }
    seen_head = seen_head || head;
    if (d != 0 && (next < 0 || (next >> 32) != d)) {
      if (MODE != 3) store_pt(tails, k * NB + d, acc);
      if (!seen_head) tail_col[k * NB + d] = (int32_t)c;
    }
    prev_d = d;
    key = next;
  }
  if (MODE != 3) store_pt(col_sums, g, acc);
  col_flags[g] = (seen_head ? 1 : 0) + (sum == -1 ? 2 : 0);
}

extern "C" int split_scan(int field, int mode, const void* table, const void* keys, void* tails,
                          void* tail_col, void* col_sums, void* col_flags, int64_t m_pad,
                          int64_t rows, int64_t cols, int64_t batch, void* stream) {
  using Fn = void (*)(const uint32_t*, const int64_t*, uint32_t*, int32_t*, uint32_t*, int32_t*,
                      int64_t, int64_t, int64_t, int64_t);
  static const Fn fns[2][5] = {
      {split_kernel<0, 0>, split_kernel<0, 1>, split_kernel<0, 2>, split_kernel<0, 3>,
       split_kernel<0, 4>},
      {split_kernel<1, 0>, split_kernel<1, 1>, split_kernel<1, 2>, split_kernel<1, 3>,
       split_kernel<1, 4>}};
  if (field < 0 || field > 1 || mode < 0 || mode > 4) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((batch * cols + PBLOCK - 1) / PBLOCK);
  fns[field][mode]<<<blocks, PBLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const int64_t*)keys, (uint32_t*)tails, (int32_t*)tail_col,
      (uint32_t*)col_sums, (int32_t*)col_flags, m_pad, rows, cols, batch);
  return (int)cudaGetLastError();
}
"""


def _build_split():
    from vdf_tpu_torch import _build

    out_dir = _build.BUILD_DIR / ("k4_split_" + _build.build_key())
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / _build.CONSTS_HEADER).write_text(_build.constants_header())
    (out_dir / "k4_split.cu").write_text(SOURCE)
    lib = out_dir / "libk4_split.so"
    subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC_DIR),
         "-I", str(out_dir), "-o", str(lib), str(out_dir / "k4_split.cu")],
        check=True, capture_output=True, text=True,
    )
    fn = ctypes.CDLL(str(lib)).split_scan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 6, *[ctypes.c_int64] * 4,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k4_split: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as S
    from vdf_tpu_torch import _build
    from vdf_tpu_torch.curves import CURVES
    from vdf_tpu_torch.curves import kernels as CK
    from vdf_tpu_torch.curves.bucket_msm import ROWS

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)

    split_scan = _build_split()
    device = torch.device("cuda", 0)
    curve_name = "pallas"
    bf = CURVES[curve_name].base_field
    field = _build.FIELD_INDEX[bf]
    stream = torch.cuda.current_stream().cuda_stream
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)

    def emit(**row):
        print(json.dumps(row), flush=True)

    def timed(fn, cold: bool) -> tuple[float, list]:
        fn()  # warm-up
        runs = []
        for _ in range(RUNS):
            if cold:
                total = 0.0
                for _ in range(REPS):
                    flush.fill_(1)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    fn()
                    end.record()
                    torch.cuda.synchronize()
                    total += start.elapsed_time(end)
                runs.append(total / REPS)
            else:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(REPS):
                    fn()
                end.record()
                torch.cuda.synchronize()
                runs.append(start.elapsed_time(end) / REPS)
        return statistics.median(runs), runs

    # The body reads int64 keys digit << 32 | item: the pairs of K3's keys in that width.
    shapes = []
    for k in (1, 2):
        gens, _, _, _, sorted_keys = S._commit_inputs(curve_name, S.COMMIT_N, k, device)
        shapes.append((f"commit n=2^14 K={k}", CK.shift_gens(bf, gens), S._keys64(sorted_keys),
                       True))
    _, pts, scalars, _ = S._msm_inputs(curve_name, S.MSM_N, device)
    args, _ = S._msm_stage_args(curve_name, pts, scalars)
    shapes.append(("msm n=2^20", pts, S._keys64(args["scan"][2]), False))

    for shape, table, keys, with_cold in shapes:
        batch, m_pad = keys.shape
        cols = m_pad // ROWS
        tails = CK._identity_rows(bf, (batch, CK.NB), device)
        tail_col = torch.full((batch, CK.NB), -1, dtype=torch.int32, device=device)
        sums = torch.empty((batch, cols, 3, 8), dtype=torch.int32, device=device)
        flags = torch.empty((batch, cols), dtype=torch.int32, device=device)

        def launch(mode: int) -> None:
            err = split_scan(field, mode, table.data_ptr(), keys.data_ptr(), tails.data_ptr(),
                             tail_col.data_ptr(), sums.data_ptr(), flags.data_ptr(), m_pad, ROWS,
                             cols, batch, stream)
            if err:
                raise SystemExit(f"split_scan launch failed: CUDA error {err}")

        launch(0)
        want = CK.bucket_scan(bf, table, keys, ROWS)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((tails, tail_col, sums, flags), want)):
            raise SystemExit(f"k4_split: the body disagrees with bucket_scan at {shape}")
        for mode, name in enumerate(VARIANTS):
            for cold in ((False, True) if with_cold else (False,)):
                ms, runs = timed(lambda: launch(mode), cold)
                emit(kernel="K4 one-thread body", variant=name, shape=shape, cols=cols, batch=batch,
                     l2="cold" if cold else "warm", ms=ms, runs=runs)
        del tails, tail_col, sums, flags


if __name__ == "__main__":
    main()
