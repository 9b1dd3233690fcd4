#!/usr/bin/env python3
"""Time one dependent point add and one dependent doubling on one GPU.

    python3 tools/point_op_latency.py

Builds a small kernel beside the port's own in which every thread (or every
group of 8 threads) runs a chain of CHAIN operations, each on the result of
the one before: acc = acc + Q, or acc = 2 acc.  The operations: the
out-of-line one-thread group law ``add_pt`` / ``dbl_pt`` of
csrc/msm_kernels.cuh, and the group law on 8 threads ``group_add`` /
``group_dbl`` of csrc/curve.cuh.  A launch of one thread (one group) gives
the latency of a dependent operation; launches of 32 and 128 threads (one
warp, one warp a scheduler of one SM) and of one such block on every SM show
what the same chain costs beside others.  Each reading is the mean of REPS
back-to-back launches between two CUDA events, taken RUNS times; the median
is printed, in microseconds an operation, with the card's name and power
limit.  Every chain's result is held against IntCurve.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

CHAIN = 1000
RUNS = 3
REPS = 5
GROUP = 8  # threads a group-law operation (csrc/curve.cuh)
# op -> name: the port's one-thread add_pt and dbl_pt, and the group law.
OPS = {0: "add_pt", 1: "dbl_pt", 2: "group_add", 3: "group_dbl"}

SOURCE = r"""
#include <cuda_runtime.h>
#include "msm_kernels.cuh"

using namespace vdf;

// Every thread: acc = pts[0], then n times acc = acc + pts[1] (op 0) or
// acc = 2 acc (op 1); thread 0 of block 0 stores its result.
template <int K>
__global__ void chain_kernel(const uint32_t* pts, uint32_t* out, int64_t n, int op) {
  Pt acc, q;
  load_pt(acc, pts, 0);
  load_pt(q, pts, 1);
#pragma unroll 1
  for (int64_t i = 0; i < n; ++i) {
    if (op == 0) {
      add_pt<K>(acc, acc, q);
    } else {
      dbl_pt<K>(acc, acc);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) store_pt(out, 0, acc);
}

// Every group of GROUP threads: slot P = pts[0], slot Q = pts[1], then n
// times P = P + Q (op 2, group_add) or P = 2 P (op 3, group_dbl); group 0 of
// block 0 stores P.
template <int K>
__global__ void __launch_bounds__(PBLOCK) group_chain_kernel(const uint32_t* pts, uint32_t* out,
                                                             int64_t n, int op) {
  __shared__ U4 bufs[PBLOCK / GROUP][GROUP_WORDS / 4];
  const int lane = threadIdx.x % GROUP;
  uint32_t* buf = reinterpret_cast<uint32_t*>(bufs[threadIdx.x / GROUP]);
  const unsigned mask = group_mask();
  for (int j = lane; j < NL; j += GROUP) buf[GS_ZERO * NL + j] = 0;
  for (int j = lane; j < 2 * PT; j += GROUP) buf[GS_P * NL + j] = pts[j];
  __syncwarp(mask);
#pragma unroll 1
  for (int64_t i = 0; i < n; ++i) {
    if (op == 2) {
      group_add<K>(buf, lane, mask);
    } else {
      group_dbl<K>(buf, lane, mask);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < GROUP)
    for (int j = lane; j < PT; j += GROUP) out[j] = buf[GS_P * NL + j];
}

extern "C" int point_chain(int field, const void* pts, void* out, int64_t n, int op,
                           int blocks, int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto kernel = op >= 2 ? (field == 0 ? group_chain_kernel<0> : group_chain_kernel<1>)
                        : (field == 0 ? chain_kernel<0> : chain_kernel<1>);
  kernel<<<blocks, threads, 0, s>>>((const uint32_t*)pts, (uint32_t*)out, n, op);
  return (int)cudaGetLastError();
}
"""


def _build_chain():
    from vdf_tpu_torch import _build

    out_dir = _build.BUILD_DIR / ("point_op_latency_" + _build.build_key())
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / _build.CONSTS_HEADER).write_text(_build.constants_header())
    (out_dir / "point_chain.cu").write_text(SOURCE)
    lib = out_dir / "libpoint_chain.so"
    subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC_DIR),
         "-I", str(out_dir), "-o", str(lib), str(out_dir / "point_chain.cu")],
        check=True, capture_output=True, text=True,
    )
    chain = ctypes.CDLL(str(lib)).point_chain
    chain.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    chain.restype = ctypes.c_int
    return chain


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("point_op_latency: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from vdf_tpu_torch import _build
    from vdf_tpu_torch.curves import (
        CURVES,
        Point,
        get_curve,
        get_int_curve,
        hash_to_curve_ints,
        stack_point,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)

    point_chain = _build_chain()
    device = torch.device("cuda", 0)
    curve_name = "pallas"
    c, ic = get_curve(curve_name), get_int_curve(curve_name)
    field = _build.FIELD_INDEX[CURVES[curve_name].base_field]
    aff = hash_to_curve_ints(curve_name, 2, domain=b"vdf_tpu/t")
    pts = stack_point(c.from_affine_ints(aff, device)).contiguous()
    out = torch.empty((1, 3, 8), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(op: int, blocks: int, threads: int, n: int = CHAIN) -> None:
        err = point_chain(field, pts.data_ptr(), out.data_ptr(), n, op, blocks, threads, stream)
        if err:
            raise SystemExit(f"point_chain launch failed: CUDA error {err}")

    p, q = (ic.from_affine(a) for a in aff)
    for op, name in OPS.items():  # each chain, on one thread (group), against IntCurve
        g = GROUP if op >= 2 else 1
        launch(op, 1, g)
        torch.cuda.synchronize()
        got = c.to_affine_ints(Point(*(out[:, k] for k in range(3))))[0]
        want = (ic.add(p, ic.scalar_mul(q, CHAIN)) if "add" in name
                else ic.scalar_mul(p, 1 << CHAIN))
        if got != ic.to_affine(want):
            raise SystemExit(f"point_op_latency: the {name} chain differs from IntCurve")

    # (blocks, threads a block): one thread (one group), one warp, 128
    # threads, 128 threads on every SM.
    for op, name in OPS.items():
        g = GROUP if op >= 2 else 1
        for blocks, block in ((1, g), (1, 32), (1, 128), (132, 128)):
            launch(op, blocks, block)  # warm-up
            runs = []
            for _ in range(RUNS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(REPS):
                    launch(op, blocks, block)
                end.record()
                torch.cuda.synchronize()
                runs.append(start.elapsed_time(end) / REPS * 1e3 / CHAIN)
            print(json.dumps({"op": name, "threads_an_op": g, "blocks": blocks, "threads": block,
                              "chain": CHAIN, "us": statistics.median(runs), "runs": runs}),
                  flush=True)


if __name__ == "__main__":
    main()
