#!/usr/bin/env python3
"""Time one dependent point add and one dependent doubling on one GPU.

    python3 tools/point_op_latency.py

Builds a small kernel beside the port's own (the out-of-line group law
``add_pt`` / ``dbl_pt`` of csrc/msm_kernels.cuh, as K4-K9 call it) in which
every thread runs a chain of CHAIN operations, each on the result of the one
before: acc = acc + Q, or acc = 2 acc.  A launch of one thread gives the
latency of a dependent operation; launches of 32 and 128 threads (one warp,
one warp a scheduler of one SM) and of one such block on every SM show what
the same chain costs beside others.  Each reading is the mean of REPS
back-to-back launches between two CUDA events, taken RUNS times; the median
is printed, in microseconds an operation, with the card's name and power
limit.  The add chain's result is held against IntCurve.  Exits non-zero
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
SHAPES = ((1, 1), (1, 32), (1, 128), (132, 128))  # (blocks, threads a block)

SOURCE = r"""
#include <cuda_runtime.h>
#include "msm_kernels.cuh"

// Every thread: acc = pts[0], then n times acc = acc + pts[1] (op 0) or
// acc = 2 acc (op 1); thread 0 of block 0 stores its result.
template <int K>
__global__ void chain_kernel(const uint32_t* pts, uint32_t* out, int64_t n, int op) {
  vdf::Pt acc, q;
  vdf::load_pt(acc, pts, 0);
  vdf::load_pt(q, pts, 1);
#pragma unroll 1
  for (int64_t i = 0; i < n; ++i) {
    if (op == 0) {
      vdf::add_pt<K>(acc, acc, q);
    } else {
      vdf::dbl_pt<K>(acc, acc);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) vdf::store_pt(out, 0, acc);
}

extern "C" int point_chain(int field, const void* pts, void* out, int64_t n, int op,
                           int blocks, int threads, void* stream) {
  auto kernel = field == 0 ? chain_kernel<0> : chain_kernel<1>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>((const uint32_t*)pts, (uint32_t*)out, n, op);
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

    launch(0, 1, 1)
    torch.cuda.synchronize()
    got = c.to_affine_ints(Point(*(out[:, k] for k in range(3))))[0]
    p, q = (ic.from_affine(a) for a in aff)
    if got != ic.to_affine(ic.add(p, ic.scalar_mul(q, CHAIN))):
        raise SystemExit("point_op_latency: P + 1000 Q differs from IntCurve")

    for blocks, threads in SHAPES:
        row = {"blocks": blocks, "threads": threads, "chain": CHAIN}
        for op, name in ((0, "add_us"), (1, "dbl_us")):
            launch(op, blocks, threads)  # warm-up
            runs = []
            for _ in range(RUNS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(REPS):
                    launch(op, blocks, threads)
                end.record()
                torch.cuda.synchronize()
                runs.append(start.elapsed_time(end) / REPS * 1e3 / CHAIN)
            row[name] = statistics.median(runs)
            row[name + "_runs"] = runs
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
