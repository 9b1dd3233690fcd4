// Fused MinRoot eval (K1) and inverse eval (K2) for sm_90a.
//
// K1 replaces vdf_tpu/fields/pallas_field.py::_minroot_eval_kernel
// (launched by minroot_eval_tpu); K2 replaces ::_minroot_inverse_kernel
// (launched by minroot_inverse_tpu).  Both compute what those kernels
// compute, t MinRoot rounds per lane with the state never leaving the
// chip, over the port's own representation (field.cuh):
//
//   forward  x' = (x + y)^inv_alpha,  y' = x + i,  i' = i + 1
//   inverse  i' = i - 1,  x' = y - i',  y' = x^5 - x'
//
// Structure.  One thread per lane.  x, y and i (3 x 8 u32) live in
// registers and the t loop runs inside the kernel, in place of the
// Pallas fori_loop; the grid is ceil(lanes / BLOCK) and the ragged last
// block is masked here (the TPU padded lanes to 128 * block instead).
// Every value is canonical (< p) between rounds, so no lazy bound grows
// over t; inputs are canonicalised once on load, so any 256-bit pattern
// is taken.
//
// What bounds it on this card.  The state is 96 bytes a lane, so memory
// traffic is nil: the kernels are bound by the latency and throughput of
// 32x32->64-bit integer multiplies.  One forward round is ~330 Montgomery
// products (the 254-bit exponent, w = 4), each 2 x 64 IMAD.WIDE in a
// serial carry chain.  The main path's 8,192 lanes are 128 blocks of 64
// threads on 132 SMs: one block, two warps, an SM, so each SM waits on
// its multiply chains with almost nothing else to issue.
// This first design keeps each product's chain straight-line (fully
// unrolled CIOS, constants in __constant__ memory at uniform addresses)
// and leaves the wider levers (dedicated squaring, several lanes a
// thread for ILP, splitting a lane's product across a warp) to later
// work.
//
// The power table.  K1's 16-entry table of powers base^0..base^15 is
// 16 x 8 u32 = 512 B a thread.  In registers it would pass the 255
// register limit, and the window digit that indexes it is a run-time
// value, which would force it to local memory anyway.  It lives in
// shared memory, laid out [entry][limb][thread] so that a warp's 32
// threads read 32 consecutive words (no bank conflicts).  BLOCK = 64
// threads gives 32 KB a block, under the 48 KB static limit, so no
// cudaFuncSetAttribute is needed; the window digits of inv_alpha are
// compile-time tables in __constant__ memory (they replace the TPU's
// scalar prefetch), and the first digit seeds the accumulator.
//
// The bodies use no CUDA intrinsic, so tests/test_torch_kernel_host.py
// also compiles them as host C++ and runs them lane by lane.

#pragma once

#include <cstdint>

#include "consts.cuh"  // FIELD_CONSTS; vdf_consts.h, generated at build

namespace vdf {

constexpr int BLOCK = 64;
constexpr int TABLE = 16;  // 2^WINDOW entries

__constant__ unsigned char INV_ALPHA_DIGITS[2][VDF_N_DIGITS] = VDF_DIGITS_INIT;

__device__ __forceinline__ void load_lane(uint32_t r[NL], const uint32_t* src,
                                          int64_t lane) {
#pragma unroll
  for (int j = 0; j < NL; ++j) r[j] = src[lane * NL + j];
}

__device__ __forceinline__ void store_lane(uint32_t* dst, int64_t lane,
                                           const uint32_t a[NL]) {
#pragma unroll
  for (int j = 0; j < NL; ++j) dst[lane * NL + j] = a[j];
}

template <int K>
__global__ void __launch_bounds__(BLOCK)
    minroot_eval_kernel(const uint32_t* __restrict__ x_in,
                        const uint32_t* __restrict__ y_in,
                        const uint32_t* __restrict__ i_in, uint32_t* __restrict__ x_out,
                        uint32_t* __restrict__ y_out, uint32_t* __restrict__ i_out,
                        int64_t lanes, int64_t t) {
  __shared__ uint32_t tab[TABLE][NL][BLOCK];
  const FieldConsts& F = FIELD_CONSTS[K];
  const int tid = threadIdx.x;
  const int64_t lane = (int64_t)blockIdx.x * BLOCK + tid;
  if (lane >= lanes) return;  // no block-wide barrier follows

  uint32_t x[NL], y[NL], i[NL];
  load_lane(x, x_in, lane);
  load_lane(y, y_in, lane);
  load_lane(i, i_in, lane);
  canon(x, F);
  canon(y, F);
  canon(i, F);

  for (int64_t r = 0; r < t; ++r) {
    uint32_t base[NL], acc[NL], e[NL];
    add_raw(base, x, y);  // < 2p
    cond_sub_p(base, F);

    // table[k] = base^k
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      tab[0][j][tid] = F.one[j];
      tab[1][j][tid] = base[j];
    }
    copy(acc, base);
#pragma unroll 1
    for (int k = 2; k < TABLE; ++k) {
      mont_mul(acc, acc, base, F);
#pragma unroll
      for (int j = 0; j < NL; ++j) tab[k][j][tid] = acc[j];
    }

    // Left-to-right fixed window: the first digit seeds the accumulator.
    const int d0 = INV_ALPHA_DIGITS[K][0];
#pragma unroll
    for (int j = 0; j < NL; ++j) acc[j] = tab[d0][j][tid];
#pragma unroll 1
    for (int k = 1; k < VDF_N_DIGITS; ++k) {
#pragma unroll
      for (int s = 0; s < 4; ++s) mont_sqr(acc, acc, F);
      const int d = INV_ALPHA_DIGITS[K][k];
      if (d) {  // uniform across the grid: every lane shares the exponent
#pragma unroll
        for (int j = 0; j < NL; ++j) e[j] = tab[d][j][tid];
        mont_mul(acc, acc, e, F);
      }
    }

    add_raw(y, x, i);  // y' = x + i
    cond_sub_p(y, F);
    add_raw(i, i, F.one);  // i' = i + 1
    cond_sub_p(i, F);
    copy(x, acc);  // x' = (x + y)^inv_alpha
  }

  store_lane(x_out, lane, x);
  store_lane(y_out, lane, y);
  store_lane(i_out, lane, i);
}

template <int K>
__global__ void __launch_bounds__(BLOCK)
    minroot_inverse_kernel(const uint32_t* __restrict__ x_in,
                           const uint32_t* __restrict__ y_in,
                           const uint32_t* __restrict__ i_in,
                           uint32_t* __restrict__ x_out, uint32_t* __restrict__ y_out,
                           uint32_t* __restrict__ i_out, int64_t lanes, int64_t t) {
  const FieldConsts& F = FIELD_CONSTS[K];
  const int64_t lane = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  if (lane >= lanes) return;

  uint32_t x[NL], y[NL], i[NL];
  load_lane(x, x_in, lane);
  load_lane(y, y_in, lane);
  load_lane(i, i_in, lane);
  canon(x, F);  // sub_mod takes canonical subtrahends
  canon(y, F);
  canon(i, F);

  for (int64_t r = 0; r < t; ++r) {
    uint32_t x5[NL], nx[NL];
    sub_mod(i, i, F.one, F);  // i' = i - 1
    sub_mod(nx, y, i, F);     // x' = y - i'
    mont_sqr(x5, x, F);
    mont_sqr(x5, x5, F);
    mont_mul(x5, x5, x, F);  // x^5
    sub_mod(y, x5, nx, F);   // y' = x^5 - x'
    copy(x, nx);
  }

  store_lane(x_out, lane, x);
  store_lane(y_out, lane, y);
  store_lane(i_out, lane, i);
}

}  // namespace vdf
