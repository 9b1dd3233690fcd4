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
// Structure.  One thread a lane, one warp a block.  x, y and i (3 x 8 u32)
// live in registers and the t loop runs inside the kernel, in place of the
// Pallas fori_loop; the grid is ceil(lanes / BLOCK) and the ragged last
// block is masked here (the TPU padded lanes to 128 * block instead).
// Every value is canonical (< p) between rounds, so no lazy bound grows
// over t; inputs are canonicalised once on load, so any 256-bit pattern
// is taken.  A forward round is 259 squarings and 68 products on Fq (64
// on Fp): in the table base^(2k) is a squaring of base^k, then four
// squarings a window digit and one product a nonzero digit; an inverse
// round is two squarings and a product.
//
// What bounds it on this card.  The state is 96 bytes a lane, so memory
// traffic is nil: the kernels are bound by the integer pipes.  With the
// field library's multiplier (field.cuh: the primes' shape, a dedicated
// squaring, wide multiply-adds chained through the carry flag) a product
// is ~240 SASS operations, ~110 of them multiplies, and one warp alone keeps
// its scheduler ~3/4 busy: the time a round is the same from 1 lane to
// 8,192 (256 warps on the card's 528 schedulers) and the aggregate rate
// levels off from 32,768 lanes on.  BLOCK = 32 puts the main path's 256
// warps on all 132 SMs, at most two an SM on two schedulers, and costs
// nothing at large lane counts, where the power table's shared memory
// (16 KB a warp) and not the block size limits an SM to 14 warps.
//
// One lane on several threads was built and measured, and is not here:
// with a lane's limbs on 4 threads of a warp (two limbs each, radix-2^64
// rows, the reduction word and the 64-bit shift moved by __shfl_sync,
// carries between threads resolved with two ballots) a round took 1.5x as
// long at 8,192 lanes and 3x at 32,768: each of the four threads still
// ran ~2/3 of the one-thread operation count, so the shuffles and the
// redundant reduction cost more than the idle schedulers gave back (PERF.md).
//
// The power table.  K1's 16-entry table of powers base^0..base^15 is
// 16 x 8 u32 = 512 B a thread.  In registers it would pass the 255
// register limit, and the window digit that indexes it is a run-time
// value, which would force it to local memory anyway.  It lives in
// shared memory, laid out [entry][limb][thread] so that a warp's 32
// threads read 32 consecutive words (no bank conflicts): 16 KB a block,
// under the 48 KB static limit, so no cudaFuncSetAttribute is needed; the
// window digits of inv_alpha are compile-time tables in __constant__
// memory (they replace the TPU's scalar prefetch), and the first digit
// seeds the accumulator.
//
// The bodies use no CUDA intrinsic (field.cuh's carry-flag operations
// have a host form), so tests/test_torch_kernel_host.py also compiles
// them as host C++ and runs them lane by lane.

#pragma once

#include <cstdint>

#include "field.cuh"  // also vdf_consts.h, generated at build

namespace vdf {

constexpr int BLOCK = 32;  // one warp a block: 512 B of table a lane, 16 KB a block
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
  const int tid = threadIdx.x;
  const int64_t lane = (int64_t)blockIdx.x * BLOCK + tid;
  if (lane >= lanes) return;  // no block-wide barrier follows

  uint32_t x[NL], y[NL], i[NL];
  load_lane(x, x_in, lane);
  load_lane(y, y_in, lane);
  load_lane(i, i_in, lane);
  canon<K>(x);
  canon<K>(y);
  canon<K>(i);

  for (int64_t r = 0; r < t; ++r) {
    uint32_t base[NL], acc[NL], e[NL];
    add_raw(base, x, y);  // < 2p
    cond_sub_p<K>(base);

    // table[k] = base^k: base^(2k) = (base^k)^2, base^(2k+1) = base^(2k) base
    // (7 squarings and 7 products).  The powers and the accumulator are
    // lazy values (field.cuh: below 2p (1 + 2^-100), not below p).
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      tab[0][j][tid] = mont_one<K>(j);
      tab[1][j][tid] = base[j];
    }
#pragma unroll 1
    for (int k = 1; k < TABLE / 2; ++k) {
#pragma unroll
      for (int j = 0; j < NL; ++j) e[j] = tab[k][j][tid];
      mont_sqr_lazy<K>(acc, e);
#pragma unroll
      for (int j = 0; j < NL; ++j) tab[2 * k][j][tid] = acc[j];
      mont_mul_lazy<K>(acc, acc, base);
#pragma unroll
      for (int j = 0; j < NL; ++j) tab[2 * k + 1][j][tid] = acc[j];
    }

    // Left-to-right fixed window: the first digit seeds the accumulator.
    const int d0 = INV_ALPHA_DIGITS[K][0];
#pragma unroll
    for (int j = 0; j < NL; ++j) acc[j] = tab[d0][j][tid];
#pragma unroll 1
    for (int k = 1; k < VDF_N_DIGITS; ++k) {
#pragma unroll
      for (int s = 0; s < 4; ++s) mont_sqr_lazy<K>(acc, acc);
      const int d = INV_ALPHA_DIGITS[K][k];
      if (d) {  // uniform across the grid: every lane shares the exponent
#pragma unroll
        for (int j = 0; j < NL; ++j) e[j] = tab[d][j][tid];
        mont_mul_lazy<K>(acc, acc, e);
      }
    }
    canon<K>(acc);  // the ~330 lazy products of the root end here

    add_raw(y, x, i);  // y' = x + i
    cond_sub_p<K>(y);
    set_one<K>(e);
    add_raw(i, i, e);  // i' = i + 1
    cond_sub_p<K>(i);
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
  const int64_t lane = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  if (lane >= lanes) return;

  uint32_t x[NL], y[NL], i[NL];
  load_lane(x, x_in, lane);
  load_lane(y, y_in, lane);
  load_lane(i, i_in, lane);
  canon<K>(x);  // sub_mod takes canonical subtrahends
  canon<K>(y);
  canon<K>(i);

  for (int64_t r = 0; r < t; ++r) {
    uint32_t x5[NL], nx[NL], one[NL];
    set_one<K>(one);
    sub_mod<K>(i, i, one);  // i' = i - 1
    sub_mod<K>(nx, y, i);     // x' = y - i'
    mont_sqr_lazy<K>(x5, x);
    mont_sqr_lazy<K>(x5, x5);
    mont_mul<K>(x5, x5, x);  // x^5 < p: one operand lazy, the other canonical
    sub_mod<K>(y, x5, nx);   // y' = x^5 - x'
    copy(x, nx);
  }

  store_lane(x_out, lane, x);
  store_lane(y_out, lane, y);
  store_lane(i_out, lane, i);
}

}  // namespace vdf
