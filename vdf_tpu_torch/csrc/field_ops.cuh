// The device plane's field arithmetic for sm_90a: elementwise field ops
// (K10), the exact field sum over segments (K11) and the R1CS matvec (K12).
//
// None of them replaces a Pallas kernel.  They are the port's counterparts
// of arithmetic that the reference compiles with XLA under jax.jit:
//   K10 field_ew_kernel<K, OP>  vdf_tpu/fields/ops.py:182 (add), :200 (sub),
//       :215 (neg), :287 (mul), :334 (sqr), :341 (canon), and the linear fold
//       a + r b of vdf_tpu/nova/ivc.py:678 (_wfoldp_fn) and of the sumcheck's
//       tables (vdf_tpu/spartan/sumcheck.py:131);
//   K11 field_segsum_kernel<K>  vdf_tpu/spartan/sumcheck.py:20 (_sum_rows) and
//       the gamma-matvec's segment_sum (vdf_tpu/spartan/snark.py);
//   K12 r1cs_matvec_kernel<K>   vdf_tpu/nova/r1cs_device.py:28
//       (DeviceMatrix.matvec: segment_sum + partial_reduce).
// Without them the port ran each of these as its plain digit code
// (vdf_tpu_torch/fields/ops.py): ~160 tensor ops a product.
//
// Same bits as the plain versions, on every input.  Each op is written as
// the plain digit code computes it, so the two agree on any 256-bit
// pattern, not only on canonical elements:
//   add    (a + b mod 2^256), then one conditional subtraction of p;
//   sub    (a + 2p - b mod 2^256), then canon (< 4p -> < p);
//   neg    sub(0, canon(a));
//   mul    mont_mul: a b exact in 512 bits, (a b + m p) / R mod 2^256, one
//          conditional subtraction (field.cuh; every carry is kept);
//   sqr    mont_sqr, the same value as mul(a, a);
//   canon  canon<K>;
//   fold   add(a, mul(r, b)).
// K11 and K12 add their terms (the inputs, or K12's canonical products) as
// exact integers in 9 limbs and reduce once as the plain reduce_wide16 does:
// lo + hi 2^256 -> add(canon(lo), mont_mul(hi, R^2 mod p)), since
// mont_mul(hi, R^2) = hi R = hi 2^256 mod p.  A segment of at most 2^32
// terms of 256 bits fits 288 bits (the callers allow 2^30; a matrix row
// at most 2^15 entries, nova/r1cs_device.py).  An empty segment gives 0.
//
// What bounds them on this card.  K10 moves 64 to 128 bytes an element and
// does at most one product: memory-bound at the main path's sizes, and
// there below a launch's own cost (~15,000 to 60,000 elements, 1 to 6 MB).
// K11 and K12 are one warp a segment (a row): the lanes stride over the
// segment's terms (K12: gather z[col], one product) into 9-limb partial
// sums, which lane 0 adds and reduces.  K12 reads ~64 bytes and does one
// product an entry: 192,070 entries are ~12 MB and ~34M multiply-adds,
// bound by the bytes (~4 us).  One warp a row keeps a long row (up to 2^15
// entries) off one thread; a short row idles most of its lanes, which a
// later load-balanced form (a warp a chunk of entries) would not.
//
// The bodies use no CUDA intrinsic: the segment kernels' lane sums and
// combine step are __device__ functions on explicit buffers, and only the
// __global__ parts that pass partial sums through shared memory between a
// warp's lanes sit under __CUDACC__.  tests/test_torch_field_kernels.py
// compiles this file with g++ and runs K10's kernel thread by thread and
// K11's and K12's lane sums and combine step against Python integers.

#pragma once

#include <cstdint>

#include "field.cuh"  // also vdf_consts.h, generated at build

namespace vdf {

VDF_LIMB_TABLE(r_squared, VDF_R2_INIT)  // R^2 mod p: mont_mul(a, R^2) = a R

// K10's operations (the launcher's op argument; fields/kernels.py EW_OPS).
enum FieldOp { OP_ADD = 0, OP_SUB, OP_MUL, OP_SQR, OP_NEG, OP_CANON, OP_FOLD, N_FIELD_OPS };
constexpr int EW_BLOCK = 256;  // K10: one thread an element
constexpr int SEG_WARPS = 8;   // K11, K12: one warp a segment, 8 a block
constexpr int WARP = 32;
constexpr int WL = NL + 1;  // limbs of a wide sum

// The operands an op reads (1: a; 2: a, b; 3: a, b, c).
VDF_HOST_DEVICE constexpr int ew_operands(int op) {
  return op == OP_FOLD ? 3 : (op == OP_SQR || op == OP_NEG || op == OP_CANON) ? 1 : 2;
}

// r = (a + 2p - b) mod 2^256, canonical: the plain sub16.  r may alias a or b.
template <int K>
__device__ __forceinline__ void sub_plain(uint32_t r[NL], const uint32_t a[NL],
                                          const uint32_t b[NL]) {
  uint32_t t[NL];
  t[0] = add_cc(a[0], two_modulus<K>(0));
#pragma unroll
  for (int j = 1; j < NL - 1; ++j) t[j] = addc_cc(a[j], two_modulus<K>(j));
  t[NL - 1] = addc(a[NL - 1], two_modulus<K>(NL - 1));
  r[0] = sub_cc(t[0], b[0]);
#pragma unroll
  for (int j = 1; j < NL - 1; ++j) r[j] = subc_cc(t[j], b[j]);
  r[NL - 1] = subc(t[NL - 1], b[NL - 1]);
  canon<K>(r);
}

// r = OP(a, b, c) for one element (see the top of the file).
template <int K, int OP>
__device__ __forceinline__ void field_op(uint32_t r[NL], const uint32_t a[NL],
                                         const uint32_t b[NL], const uint32_t c[NL]) {
  if constexpr (OP == OP_ADD) {
    add_raw(r, a, b);
    cond_sub_p<K>(r);
  } else if constexpr (OP == OP_SUB) {
    sub_plain<K>(r, a, b);
  } else if constexpr (OP == OP_MUL) {
    mont_mul<K>(r, a, b);
  } else if constexpr (OP == OP_SQR) {
    mont_sqr<K>(r, a);
  } else if constexpr (OP == OP_NEG) {
    const uint32_t zero[NL] = {0, 0, 0, 0, 0, 0, 0, 0};
    uint32_t v[NL];
    copy(v, a);
    canon<K>(v);
    sub_plain<K>(r, zero, v);
  } else if constexpr (OP == OP_CANON) {
    copy(r, a);
    canon<K>(r);
  } else {  // OP_FOLD: a + r b with the scalar r in b's place and b in c's
    uint32_t t[NL];
    mont_mul<K>(t, b, c);
    add_raw(r, a, t);
    cond_sub_p<K>(r);
  }
}

// Element i of an (n, 8) operand, or its only element where the operand is
// broadcast (stride 0).
__device__ __forceinline__ void load_elem(uint32_t r[NL], const uint32_t* src, int64_t i,
                                          bool bcast) {
  const uint32_t* s = src + (bcast ? 0 : i * NL);
#pragma unroll
  for (int j = 0; j < NL; ++j) r[j] = s[j];
}

// K10: out[i] = OP(a[i], b[i], c[i]) for i < n; bit k of bcast set: operand
// k (a, b, c) is one element read by every thread.
template <int K, int OP>
__global__ void __launch_bounds__(EW_BLOCK)
    field_ew_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    const uint32_t* __restrict__ c, uint32_t* __restrict__ out, int64_t n,
                    int bcast) {
  const int64_t i = (int64_t)blockIdx.x * EW_BLOCK + threadIdx.x;
  if (i >= n) return;
  uint32_t va[NL], vb[NL], vc[NL], r[NL];
  load_elem(va, a, i, bcast & 1);
  if constexpr (ew_operands(OP) >= 2) load_elem(vb, b, i, bcast & 2);
  if constexpr (ew_operands(OP) >= 3) load_elem(vc, c, i, bcast & 4);
  field_op<K, OP>(r, va, vb, vc);
#pragma unroll
  for (int j = 0; j < NL; ++j) out[i * NL + j] = r[j];
}

// ---------------------------------------------------------------------
// Wide sums (K11, K12)
// ---------------------------------------------------------------------

__device__ __forceinline__ void wide_zero(uint32_t acc[WL]) {
#pragma unroll
  for (int j = 0; j < WL; ++j) acc[j] = 0;
}

// acc += v (9 limbs + 8); the caller's bound keeps the sum below 2^288.
__device__ __forceinline__ void wide_add(uint32_t acc[WL], const uint32_t v[NL]) {
  acc[0] = add_cc(acc[0], v[0]);
#pragma unroll
  for (int j = 1; j < NL; ++j) acc[j] = addc_cc(acc[j], v[j]);
  acc[NL] = addc(acc[NL], 0u);
}

// acc += w (9 limbs each).
__device__ __forceinline__ void wide_add_wide(uint32_t acc[WL], const uint32_t w[WL]) {
  acc[0] = add_cc(acc[0], w[0]);
#pragma unroll
  for (int j = 1; j < WL - 1; ++j) acc[j] = addc_cc(acc[j], w[j]);
  acc[WL - 1] = addc(acc[WL - 1], w[WL - 1]);
}

// r = (lo + hi 2^256) mod p, canonical, for a 9-limb sum (lo, hi): the
// plain reduce_wide16.
template <int K>
__device__ __forceinline__ void wide_reduce(uint32_t r[NL], const uint32_t acc[WL]) {
  uint32_t hi[NL] = {acc[NL], 0, 0, 0, 0, 0, 0, 0}, r2[NL], hi_r[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    r[j] = acc[j];
    r2[j] = r_squared<K>(j);
  }
  mont_mul<K>(hi_r, hi, r2);  // hi 2^256 mod p
  canon<K>(r);
  add_raw(r, r, hi_r);
  cond_sub_p<K>(r);
}

// [begin, end) of segment s: from offsets (CSR, s + 1 entries read) or, with
// offsets null, the s-th run of seg_len.
__device__ __forceinline__ void segment_of(const int64_t* offsets, int64_t seg_len, int64_t s,
                                           int64_t& begin, int64_t& end) {
  if (offsets) {
    begin = offsets[s];
    end = offsets[s + 1];
  } else {
    begin = s * seg_len;
    end = begin + seg_len;
  }
}

// K11, one lane: acc = sum of x[e] for e = begin + lane, + 32, ... < end.
__device__ __forceinline__ void segsum_lane(uint32_t acc[WL], const uint32_t* x, int64_t begin,
                                            int64_t end, int lane) {
  wide_zero(acc);
  for (int64_t e = begin + lane; e < end; e += WARP) {
    uint32_t v[NL];
    load_elem(v, x, e, false);
    wide_add(acc, v);
  }
}

// K12, one lane: acc = sum of mont_mul(vals[e], z[cols[e]]) for e = begin +
// lane, + 32, ... < end (the row's entries).
template <int K>
__device__ __forceinline__ void matvec_lane(uint32_t acc[WL], const int64_t* cols,
                                            const uint32_t* vals, const uint32_t* z,
                                            int64_t begin, int64_t end, int lane) {
  wide_zero(acc);
  for (int64_t e = begin + lane; e < end; e += WARP) {
    uint32_t v[NL], zc[NL], prod[NL];
    load_elem(v, vals, e, false);
    load_elem(zc, z, cols[e], false);
    mont_mul<K>(prod, v, zc);
    wide_add(acc, prod);
  }
}

// A warp's 32 partial sums, laid out [limb][lane] -> one canonical element.
template <int K>
__device__ __forceinline__ void segment_combine(uint32_t r[NL], const uint32_t* parts) {
  uint32_t acc[WL], w[WL];
  wide_zero(acc);
  for (int l = 0; l < WARP; ++l) {
#pragma unroll
    for (int j = 0; j < WL; ++j) w[j] = parts[j * WARP + l];
    wide_add_wide(acc, w);
  }
  wide_reduce<K>(r, acc);
}

#ifdef __CUDACC__
// One warp a segment: each lane's partial sum goes to the warp's slice of
// shared memory ([limb][lane], no bank conflicts); after the warp's barrier
// lane 0 adds the 32 and writes the segment's canonical sum.
__device__ __forceinline__ void segment_finish_warp(uint32_t (*parts)[WARP], const uint32_t acc[WL],
                                                    int lane) {
#pragma unroll
  for (int j = 0; j < WL; ++j) parts[j][lane] = acc[j];
  __syncwarp();
}

// K11: out[s] = sum of the terms of segment s, for s < segments.
template <int K>
__global__ void __launch_bounds__(SEG_WARPS * WARP)
    field_segsum_kernel(const uint32_t* __restrict__ x, const int64_t* __restrict__ offsets,
                        uint32_t* __restrict__ out, int64_t segments, int64_t seg_len) {
  __shared__ uint32_t parts[SEG_WARPS][WL][WARP];
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int64_t s = (int64_t)blockIdx.x * SEG_WARPS + warp;
  if (s >= segments) return;  // the whole warp leaves: no barrier is left waiting
  int64_t begin, end;
  segment_of(offsets, seg_len, s, begin, end);
  uint32_t acc[WL];
  segsum_lane(acc, x, begin, end, lane);
  segment_finish_warp(parts[warp], acc, lane);
  if (lane == 0) {
    uint32_t r[NL];
    segment_combine<K>(r, &parts[warp][0][0]);
#pragma unroll
    for (int j = 0; j < NL; ++j) out[s * NL + j] = r[j];
  }
}

// K12: out[row] = sum over the row's entries of vals[e] z[cols[e]], rows
// given by offsets (rows + 1 entries: a row-sorted COO's CSR offsets).
template <int K>
__global__ void __launch_bounds__(SEG_WARPS * WARP)
    r1cs_matvec_kernel(const int64_t* __restrict__ offsets, const int64_t* __restrict__ cols,
                       const uint32_t* __restrict__ vals, const uint32_t* __restrict__ z,
                       uint32_t* __restrict__ out, int64_t rows) {
  __shared__ uint32_t parts[SEG_WARPS][WL][WARP];
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int64_t row = (int64_t)blockIdx.x * SEG_WARPS + warp;
  if (row >= rows) return;
  uint32_t acc[WL];
  matvec_lane<K>(acc, cols, vals, z, offsets[row], offsets[row + 1], lane);
  segment_finish_warp(parts[warp], acc, lane);
  if (lane == 0) {
    uint32_t r[NL];
    segment_combine<K>(r, &parts[warp][0][0]);
#pragma unroll
    for (int j = 0; j < NL; ++j) out[row * NL + j] = r[j];
  }
}
#endif  // __CUDACC__

}  // namespace vdf
