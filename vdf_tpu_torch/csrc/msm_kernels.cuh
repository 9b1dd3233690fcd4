// The bucket-accumulation kernels K3-K7 and K9 for sm_90a: the fixed-base
// Pedersen commit, and the variable-base MSM that reuses K3-K6 and ends in
// K9.
//
// The commit of n scalars s_i against generators G_i is one bucket
// accumulation over W * n items: item m = w * n + i carries the point
// T[m] = 2^(12 w) G_i (the pre-shifted table, K7) and the digit d_m =
// bits [12 w, 12 w + 12) of s_i.  With B_b the sum of the items of digit
// b, the commit is sum_b b B_b over the NB = 4096 buckets.  Window width
// c = 12 and W = 22 windows are those of vdf_tpu/curves/pallas_msm.py
// (:64-67); the layout below is the port's own.
//
//   K3  canon_digits_kernel   scalars -> canonical -> 22 window digits,
//                             written as int64 sort keys digit << 32 | item
//                             (replaces _canon_kernel, to_canonical mode),
//                             in one of two layouts: window-major in one
//                             row of W n items (the fixed-base commit), or
//                             one row a window over the n unshifted points
//                             (the variable-base MSM: each window is a
//                             batch row of K4-K6).  canon_mont_kernel puts
//                             canonical integers into Montgomery form (its
//                             domain mode).  One thread a value.
//   --  torch.sort of the keys (the JAX package sorts in XLA too).
//   K4  scan_kernel           the sorted items of a batch row are cut into
//                             `cols` columns of `rows` consecutive
//                             positions; one thread walks its column,
//                             accumulating the run of equal digits (reset at
//                             each run head).  Each digit's run has one
//                             tail, where the thread writes its sum straight
//                             to tails[digit], with the column index beside
//                             it when the run's head lies in an earlier
//                             column.  It also writes the column's last
//                             partial run sum and whether it holds a head
//                             (replaces _scan_kernel; the TPU wrote every
//                             prefix and compacted the tails afterwards).
//   K5  colscan_step_kernel,  segmented Hillis-Steele over the column
//       carry_shift_kernel    summaries, one launch a level, then a shift:
//                             the carry into each column (replaces
//                             _colscan_kernel).
//   K6  bucket_level{1,2}_kernel, bucket_final_kernel
//                             B_b = tail + carry (bucket 0 = identity), then
//                             sum_b b B_b in three radix-16 levels: a thread
//                             walks 16 entries keeping the running sum and
//                             the sum of running sums (= sum_t t V_t), and
//                             the levels combine as
//                             A1 + 16 (A2 + 16 A3) (replaces _bucket_kernel,
//                             whose two suffix scans over 4,096 buckets
//                             lived in one VMEM block; 4,096 points are
//                             384 KB, above a block's 227 KB of shared
//                             memory, so here they stay in global memory).
//   K7  shift_gens_kernel     table[w * n + i] = 2^(12 w) G_i: one thread a
//                             generator, 12 doublings a window (replaces
//                             _shift_gens_kernel).
//   K9  horner_kernel         the variable-base MSM's last step: 22 window
//                             sums S_w -> sum_w 2^(12 w) S_w, one thread a
//                             batch row, from the top window down: 12
//                             doublings, then one add (replaces
//                             _horner_kernel, which ran the same chain on
//                             one live element of an (8, 128) vreg).
//
// What bounds them on this card.  A point is 96 bytes and a complete add
// ~14 Montgomery products, so every kernel here is bound by the latency of
// dependent 32x32->64-bit multiply chains, not by memory: K4 does `rows`
// dependent adds a thread, K5 one a level, K6 ~30 + ~45 + ~60 across its
// levels, K7 264 doublings a thread, K9 264 doublings and 22 adds on a
// single thread (its 2.2 KB of input are nothing; a redesign has to cut the
// chain, not the bytes).  The layout's lever is parallelism:
// K4 has batch * cols threads (cols = ceil(22 n / rows)); the wrapper picks
// rows, and so the cost split between K4 (depth rows) and K5 (depth
// log2 cols).  No kernel uses atomics: each add has a fixed order, so each
// kernel equals its plain version (curves/kernels.py) bit for bit.
//
// The bodies use no CUDA intrinsic, so tests/test_torch_msm_kernel_host.py
// also compiles them as host C++ and runs them thread by thread.

#pragma once

#include <cstdint>

#include "curve.cuh"
#include "field.cuh"

namespace vdf {

constexpr int WINDOWS = 22;
constexpr int WINDOW_BITS = 12;
constexpr int NB = 1 << WINDOW_BITS;  // buckets a batch row
constexpr int RADIX = 16;             // K6: NB = RADIX^3
constexpr int PT = 3 * NL;            // u32 words a point
constexpr int PBLOCK = 128;           // threads a block, point kernels
constexpr int CBLOCK = 256;           // threads a block, K3

__device__ __forceinline__ void load_pt(Pt& p, const uint32_t* src, int64_t i) {
  const uint32_t* s = src + i * PT;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    p.x[j] = s[j];
    p.y[j] = s[NL + j];
    p.z[j] = s[2 * NL + j];
  }
}

__device__ __forceinline__ void store_pt(uint32_t* dst, int64_t i, const Pt& p) {
  uint32_t* d = dst + i * PT;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    d[j] = p.x[j];
    d[NL + j] = p.y[j];
    d[2 * NL + j] = p.z[j];
  }
}

__device__ __forceinline__ void copy_pt(Pt& r, const Pt& p) {
  copy(r.x, p.x);
  copy(r.y, p.y);
  copy(r.z, p.z);
}

// The group law, one out-of-line copy a field.  A complete add is ~14
// fully unrolled Montgomery products; inlined at each of a kernel's call
// sites it multiplies the code nvcc must compile and the instruction
// cache must hold, for no gain: the call's cost (the points pass through
// local memory) is small beside the products.
template <int K>
__device__ __noinline__ void add_pt(Pt& r, const Pt& p, const Pt& q) {
  point_add<K>(r, p, q);
}

template <int K>
__device__ __noinline__ void dbl_pt(Pt& r, const Pt& p) {
  point_double<K>(r, p);
}

// ---------------------------------------------------------------------
// K3: canonical digits (mode 0) and Montgomery domain (mode 1)
// ---------------------------------------------------------------------

// scalars (count, 8) Montgomery over field K (count = batch * n) -> keys.
//   window_rows == 0: keys (batch, m_pad), m_pad >= W n,
//     keys[k * m_pad + w * n + i] = digit_w(s) << 32 | (w * n + i);
//   window_rows != 0: keys (batch, W, m_pad), m_pad >= n,
//     keys[(k * W + w) * m_pad + i] = digit_w(s) << 32 | i.
// Entries past the items stay as the caller filled them (0: digit 0, item 0).
template <int K>
__global__ void __launch_bounds__(CBLOCK)
    canon_digits_kernel(const uint32_t* __restrict__ scalars, int64_t* __restrict__ keys,
                        int64_t n, int64_t count, int64_t m_pad, int window_rows) {
  const int64_t g = (int64_t)blockIdx.x * CBLOCK + threadIdx.x;
  if (g >= count) return;
  const int64_t k = g / n, i = g % n;
  uint32_t v[NL], int_one[NL] = {1, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < NL; ++j) v[j] = scalars[g * NL + j];
  canon<K>(v);               // any 256-bit pattern -> < p
  mont_mul<K>(v, v, int_one);  // v / R: the canonical integer
  int64_t* row = keys + k * m_pad * (window_rows ? WINDOWS : 1);
#pragma unroll
  for (int w = 0; w < WINDOWS; ++w) {
    const int bit = w * WINDOW_BITS, limb = bit >> 5, off = bit & 31;
    uint32_t d = v[limb] >> off;
    if (off > 32 - WINDOW_BITS && limb + 1 < NL) d |= v[limb + 1] << (32 - off);
    d &= NB - 1;
    if (window_rows) {
      row[w * m_pad + i] = ((int64_t)d << 32) | i;
    } else {
      const int64_t item = w * n + i;
      row[item] = ((int64_t)d << 32) | item;
    }
  }
}

// values (count, 8) integer limbs over field K -> their Montgomery form.
template <int K>
__global__ void __launch_bounds__(CBLOCK)
    canon_mont_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                      int64_t count) {
  const int64_t g = (int64_t)blockIdx.x * CBLOCK + threadIdx.x;
  if (g >= count) return;
  uint32_t v[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) v[j] = in[g * NL + j];
  canon<K>(v);
  uint32_t r2[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) r2[j] = mont_r2<K>(j);
  mont_mul<K>(v, v, r2);
#pragma unroll
  for (int j = 0; j < NL; ++j) out[g * NL + j] = v[j];
}

// ---------------------------------------------------------------------
// K7: the pre-shifted generator table
// ---------------------------------------------------------------------

template <int K>
__global__ void __launch_bounds__(PBLOCK)
    shift_gens_kernel(const uint32_t* __restrict__ gens, uint32_t* __restrict__ table,
                      int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * PBLOCK + threadIdx.x;
  if (i >= n) return;
  Pt p;
  load_pt(p, gens, i);
  canon<K>(p.x);
  canon<K>(p.y);
  canon<K>(p.z);
  for (int w = 0; w < WINDOWS; ++w) {
    store_pt(table, w * n + i, p);
    if (w + 1 == WINDOWS) break;
#pragma unroll 1
    for (int s = 0; s < WINDOW_BITS; ++s) dbl_pt<K>(p, p);
  }
}

// ---------------------------------------------------------------------
// K4: run sums down each column, tails written to their buckets
// ---------------------------------------------------------------------

// keys (batch, m_pad) sorted; m_pad = cols * rows.  Outputs:
//   tails (batch, NB, 3, 8)     sum of the run's items in the tail's column
//                               (written for each digit that has a run,
//                               bucket 0 excepted; the rest is left as the
//                               caller filled it)
//   tail_col (batch, NB)        the tail's column when the run's head lies
//                               in an earlier column, else left as filled
//   col_sums (batch, cols, 3, 8), col_flags (batch, cols)
//                               the column's last partial run sum, and
//                               whether the column holds a run head
template <int K>
__global__ void __launch_bounds__(PBLOCK)
    scan_kernel(const uint32_t* __restrict__ table, const int64_t* __restrict__ keys,
                uint32_t* __restrict__ tails, int32_t* __restrict__ tail_col,
                uint32_t* __restrict__ col_sums, int32_t* __restrict__ col_flags,
                int64_t m_pad, int64_t rows, int64_t cols, int64_t batch) {
  const int64_t g = (int64_t)blockIdx.x * PBLOCK + threadIdx.x;
  if (g >= batch * cols) return;
  const int64_t k = g / cols, c = g % cols;
  const int64_t* row = keys + k * m_pad;
  const int64_t pos0 = c * rows;
  int64_t prev_d = pos0 > 0 ? row[pos0 - 1] >> 32 : -1;
  int64_t key = row[pos0];
  bool seen_head = false;
  Pt acc, p;
#pragma unroll 1
  for (int64_t r = 0; r < rows; ++r) {
    const int64_t pos = pos0 + r;
    const int64_t next = pos + 1 < m_pad ? row[pos + 1] : -1;
    const int64_t d = key >> 32;
    const bool head = d != prev_d;
    load_pt(p, table, key & 0xFFFFFFFF);
    if (r == 0 || head) {
      copy_pt(acc, p);
    } else {
      add_pt<K>(acc, acc, p);
    }
    seen_head = seen_head || head;
    if (d != 0 && (next < 0 || (next >> 32) != d)) {  // the run's tail
      store_pt(tails, k * NB + d, acc);
      if (!seen_head) tail_col[k * NB + d] = (int32_t)c;
    }
    prev_d = d;
    key = next;
  }
  store_pt(col_sums, g, acc);
  col_flags[g] = seen_head ? 1 : 0;
}

// ---------------------------------------------------------------------
// K5: carries into the columns
// ---------------------------------------------------------------------

// One Hillis-Steele level over (batch, cols) summaries: for c >= d,
// v'[c] = f[c] ? v[c] : v[c - d] + v[c] and f'[c] = f[c] | f[c - d].
template <int K>
__global__ void __launch_bounds__(PBLOCK)
    colscan_step_kernel(const uint32_t* __restrict__ v_in, const int32_t* __restrict__ f_in,
                        uint32_t* __restrict__ v_out, int32_t* __restrict__ f_out,
                        int64_t cols, int64_t total, int64_t d) {
  const int64_t g = (int64_t)blockIdx.x * PBLOCK + threadIdx.x;
  if (g >= total) return;
  Pt v;
  load_pt(v, v_in, g);
  int32_t f = f_in[g];
  if (g % cols >= d) {
    if (!f) {
      Pt s;
      load_pt(s, v_in, g - d);
      add_pt<K>(v, s, v);
    }
    f |= f_in[g - d];
  }
  store_pt(v_out, g, v);
  f_out[g] = f;
}

// carries[c] = inclusive[c - 1], the identity for column 0.
template <int K>
__global__ void __launch_bounds__(PBLOCK)
    carry_shift_kernel(const uint32_t* __restrict__ incl, uint32_t* __restrict__ carries,
                       int64_t cols, int64_t total) {
  const int64_t g = (int64_t)blockIdx.x * PBLOCK + threadIdx.x;
  if (g >= total) return;
  Pt v;
  if (g % cols == 0) {
    set_identity<K>(v);
  } else {
    load_pt(v, incl, g - 1);
  }
  store_pt(carries, g, v);
}

// ---------------------------------------------------------------------
// K6: sum_b b B_b a batch row
// ---------------------------------------------------------------------

// B_b = tail + carry into the tail's column (when the run's head lies in
// an earlier column); bucket 0 is the identity.
template <int K>
__device__ __forceinline__ void load_bucket(Pt& B, const uint32_t* tails,
                                            const int32_t* tail_col,
                                            const uint32_t* carries, int64_t k, int64_t b,
                                            int64_t cols) {
  if (b == 0) {
    set_identity<K>(B);
    return;
  }
  load_pt(B, tails, k * NB + b);
  const int32_t c = tail_col[k * NB + b];
  if (c >= 0) {
    Pt carry;
    load_pt(carry, carries, k * cols + c);
    add_pt<K>(B, B, carry);
  }
}

// Level 1, one thread a chunk of RADIX buckets V_t = B_{RADIX j + t}:
// lvl1[k, j] = (run = sum_t V_t, acc = sum_t t V_t).  Walking t down,
// run holds S_t = sum_{t' >= t} V_t' and acc = S_15 + ... + S_1.
template <int K>
__global__ void __launch_bounds__(PBLOCK)
    bucket_level1_kernel(const uint32_t* __restrict__ tails,
                         const int32_t* __restrict__ tail_col,
                         const uint32_t* __restrict__ carries, uint32_t* __restrict__ lvl1,
                         int64_t cols, int64_t batch) {
  constexpr int64_t chunks = NB / RADIX;
  const int64_t g = (int64_t)blockIdx.x * PBLOCK + threadIdx.x;
  if (g >= batch * chunks) return;
  const int64_t k = g / chunks, base = (g % chunks) * RADIX;
  Pt run, acc, v;
  load_bucket<K>(run, tails, tail_col, carries, k, base + RADIX - 1, cols);
  load_bucket<K>(v, tails, tail_col, carries, k, base + RADIX - 2, cols);
  copy_pt(acc, run);
  add_pt<K>(run, run, v);
#pragma unroll 1
  for (int t = RADIX - 3; t >= 0; --t) {
    load_bucket<K>(v, tails, tail_col, carries, k, base + t, cols);
    add_pt<K>(acc, acc, run);
    add_pt<K>(run, run, v);
  }
  store_pt(lvl1, 2 * g, run);
  store_pt(lvl1, 2 * g + 1, acc);
}

// Level 2, one thread a chunk of RADIX level-1 outputs (run1, acc1):
// lvl2[k, j] = (run = sum_t run1_t, acc = sum_t t run1_t, sum_t acc1_t).
template <int K>
__global__ void __launch_bounds__(PBLOCK)
    bucket_level2_kernel(const uint32_t* __restrict__ lvl1, uint32_t* __restrict__ lvl2,
                         int64_t batch) {
  const int64_t g = (int64_t)blockIdx.x * PBLOCK + threadIdx.x;
  if (g >= batch * RADIX) return;
  const int64_t e = g * RADIX;  // first level-1 entry of the chunk
  Pt run, acc, s, v;
  load_pt(run, lvl1, 2 * (e + RADIX - 1));
  load_pt(s, lvl1, 2 * (e + RADIX - 1) + 1);
  copy_pt(acc, run);
  load_pt(v, lvl1, 2 * (e + RADIX - 2));
  add_pt<K>(run, run, v);
  load_pt(v, lvl1, 2 * (e + RADIX - 2) + 1);
  add_pt<K>(s, s, v);
#pragma unroll 1
  for (int t = RADIX - 3; t >= 0; --t) {
    add_pt<K>(acc, acc, run);
    load_pt(v, lvl1, 2 * (e + t));
    add_pt<K>(run, run, v);
    load_pt(v, lvl1, 2 * (e + t) + 1);
    add_pt<K>(s, s, v);
  }
  store_pt(lvl2, 3 * g, run);
  store_pt(lvl2, 3 * g + 1, acc);
  store_pt(lvl2, 3 * g + 2, s);
}

// Level 3, one thread a batch row: A3 = sum_t t run2_t, A2 = sum_t acc2_t,
// A1 = sum_t sum1_t, and out = A1 + 16 (A2 + 16 A3) by Horner.
template <int K>
__global__ void __launch_bounds__(PBLOCK)
    bucket_final_kernel(const uint32_t* __restrict__ lvl2, uint32_t* __restrict__ out,
                        int64_t batch) {
  const int64_t g = (int64_t)blockIdx.x * PBLOCK + threadIdx.x;
  if (g >= batch) return;
  const int64_t e = g * RADIX;
  Pt run, acc, a2, a1, v;
  load_pt(run, lvl2, 3 * (e + RADIX - 1));
  load_pt(a2, lvl2, 3 * (e + RADIX - 1) + 1);
  load_pt(a1, lvl2, 3 * (e + RADIX - 1) + 2);
  copy_pt(acc, run);
  load_pt(v, lvl2, 3 * (e + RADIX - 2));
  add_pt<K>(run, run, v);
  load_pt(v, lvl2, 3 * (e + RADIX - 2) + 1);
  add_pt<K>(a2, a2, v);
  load_pt(v, lvl2, 3 * (e + RADIX - 2) + 2);
  add_pt<K>(a1, a1, v);
#pragma unroll 1
  for (int t = RADIX - 3; t >= 0; --t) {
    add_pt<K>(acc, acc, run);
    if (t > 0) {  // the level's total has no weight
      load_pt(v, lvl2, 3 * (e + t));
      add_pt<K>(run, run, v);
    }
    load_pt(v, lvl2, 3 * (e + t) + 1);
    add_pt<K>(a2, a2, v);
    load_pt(v, lvl2, 3 * (e + t) + 2);
    add_pt<K>(a1, a1, v);
  }
#pragma unroll 1
  for (int s = 0; s < 4; ++s) dbl_pt<K>(acc, acc);  // RADIX = 2^4
  add_pt<K>(acc, acc, a2);
#pragma unroll 1
  for (int s = 0; s < 4; ++s) dbl_pt<K>(acc, acc);
  add_pt<K>(acc, acc, a1);
  store_pt(out, g, acc);
}

// ---------------------------------------------------------------------
// K9: sum_w 2^(12 w) S_w a batch row
// ---------------------------------------------------------------------

// sums (batch, W, 3, 8), least significant window first -> out (batch, 3, 8).
// One thread a batch row, from the identity: for w = W - 1 down to 0,
// acc = 2^12 acc + S_w.  The complete formulas take the identity and equal
// operands, so no case is special.
template <int K>
__global__ void __launch_bounds__(PBLOCK)
    horner_kernel(const uint32_t* __restrict__ sums, uint32_t* __restrict__ out,
                  int64_t batch) {
  const int64_t g = (int64_t)blockIdx.x * PBLOCK + threadIdx.x;
  if (g >= batch) return;
  Pt acc, s;
  set_identity<K>(acc);
#pragma unroll 1
  for (int w = WINDOWS - 1; w >= 0; --w) {
#pragma unroll 1
    for (int b = 0; b < WINDOW_BITS; ++b) dbl_pt<K>(acc, acc);
    load_pt(s, sums, g * WINDOWS + w);
    canon<K>(s.x);
    canon<K>(s.y);
    canon<K>(s.z);
    add_pt<K>(acc, acc, s);
  }
  store_pt(out, g, acc);
}

}  // namespace vdf
