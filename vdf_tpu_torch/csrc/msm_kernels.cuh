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
//                             written as sort keys of (digit, item): int32
//                             ((digit << 20) | item) ^ 2^31 where a row's
//                             items are below 2^20 (the JAX package's uint32
//                             key), else int64 digit << 32 | item (replaces
//                             _canon_kernel, to_canonical mode), in one of
//                             two layouts: window-major in one row of W n
//                             items (the fixed-base commit), or one row a
//                             window over the n unshifted points (the
//                             variable-base MSM: each window is a batch row
//                             of K4-K6); the padding after a row's items
//                             too, in the one launch.  canon_mont_kernel
//                             puts canonical integers into Montgomery form
//                             (its domain mode).  One thread a value, 16-byte
//                             loads.  See the section's note.
//   --  torch.sort of the keys (the JAX package sorts in XLA too).
//   K4  scan_kernel,          the sorted items of a batch row are cut into
//       scan_group_kernel     `cols` columns of `rows` consecutive
//                             positions; each column is walked down,
//                             accumulating the run of equal digits (reset at
//                             each run head), by one thread (grids that fill
//                             the card) or by a group of 8 threads on the
//                             group law of curve.cuh (small grids).  Each
//                             digit's run has one tail, where the walk writes
//                             its sum straight to tails[digit], with the
//                             column index beside it when the run's head lies
//                             in an earlier column.  It also writes the
//                             column's last partial run sum and whether it
//                             holds a head (replaces _scan_kernel; the TPU
//                             wrote every prefix and compacted the tails
//                             afterwards).  See the section's note.
//   K5  colscan_tile_kernel,  a blocked segmented scan over the column
//       colscan_rows_kernel,  summaries in three passes (a tile's thread
//       colscan_carry_kernel  totals, the tile totals of a row, then each
//                             thread's walk): the carry into each column,
//                             the identity for column 0 (replaces
//                             _colscan_kernel).  See the section's note.
//   K6  bucket_tree_kernel,   B_b = tail + carry (bucket 0 = identity), then
//       bucket_finish_kernel  sum_b b B_b by halving: pair sums V and, for
//                             each bit of b, a balanced tree over the
//                             buckets that have it set, 34 operations deep
//                             (replaces _bucket_kernel, whose two suffix
//                             scans over 4,096 buckets lived in one VMEM
//                             block; 4,096 points are 384 KB, above a
//                             block's 227 KB of shared memory, so here they
//                             stay in global memory, in the L2 cache).  See
//                             the section's note.
//   K7  shift_gens_kernel,    table[w * n + i] = 2^(12 w) G_i, 12 doublings
//       shift_gens_group_kernel  a window, by one thread a generator on lazy
//                             values (grids that fill the card) or by a
//                             group of 8 threads on the group law (small
//                             grids: the engine's key) (replaces
//                             _shift_gens_kernel).  See the section's note.
//   K9  horner_kernel         the variable-base MSM's last step: 22 window
//                             sums S_w -> sum_w 2^(12 w) S_w, one group of
//                             8 threads a batch row, from the top window
//                             down: 12 doublings, then one add (replaces
//                             _horner_kernel, which ran the same chain on
//                             one live element of an (8, 128) vreg).
//
// What bounds them on this card.  A point is 96 bytes and a complete add 12
// Montgomery products (3b a is a small-constant multiply), so K4, K6, K7
// and K9 are bound by the latency of dependent 32x32->64-bit multiply
// chains, not by memory: K4 does `rows` dependent adds a column, K6 34
// operations (1 + 11 adds, then 11 doublings and 11 adds on one thread),
// K7 252 doublings a generator, K9 264 doublings and 22 adds a batch row (its
// 2.2 KB of input are nothing; the chain cannot be cut, so a group of 8
// threads runs each operation, which cuts its latency: curve.cuh).  K4 also
// gathers a 96-byte record an add from a table of 34.6 to 100 MB, which its
// adds hide; where its grid is too small to keep the schedulers busy it
// runs a column on a group, which shortens the chain of adds.
// K5 is 15 adds deep at the commit's shape; at the MSM's it is bound by how
// it moves the column summaries (100 MB at n = 2^20), which is why it reads
// them twice, writes the carries once, and does both through shared memory
// in 16-byte pieces.  The layout's lever is parallelism: K4 has batch * cols
// columns (cols = ceil(22 n / rows)); the wrapper picks rows, and so the
// cost split between K4 (depth rows) and K5 (work and bytes by cols).  No
// kernel uses atomics: each add has a fixed order, so each kernel equals
// its plain version (curves/kernels.py) bit for bit.
//
// tests/test_torch_msm_kernel_host.py compiles this file as host C++.  K3,
// K7's thread form and K4's use no CUDA intrinsic and run there thread by
// thread as they are.  K4-K6, K7's group form and K9 synchronise inside a
// block or a group, so what a thread (or a group's lane) does between two
// barriers is a __device__ function on explicit buffers; the __global__
// kernels that call them between barriers are for nvcc alone (#ifdef
// __CUDACC__), and the host test calls the same functions from loops of its
// own.  The grouped walks (K4's and K7's group forms, K9) are templates over
// their lanes: on the card each thread is a lane (GroupLanes), on the host
// the test runs the lanes one after another at each step.

#pragma once

#include <cstdint>

#include "curve.cuh"
#include "field.cuh"

namespace vdf {

constexpr int WINDOWS = 22;
constexpr int WINDOW_BITS = 12;
constexpr int NB = 1 << WINDOW_BITS;  // buckets a batch row
constexpr int PT = 3 * NL;            // u32 words a point
constexpr int PBLOCK = 128;           // threads a block, point kernels
constexpr int CBLOCK = 64;            // threads a block, K3: n = 2^14 scalars are 256 blocks

// Point i of a (.., 3, 8) array, word by word: the kernels move points in
// 16-byte pieces (load_pt4, store_pt4); the tools' scratch kernels use these.
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
// 128-bit access to points and limbs
// ---------------------------------------------------------------------

// A point record is 96 bytes, six 16-byte pieces; records start on 16-byte
// boundaries (torch allocations are 512-byte aligned; the wrappers of K3
// and K7, whose inputs come from callers, check theirs).
constexpr int PIECES = PT / 4;  // 16-byte pieces a point
static_assert(PIECES <= GROUP, "a group's lanes move a record a piece each");

__device__ __forceinline__ void load_pt4(Pt& p, const U4* src) {
  U4 q[PIECES];
#pragma unroll
  for (int i = 0; i < PIECES; ++i) q[i] = src[i];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p.x[j] = q[0].w[j];
    p.x[4 + j] = q[1].w[j];
    p.y[j] = q[2].w[j];
    p.y[4 + j] = q[3].w[j];
    p.z[j] = q[4].w[j];
    p.z[4 + j] = q[5].w[j];
  }
}

__device__ __forceinline__ void store_pt4(U4* dst, const Pt& p) {
  U4 q[PIECES];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    q[0].w[j] = p.x[j];
    q[1].w[j] = p.x[4 + j];
    q[2].w[j] = p.y[j];
    q[3].w[j] = p.y[4 + j];
    q[4].w[j] = p.z[j];
    q[5].w[j] = p.z[4 + j];
  }
#pragma unroll
  for (int i = 0; i < PIECES; ++i) dst[i] = q[i];
}

// Point i of a (.., 3, 8) array in device memory.
__device__ __forceinline__ const U4* pt_at(const uint32_t* base, int64_t i) {
  return reinterpret_cast<const U4*>(base + i * PT);
}
__device__ __forceinline__ U4* pt_at(uint32_t* base, int64_t i) {
  return reinterpret_cast<U4*>(base + i * PT);
}

// Element i of a (.., 8) limb array, as two 16-byte pieces.
__device__ __forceinline__ void load_limbs4(uint32_t v[NL], const uint32_t* src, int64_t i) {
  const U4* s = reinterpret_cast<const U4*>(src + i * NL);
  const U4 lo = s[0], hi = s[1];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = lo.w[j];
    v[4 + j] = hi.w[j];
  }
}

__device__ __forceinline__ void store_limbs4(uint32_t* dst, int64_t i, const uint32_t v[NL]) {
  U4 lo, hi;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo.w[j] = v[j];
    hi.w[j] = v[4 + j];
  }
  U4* d = reinterpret_cast<U4*>(dst + i * NL);
  d[0] = lo;
  d[1] = hi;
}

#ifdef __CUDACC__
// The lanes of a group on the card: each thread is one lane and runs its
// own part of a step; sync() is the group's own __syncwarp.  The host test
// has a serial counterpart that runs the lanes one after another.
struct GroupLanes {
  int lane;
  unsigned mask;
  U4 pre_;  // lanes below PIECES: the lane's piece of the next record, in flight
  __device__ GroupLanes() : lane((int)(threadIdx.x % GROUP)), mask(group_mask()) {}
  template <class F>
  __device__ __forceinline__ void each(F f) {
    f(lane);
  }
  __device__ __forceinline__ void sync() { __syncwarp(mask); }
  __device__ __forceinline__ U4& pre(int) { return pre_; }
  template <int K>
  __device__ __forceinline__ void add(uint32_t* buf) {
    group_add<K>(buf, lane, mask);
  }
  template <int K>
  __device__ __forceinline__ void dbl(uint32_t* buf) {
    group_dbl<K>(buf, lane, mask);
  }
};
#endif  // __CUDACC__

// Lane l < PIECES: piece l of slot P to point i of dst; the last lane also
// writes the int32 `value` to *flag when `write_flag`.
__device__ __forceinline__ void group_store_lane(const uint32_t* buf, uint32_t* dst, int64_t i,
                                                 int32_t* flag, int32_t value, bool write_flag,
                                                 int lane) {
  if (lane < PIECES) pt_at(dst, i)[lane] = reinterpret_cast<const U4*>(buf + GS_P * NL)[lane];
  if (lane == GROUP - 1 && write_flag) *flag = value;
}

// ---------------------------------------------------------------------
// K3: canonical digits (mode 0) and Montgomery domain (mode 1)
// ---------------------------------------------------------------------
//
// Sort keys come in two widths with the same (digit, item) order:
//   key_bits 64: int64 digit << 32 | item;
//   key_bits 32: int32 ((digit << 20) | item) ^ 2^31, for items below 2^20:
//     the JAX package's uint32 key digit << sh | item (pallas_msm.py:504-513)
//     at sh = 20, in offset binary, so that signed int32 order (torch.sort's)
//     is the order of the unsigned (digit << 20) | item, which is the int64
//     keys' order.
// The padding key (digit 0, item 0), 0 or INT32_MIN, sorts first.  K4 reads
// either width through load_key, in the int64 form.
//
// What bounds K3: bytes.  It reads 32 bytes a scalar and writes 22 keys of 4
// or 8 bytes; its one Montgomery product a scalar is small beside them.  So
// a thread loads its scalar as two 16-byte pieces, consecutive threads write
// consecutive keys of each window, the kernel writes every key, the padding
// included (one launch a call, each key byte written once), and blocks of
// CBLOCK threads spread the n = 2^14 scalars of a commit over every SM.

constexpr int KEY_ITEM_BITS = 20;  // a 32-bit key's item field
constexpr int64_t KEY32_ITEMS = (int64_t)1 << KEY_ITEM_BITS;  // items a 32-bit key row can hold

__device__ __forceinline__ void store_key(void* keys, int64_t at, uint32_t digit, int64_t item,
                                          int key_bits) {
  if (key_bits == 32) {
    const uint32_t v = ((digit << KEY_ITEM_BITS) | (uint32_t)item) ^ 0x80000000u;
    reinterpret_cast<int32_t*>(keys)[at] = (int32_t)v;
  } else {
    reinterpret_cast<int64_t*>(keys)[at] = ((int64_t)digit << 32) | item;
  }
}

// Key i in the int64 form digit << 32 | item, from either width.
__device__ __forceinline__ int64_t load_key(const void* keys, int64_t i, int key_bits) {
  if (key_bits == 32) {
    const uint32_t v = (uint32_t)reinterpret_cast<const int32_t*>(keys)[i] ^ 0x80000000u;
    return ((int64_t)(v >> KEY_ITEM_BITS) << 32) | (v & (uint32_t)(KEY32_ITEMS - 1));
  }
  return reinterpret_cast<const int64_t*>(keys)[i];
}

// scalars (count, 8) Montgomery over field K (count = batch * n) -> keys.
//   window_rows == 0: key rows (batch, m_pad), m_pad >= W n, position
//     w n + i holding (digit_w(s_i), item w n + i);
//   window_rows != 0: key rows (batch, W, m_pad), m_pad >= n, position i of
//     row w holding (digit_w(s_i), item i).
// Every position past a row's items holds the padding key.  Thread g takes
// scalar g (g < count) and padding position g of all the rows (g < key rows
// times the padding a row); the grid covers the larger of the two.
template <int K>
__global__ void __launch_bounds__(CBLOCK)
    canon_digits_kernel(const uint32_t* __restrict__ scalars, void* __restrict__ keys,
                        int64_t n, int64_t count, int64_t m_pad, int window_rows,
                        int key_bits) {
  const int64_t g = (int64_t)blockIdx.x * CBLOCK + threadIdx.x;
  const int64_t span = window_rows ? n : WINDOWS * n;  // items a key row
  const int64_t pad = m_pad - span;
  const int64_t key_rows = count / n * (window_rows ? WINDOWS : 1);
  if (g < key_rows * pad) store_key(keys, g / pad * m_pad + span + g % pad, 0, 0, key_bits);
  if (g >= count) return;
  const int64_t k = g / n, i = g % n;
  uint32_t v[NL], int_one[NL] = {1, 0, 0, 0, 0, 0, 0, 0};
  load_limbs4(v, scalars, g);
  canon<K>(v);               // any 256-bit pattern -> < p
  mont_mul<K>(v, v, int_one);  // v / R: the canonical integer
  const int64_t row = k * m_pad * (window_rows ? WINDOWS : 1);
#pragma unroll
  for (int w = 0; w < WINDOWS; ++w) {
    const int bit = w * WINDOW_BITS, limb = bit >> 5, off = bit & 31;
    uint32_t d = v[limb] >> off;
    if (off > 32 - WINDOW_BITS && limb + 1 < NL) d |= v[limb + 1] << (32 - off);
    d &= NB - 1;
    if (window_rows) {
      store_key(keys, row + w * m_pad + i, d, i, key_bits);
    } else {
      store_key(keys, row + w * n + i, d, w * n + i, key_bits);
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
  load_limbs4(v, in, g);
  canon<K>(v);
  uint32_t r2[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) r2[j] = mont_r2<K>(j);
  mont_mul<K>(v, v, r2);
  store_limbs4(out, g, v);
}

// ---------------------------------------------------------------------
// K7: the pre-shifted generator table
// ---------------------------------------------------------------------
//
// gens (n, 3, 8) -> table (W n, 3, 8), table[w n + i] = 2^(12 w) G_i: each
// generator's coordinates reduced (canon), then 21 windows of 12 doublings,
// every window stored canonical.  Replaces vdf_tpu/curves/pallas_msm.py:259
// _shift_gens_kernel.  What bounds it: depth, 252 dependent doublings a
// generator, on grids that are small beside the card (the engine's key of
// 4,096 generators is 31 an SM, a commit's 16,384 is 124).  Two forms, the
// same bits:
//   thread form (shift_gens_kernel): one thread a generator; the 12
//     doublings of a window are one out-of-line call (dbl_window) on lazy
//     values (point_double_lazy: no last subtraction in the products,
//     small-constant multiplies for 3b, 9b, 8 and 2), reduced once a window,
//     where the table takes canonical limbs.  For grids that fill the
//     schedulers.
//   group form (shift_gens_group_kernel): one group of GROUP lanes a
//     generator on the group law of curve.cuh, a doubling two products deep
//     where one thread runs eight in a row.  For grids that leave the
//     schedulers idle, where the chain's latency, not issue, is the bound.
// The wrapper picks the form from the generators an SM (curves/kernels.py
// shift_form).

// The thread form's window: 12 lazy doublings of p, then p reduced.
template <int K>
__device__ __noinline__ void dbl_window(Pt& p) {
#pragma unroll 1
  for (int s = 0; s < WINDOW_BITS; ++s) point_double_lazy<K>(p, p);
  canon<K>(p.x);
  canon<K>(p.y);
  canon<K>(p.z);
}

template <int K>
__global__ void __launch_bounds__(PBLOCK)
    shift_gens_kernel(const uint32_t* __restrict__ gens, uint32_t* __restrict__ table,
                      int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * PBLOCK + threadIdx.x;
  if (i >= n) return;
  Pt p;
  load_pt4(p, pt_at(gens, i));
  canon<K>(p.x);
  canon<K>(p.y);
  canon<K>(p.z);
  for (int w = 0; w < WINDOWS; ++w) {
    store_pt4(pt_at(table, w * n + i), p);
    if (w + 1 == WINDOWS) break;
    dbl_window<K>(p);
  }
}

constexpr int SHIFT_GROUPS = PBLOCK / GROUP;  // generators a block, group form

// Lane l < PIECES: piece l of G_i into slot P; the zero slot.
__device__ __forceinline__ void shift_stage_lane(uint32_t* buf, const uint32_t* gens, int64_t i,
                                                 int lane) {
  if (lane < PIECES) reinterpret_cast<U4*>(buf + GS_P * NL)[lane] = pt_at(gens, i)[lane];
  for (int j = lane; j < NL; j += GROUP) buf[GS_ZERO * NL + j] = 0;
}

// Lane l < 3: coordinate l of slot P reduced below p.
template <int K>
__device__ __forceinline__ void shift_canon_lane(uint32_t* buf, int lane) {
  if (lane < 3) canon<K>(buf + (GS_P + lane) * NL);
}

// A group's walk for generator i.  A window's store reads slot P before the
// next doubling's first step; a doubling writes P only in its last step,
// after its first sync, so no sync of its own follows the store.
template <int K, class Lanes>
__device__ __forceinline__ void shift_gens_walk(Lanes& L, uint32_t* buf, const uint32_t* gens,
                                                uint32_t* table, int64_t n, int64_t i) {
  L.each([&](int lane) { shift_stage_lane(buf, gens, i, lane); });
  L.sync();
  L.each([&](int lane) { shift_canon_lane<K>(buf, lane); });
  L.sync();
#pragma unroll 1
  for (int w = 0; w < WINDOWS; ++w) {
    L.each([&](int lane) { group_store_lane(buf, table, w * n + i, nullptr, 0, false, lane); });
    if (w + 1 == WINDOWS) break;
#pragma unroll 1
    for (int s = 0; s < WINDOW_BITS; ++s) L.template dbl<K>(buf);
  }
}

#ifdef __CUDACC__

// A block of SHIFT_GROUPS groups.
template <int K>
__global__ void __launch_bounds__(PBLOCK)
    shift_gens_group_kernel(const uint32_t* __restrict__ gens, uint32_t* __restrict__ table,
                            int64_t n) {
  __shared__ U4 bufs[SHIFT_GROUPS][GROUP_WORDS / 4];
  const int group = threadIdx.x / GROUP;
  const int64_t i = (int64_t)blockIdx.x * SHIFT_GROUPS + group;
  if (i >= n) return;  // the whole group
  GroupLanes L;
  shift_gens_walk<K>(L, reinterpret_cast<uint32_t*>(bufs[group]), gens, table, n, i);
}

#endif  // __CUDACC__

// ---------------------------------------------------------------------
// K4: run sums down each column, tails written to their buckets
// ---------------------------------------------------------------------
//
// keys (batch, m_pad) sorted, in either of K3's widths (key_bits, read
// through load_key); m_pad = cols * rows, so column g = k cols + c of the
// flattened grid holds the flat keys g rows .. g rows + rows - 1.
// Outputs:
//   tails (batch, NB, 3, 8)     sum of the run's items in the tail's column
//                               (written for each digit that has a run,
//                               bucket 0 excepted; the rest is left as the
//                               caller filled it)
//   tail_col (batch, NB)        the tail's column when the run's head lies
//                               in an earlier column, else left as filled
//   col_sums (batch, cols, 3, 8), col_flags (batch, cols)
//                               the column's last partial run sum, and
//                               whether the column holds a run head
//
// Replaces vdf_tpu/curves/pallas_msm.py:150 _scan_kernel (which wrote every
// prefix and compacted the tails afterwards).  What bounds it: `rows`
// dependent adds a column, 84-91% of its time (tools/k4_split.py), each on
// a 96-byte record gathered from wherever the key points into a table of
// 34.6 MB (a commit) to 100 MB (the MSM).  Two forms, the same adds in the
// same order:
//   thread form (scan_kernel): one thread a column, records read and sums
//     written in 16-byte pieces.  Where the grid fills the card the adds
//     are bound by instruction issue, and nothing beats one thread an add:
//     a group of 8 threads issues about twice the instructions an add.
//     (Keeping the next record in flight, in registers or by cp.async into
//     shared memory with the keys staged there, measured no faster.)
//   group form (scan_group_kernel): one group of GROUP lanes a column with
//     the group law of curve.cuh, each add ~4 steps deep, not 12 products;
//     each lane holds its piece of the next record in a register while the
//     group adds.
//     For grids that leave the schedulers idle (a few thousand columns: the
//     engine's commits), where the chain of adds, not issue, is the bound.
// The wrapper picks the form from the grid's size (curves/kernels.py
// scan_form).

constexpr int SCAN_MAX_ROWS = 64;  // the group form's limit: it stages rows + 2 keys

template <int K>
__global__ void __launch_bounds__(PBLOCK)
    scan_kernel(const uint32_t* __restrict__ table, const void* __restrict__ keys,
                uint32_t* __restrict__ tails, int32_t* __restrict__ tail_col,
                uint32_t* __restrict__ col_sums, int32_t* __restrict__ col_flags,
                int64_t rows, int64_t cols, int64_t batch, int key_bits) {
  const int64_t g = (int64_t)blockIdx.x * PBLOCK + threadIdx.x;
  if (g >= batch * cols) return;
  const int64_t k = g / cols, c = g % cols, m_pad = rows * cols;
  const int64_t row = k * m_pad;
  const int64_t pos0 = c * rows;
  int64_t prev_d = pos0 > 0 ? load_key(keys, row + pos0 - 1, key_bits) >> 32 : -1;
  int64_t key = load_key(keys, row + pos0, key_bits);
  bool seen_head = false;
  Pt acc, p;
#pragma unroll 1
  for (int64_t r = 0; r < rows; ++r) {
    const int64_t pos = pos0 + r;
    const int64_t next = pos + 1 < m_pad ? load_key(keys, row + pos + 1, key_bits) : -1;
    const int64_t d = key >> 32;
    const bool head = d != prev_d;
    load_pt4(p, pt_at(table, key & 0xFFFFFFFF));
    if (r == 0 || head) {
      copy_pt(acc, p);
    } else {
      add_pt<K>(acc, acc, p);
    }
    seen_head = seen_head || head;
    if (d != 0 && (next < 0 || (next >> 32) != d)) {  // the run's tail
      store_pt4(pt_at(tails, k * NB + d), acc);
      if (!seen_head) tail_col[k * NB + d] = (int32_t)c;
    }
    prev_d = d;
    key = next;
  }
  store_pt4(pt_at(col_sums, g), acc);
  col_flags[g] = seen_head ? 1 : 0;
}

// Group form, GROUP lanes a column.  Shared memory: PBLOCK / GROUP group
// buffers (GROUP_WORDS each), then each group's keys, rows + 2 of them:
// key[-1] .. key[rows] of its column at gkeys[0 ..], -1 before a row's first
// column and after its last.
constexpr int SCAN_GROUPS = PBLOCK / GROUP;  // columns a block
constexpr int64_t scan_group_shared_bytes(int64_t rows) {
  return (int64_t)SCAN_GROUPS * (GROUP_WORDS * 4 + (rows + 2) * 8);
}
static_assert(scan_group_shared_bytes(SCAN_MAX_ROWS) <= 48 * 1024,
              "the group form's shared memory needs no opt-in");

__device__ __forceinline__ void scan_group_setup_lane(int64_t* gkeys, uint32_t* buf,
                                                      const void* keys, int key_bits,
                                                      int64_t rows, int64_t cols, int64_t g,
                                                      int lane) {
  const int64_t c = g % cols;
  for (int64_t i = lane; i < rows + 2; i += GROUP) {
    const bool outside = (i == 0 && c == 0) || (i == rows + 1 && c + 1 == cols);
    gkeys[i] = outside ? -1 : load_key(keys, g * rows + i - 1, key_bits);
  }
  for (int j = lane; j < NL; j += GROUP) buf[GS_ZERO * NL + j] = 0;
}

// Lane l < PIECES: piece l of row r's record, which it holds in flight
// (pre), into slot P (a run's head, or the column's first row) or Q; then
// piece l of row r + 1's record into pre, in flight while the group adds.
template <class Lanes>
__device__ __forceinline__ void scan_group_fetch_lane(Lanes& L, uint32_t* buf,
                                                      const uint32_t* table,
                                                      const int64_t* gkeys, int64_t r,
                                                      int64_t rows, bool to_p, int lane) {
  if (lane >= PIECES) return;
  reinterpret_cast<U4*>(buf + (to_p ? GS_P : GS_Q) * NL)[lane] = L.pre(lane);
  if (r + 1 < rows) L.pre(lane) = pt_at(table, gkeys[r + 2] & 0xFFFFFFFF)[lane];
}

// A group's walk down column g.  `Lanes` runs a step on the group: on the
// card each thread is one lane (GroupLanes); the host test runs the lanes
// one after another.  Within a step no lane reads what another writes.
template <int K, class Lanes>
__device__ __forceinline__ void scan_group_walk(Lanes& L, uint32_t* buf, int64_t* gkeys,
                                                const uint32_t* table, const void* keys,
                                                int key_bits, uint32_t* tails,
                                                int32_t* tail_col, uint32_t* col_sums,
                                                int32_t* col_flags, int64_t rows, int64_t cols,
                                                int64_t g) {
  const int64_t k = g / cols, c = g % cols;
  L.each([&](int lane) {
    scan_group_setup_lane(gkeys, buf, keys, key_bits, rows, cols, g, lane);
  });
  L.sync();
  L.each([&](int lane) {
    if (lane < PIECES) L.pre(lane) = pt_at(table, gkeys[1] & 0xFFFFFFFF)[lane];
  });
  int64_t prev_d = gkeys[0] >> 32;
  bool seen_head = false;
#pragma unroll 1
  for (int64_t r = 0; r < rows; ++r) {
    const int64_t d = gkeys[r + 1] >> 32, next = gkeys[r + 2];
    const bool head = d != prev_d, start = r == 0 || head;
    L.each([&](int lane) {
      scan_group_fetch_lane(L, buf, table, gkeys, r, rows, start, lane);
    });
    L.sync();
    if (!start) L.template add<K>(buf);
    seen_head = seen_head || head;
    if (d != 0 && (next < 0 || (next >> 32) != d)) {  // the run's tail
      L.each([&](int lane) {
        group_store_lane(buf, tails, k * NB + d, tail_col + k * NB + d, (int32_t)c,
                         !seen_head, lane);
      });
      L.sync();  // slot P is read before the next row writes it
    }
    prev_d = d;
  }
  L.each([&](int lane) {
    group_store_lane(buf, col_sums, g, col_flags + g, seen_head ? 1 : 0, true, lane);
  });
}

#ifdef __CUDACC__

extern __shared__ U4 scan_shared[];

template <int K>
__global__ void __launch_bounds__(PBLOCK)
    scan_group_kernel(const uint32_t* __restrict__ table, const void* __restrict__ keys,
                      uint32_t* __restrict__ tails, int32_t* __restrict__ tail_col,
                      uint32_t* __restrict__ col_sums, int32_t* __restrict__ col_flags,
                      int64_t rows, int64_t cols, int64_t batch, int key_bits) {
  const int group = threadIdx.x / GROUP;
  const int64_t g = (int64_t)blockIdx.x * SCAN_GROUPS + group;
  if (g >= batch * cols) return;  // the whole group: no lane of it waits below
  uint32_t* buf = reinterpret_cast<uint32_t*>(scan_shared) + group * GROUP_WORDS;
  int64_t* gkeys = reinterpret_cast<int64_t*>(reinterpret_cast<uint32_t*>(scan_shared) +
                                              SCAN_GROUPS * GROUP_WORDS) +
                   group * (rows + 2);
  GroupLanes L;
  scan_group_walk<K>(L, buf, gkeys, table, keys, key_bits, tails, tail_col, col_sums,
                     col_flags, rows, cols, g);
}

#endif  // __CUDACC__

// ---------------------------------------------------------------------
// K5: carries into the columns
// ---------------------------------------------------------------------
//
// A segmented scan over the column summaries of each batch row, with the
// operator (f1, v1) o (f2, v2) = (f1 | f2, f2 ? v2 : v1 + v2), left operand
// first; column 0 of a row counts as flagged (nothing lies to its left).
// A row is cut into tiles of PBLOCK * L consecutive columns, thread t of a
// tile owning the L columns from t L on.  Three passes:
//   1. colscan_tile_kernel, a block a tile: a thread folds its L columns
//      from the left (colscan_reduce_thread), the block scans the PBLOCK
//      thread totals (colscan_level_thread, at most 7 levels, stopping at
//      the first level in which no thread adds) and writes them,
//      inclusive, to thread_v / thread_f;
//   2. colscan_rows_kernel, a block a batch row: the tile totals (thread
//      PBLOCK - 1 of each tile) are scanned the same way, PBLOCK tiles at a
//      time with the total so far carried over, into tile_incl;
//   3. colscan_carry_kernel, a block a tile: a thread takes the scan up to
//      the column before its first (tile_incl of the tile before + the
//      total of the thread before, colscan_carry_thread), walks its L
//      columns and writes the carry INTO each, exclusive: the identity for
//      column 0.
// The order of adds is fixed, so the plain version repeats it bit for bit.
// The column summaries are read twice and the carries written once (a scan
// with a launch a level would move them once a level).  Passes 1 and 3 bring
// a tile's records through shared memory: the block copies them as
// consecutive 16-byte pieces (a warp reads 512 consecutive bytes an access),
// and a thread reads its own L records from there.  A thread's records are
// followed by one spare piece, so that the eight threads of a 128-bit shared
// access start in eight different groups of four banks (6 L + 1 is odd).
//
// What a thread does in each pass is a __device__ function of its index on
// explicit buffers; barriers and the vote live in the __global__ kernels
// below them, which only nvcc compiles.  The host test calls the same
// functions thread after thread, level after level.

constexpr int SCAN_WORDS = PT * PBLOCK;  // one block-scan buffer: word j of thread t at j * PBLOCK + t

// Piece `q` of a tile's records (piece q % 6 of record q / 6) in the staged
// layout, and the first piece of thread t's l-th record there.
__device__ __forceinline__ int64_t stage_piece(int64_t q, int per_thread) {
  return q + q / (PIECES * per_thread);
}
__device__ __forceinline__ int64_t stage_slot(int t, int l, int per_thread) {
  return (int64_t)t * (PIECES * per_thread + 1) + PIECES * l;
}
// Pieces of shared memory a staged tile takes (for the launcher).
constexpr int64_t stage_pieces(int per_thread) {
  return (int64_t)PBLOCK * (PIECES * per_thread + 1);
}

__device__ __forceinline__ void load_scan(Pt& p, const uint32_t* buf, int t) {
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    p.x[j] = buf[j * PBLOCK + t];
    p.y[j] = buf[(NL + j) * PBLOCK + t];
    p.z[j] = buf[(2 * NL + j) * PBLOCK + t];
  }
}

__device__ __forceinline__ void store_scan(uint32_t* buf, int t, const Pt& p) {
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    buf[j * PBLOCK + t] = p.x[j];
    buf[(NL + j) * PBLOCK + t] = p.y[j];
    buf[(2 * NL + j) * PBLOCK + t] = p.z[j];
  }
}

// Pass 1, thread t of a tile whose first column in the row is col: the fold
// of its columns (col + l for l < per_thread, those below cols) from the
// staged records; returns the fold's flag.  A thread wholly past the row's
// end gives (1, identity), which nothing to its left reads.
template <int K>
__device__ __forceinline__ int colscan_reduce_thread(Pt& acc, const U4* stage,
                                                     const int32_t* row_flags, int64_t col,
                                                     int64_t cols, int t, int per_thread) {
  if (col >= cols) {
    set_identity<K>(acc);
    return 1;
  }
  load_pt4(acc, stage + stage_slot(t, 0, per_thread));
  int f = col == 0 || row_flags[col] != 0;
  Pt v;
#pragma unroll 1
  for (int l = 1; l < per_thread && col + l < cols; ++l) {
    load_pt4(v, stage + stage_slot(t, l, per_thread));
    if (row_flags[col + l] != 0) {
      copy_pt(acc, v);
      f = 1;
    } else {
      add_pt<K>(acc, acc, v);
    }
  }
  return f;
}

// One Hillis-Steele level over a block's PBLOCK (flag, value) pairs, from
// one buffer into another: for t >= d, v'[t] = f[t] ? v[t] : v[t - d] + v[t]
// and f'[t] = f[t] | f[t - d]; below d a copy.  Once a level has no thread
// that adds, every t >= d is flagged and no later level changes anything.
__device__ __forceinline__ bool colscan_level_adds(const int32_t* f_in, int t, int d) {
  return t >= d && f_in[t] == 0;
}

template <int K>
__device__ __forceinline__ void colscan_level_thread(const uint32_t* v_in, const int32_t* f_in,
                                                     uint32_t* v_out, int32_t* f_out, int t,
                                                     int d) {
  Pt v;
  load_scan(v, v_in, t);
  int32_t f = f_in[t];
  if (t >= d) {
    if (!f) {
      Pt s;
      load_scan(s, v_in, t - d);
      add_pt<K>(v, s, v);
    }
    f |= f_in[t - d];
  }
  store_scan(v_out, t, v);
  f_out[t] = f;
}

// Pass 2, thread t of the block of batch row k, PBLOCK tiles from tile0 on:
// load tile tile0 + t's total into the scan buffer (past the row's last tile:
// flagged identity) ...
template <int K>
__device__ __forceinline__ void colscan_rows_load_thread(uint32_t* v, int32_t* f,
                                                         const uint32_t* thread_v,
                                                         const int32_t* thread_f, int64_t k,
                                                         int64_t tiles, int64_t tile0, int t) {
  Pt p;
  int32_t flag = 1;
  if (tile0 + t < tiles) {
    const int64_t last = (k * tiles + tile0 + t) * PBLOCK + PBLOCK - 1;
    load_pt4(p, pt_at(thread_v, last));
    flag = thread_f[last];
  } else {
    set_identity<K>(p);
  }
  store_scan(v, t, p);
  f[t] = flag;
}

// ... and, the PBLOCK totals scanned, add the row's scan up to tile0 - 1
// where the tile's own scan holds no head, and write tile_incl.
template <int K>
__device__ __forceinline__ void colscan_rows_store_thread(const uint32_t* v, const int32_t* f,
                                                          uint32_t* tile_incl, int64_t k,
                                                          int64_t tiles, int64_t tile0, int t) {
  if (tile0 + t >= tiles) return;
  Pt p;
  load_scan(p, v, t);
  if (tile0 > 0 && !f[t]) {
    Pt before;
    load_pt4(before, pt_at(tile_incl, k * tiles + tile0 - 1));
    add_pt<K>(p, before, p);
  }
  store_pt4(pt_at(tile_incl, k * tiles + tile0 + t), p);
}

// Pass 3, thread t of tile `tile` of batch row k: the carry into each of its
// columns, written over the staged column sums.  The first tile of a row
// has every thread total flagged (column 0 counts as a head), so tile_incl
// is read only from the second tile on.
template <int K>
__device__ __forceinline__ void colscan_carry_thread(U4* stage, const int32_t* row_flags,
                                                     const uint32_t* thread_v,
                                                     const int32_t* thread_f,
                                                     const uint32_t* tile_incl, int64_t k,
                                                     int64_t tile, int64_t tiles, int64_t cols,
                                                     int t, int per_thread) {
  const int64_t col = (tile * PBLOCK + t) * per_thread;
  if (col >= cols) return;
  Pt e, v;
  if (t > 0) {
    const int64_t before = (k * tiles + tile) * PBLOCK + t - 1;
    load_pt4(e, pt_at(thread_v, before));
    if (!thread_f[before]) {
      load_pt4(v, pt_at(tile_incl, k * tiles + tile - 1));
      add_pt<K>(e, v, e);
    }
  } else if (tile > 0) {
    load_pt4(e, pt_at(tile_incl, k * tiles + tile - 1));
  } else {
    set_identity<K>(e);
  }
#pragma unroll 1
  for (int l = 0; l < per_thread && col + l < cols; ++l) {
    U4* slot = stage + stage_slot(t, l, per_thread);
    load_pt4(v, slot);
    store_pt4(slot, e);
    if (l + 1 == per_thread || col + l + 1 >= cols) break;
    if (col + l == 0 || row_flags[col + l] != 0) {
      copy_pt(e, v);
    } else {
      add_pt<K>(e, e, v);
    }
  }
}

#ifdef __CUDACC__

// The block's copy of a tile's `records` records between device memory and
// the staged layout, consecutive threads on consecutive 16-byte pieces.
__device__ __forceinline__ void colscan_stage_in(U4* stage, const U4* src, int64_t records,
                                                 int per_thread) {
  for (int64_t q = threadIdx.x; q < records * PIECES; q += PBLOCK)
    stage[stage_piece(q, per_thread)] = src[q];
  __syncthreads();
}

__device__ __forceinline__ void colscan_stage_out(U4* dst, const U4* stage, int64_t records,
                                                  int per_thread) {
  __syncthreads();
  for (int64_t q = threadIdx.x; q < records * PIECES; q += PBLOCK)
    dst[q] = stage[stage_piece(q, per_thread)];
}

// The Hillis-Steele levels over buffer 0 of v (2 * SCAN_WORDS) and f
// (2 * PBLOCK), ping-ponging; returns the buffer that holds the scan.  The
// caller has synchronised after filling buffer 0.
template <int K>
__device__ __forceinline__ int colscan_block_scan(uint32_t* v, int32_t* f) {
  const int t = threadIdx.x;
  int cur = 0;
  for (int d = 1; d < PBLOCK; d *= 2) {
    if (!__syncthreads_or(colscan_level_adds(f + cur * PBLOCK, t, d))) break;
    colscan_level_thread<K>(v + cur * SCAN_WORDS, f + cur * PBLOCK, v + (cur ^ 1) * SCAN_WORDS,
                            f + (cur ^ 1) * PBLOCK, t, d);
    __syncthreads();
    cur ^= 1;
  }
  return cur;
}

// Dynamic shared memory of passes 1 and 3: the staged tile; in pass 1 the
// two scan buffers and their flags take its place once the fold is done.
extern __shared__ U4 colscan_shared[];
constexpr int64_t COLSCAN_SCAN_BYTES = 2 * (SCAN_WORDS + PBLOCK) * 4;

template <int K>
__global__ void __launch_bounds__(PBLOCK)
    colscan_tile_kernel(const uint32_t* __restrict__ sums, const int32_t* __restrict__ flags,
                        uint32_t* __restrict__ thread_v, int32_t* __restrict__ thread_f,
                        int64_t cols, int64_t tiles, int per_thread) {
  const int t = threadIdx.x;
  const int64_t k = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int64_t col0 = tile * PBLOCK * per_thread;
  const int64_t records = cols - col0 < PBLOCK * per_thread ? cols - col0 : PBLOCK * per_thread;
  colscan_stage_in(colscan_shared, pt_at(sums, k * cols + col0), records, per_thread);
  Pt acc;
  const int flag = colscan_reduce_thread<K>(acc, colscan_shared, flags + k * cols,
                                            col0 + (int64_t)t * per_thread, cols, t, per_thread);
  __syncthreads();  // the staged records are dead: the scan buffers take their place
  uint32_t* v = reinterpret_cast<uint32_t*>(colscan_shared);
  int32_t* f = reinterpret_cast<int32_t*>(v + 2 * SCAN_WORDS);
  store_scan(v, t, acc);
  f[t] = flag;
  __syncthreads();
  const int cur = colscan_block_scan<K>(v, f);
  load_scan(acc, v + cur * SCAN_WORDS, t);
  const int64_t g = (int64_t)blockIdx.x * PBLOCK + t;
  store_pt4(pt_at(thread_v, g), acc);
  thread_f[g] = f[cur * PBLOCK + t];
}

template <int K>
__global__ void __launch_bounds__(PBLOCK)
    colscan_rows_kernel(const uint32_t* __restrict__ thread_v,
                        const int32_t* __restrict__ thread_f, uint32_t* tile_incl,
                        int64_t tiles) {
  __shared__ uint32_t v[2 * SCAN_WORDS];
  __shared__ int32_t f[2 * PBLOCK];
  const int t = threadIdx.x;
  const int64_t k = blockIdx.x;
  for (int64_t tile0 = 0; tile0 < tiles; tile0 += PBLOCK) {
    colscan_rows_load_thread<K>(v, f, thread_v, thread_f, k, tiles, tile0, t);
    __syncthreads();
    const int cur = colscan_block_scan<K>(v, f);
    colscan_rows_store_thread<K>(v + cur * SCAN_WORDS, f + cur * PBLOCK, tile_incl, k, tiles,
                                 tile0, t);
    __syncthreads();  // tile_incl[tile0 + PBLOCK - 1] is read by the next round
  }
}

template <int K>
__global__ void __launch_bounds__(PBLOCK)
    colscan_carry_kernel(const uint32_t* __restrict__ sums, const int32_t* __restrict__ flags,
                         const uint32_t* __restrict__ thread_v,
                         const int32_t* __restrict__ thread_f,
                         const uint32_t* __restrict__ tile_incl, uint32_t* __restrict__ carries,
                         int64_t cols, int64_t tiles, int per_thread) {
  const int64_t k = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int64_t col0 = tile * PBLOCK * per_thread;
  const int64_t records = cols - col0 < PBLOCK * per_thread ? cols - col0 : PBLOCK * per_thread;
  colscan_stage_in(colscan_shared, pt_at(sums, k * cols + col0), records, per_thread);
  colscan_carry_thread<K>(colscan_shared, flags + k * cols, thread_v, thread_f, tile_incl, k,
                          tile, tiles, cols, threadIdx.x, per_thread);
  colscan_stage_out(pt_at(carries, k * cols + col0), colscan_shared, records, per_thread);
}

#endif  // __CUDACC__

// ---------------------------------------------------------------------
// K6: sum_b b B_b a batch row
// ---------------------------------------------------------------------
//
// B_b = tail + carry into the tail's column (when the run's head lies in
// an earlier column); bucket 0 is the identity.  With V0_b = B_b, step
// s = 1 .. 11 halves: Vs_i = V(s-1)_(2i) + V(s-1)_(2i+1), so Vs_i sums the
// buckets b with b >> s == i, and O_j, the sum of the odd entries of
// V(j-1), sums the buckets whose bit j - 1 is set:
//   sum_b b B_b = O_1 + 2 (O_2 + 2 (O_3 + ... + 2 O_12)).
// O_j is a balanced tree over its NB >> j leaves (neighbours pair, left
// operand first), level r of it computed in step j - 1 + r, so every tree
// ends with step 11, where O_12 = V11_1.  Step s has (NB >> s) +
// s (NB >> (s + 1)) independent adds (bucket_step_thread): 4,094 + 4,083 in
// all, then 11 doublings and 11 adds on one thread (bucket_horner_thread):
// 1 + 11 + 22 = 34 dependent operations.
//
// The first steps of an aligned chunk of 2^m buckets read nothing outside
// it, so bucket_tree_kernel runs step 0 (the carries) and steps 1 .. m - 1
// with a block a chunk, and bucket_finish_kernel the steps from m on and the
// Horner with a block a batch row: the launch boundary is the one barrier
// across blocks.  The steps' results lie in scratch the caller gives,
// BUCKET_SCRATCH points a batch row, which stays in the L2 cache: every Vs
// and every tree level has points of its own (2 NB for V0 .. V11, NB for the
// trees), because the blocks of two chunks are not in step with each other
// and a chunk's Vs would otherwise land on entries of V(s-2) that its
// neighbour still reads.  No step reads what the same step writes, so the
// host test runs a step thread after thread.  Where the schedule is cut (m,
// and the threads a block) changes no add and no output bit.

constexpr int TREE_STEPS = WINDOW_BITS - 1;        // halving steps 1 .. 11
constexpr int BUCKET_SCRATCH = 3 * NB;            // points a batch row
constexpr int BUCKET_MAX_THREADS = 512;
constexpr int FINISH_THREADS = 256;

template <int K>
__device__ __forceinline__ void load_bucket(Pt& B, const uint32_t* tails,
                                            const int32_t* tail_col,
                                            const uint32_t* carries, int64_t k, int64_t b,
                                            int64_t cols) {
  if (b == 0) {
    set_identity<K>(B);
    return;
  }
  load_pt4(B, pt_at(tails, k * NB + b));
  const int32_t c = tail_col[k * NB + b];
  if (c >= 0) {
    Pt carry;
    load_pt4(carry, pt_at(carries, k * cols + c));
    add_pt<K>(B, B, carry);
  }
}

// A batch row's scratch: Vs (NB >> s points) after V0 .. V(s-1), then the trees.
__device__ __forceinline__ uint32_t* bucket_v(uint32_t* scratch, int64_t k, int s) {
  return scratch + (k * BUCKET_SCRATCH + (2 * NB - ((2 * NB) >> s))) * PT;
}
// Level r (1 .. 12 - j) of O_j's tree: tree j lies after the trees before it
// (NB >> j' points each), its levels one after another (NB >> (j + r')).
__device__ __forceinline__ uint32_t* bucket_tree(uint32_t* scratch, int64_t k, int j, int r) {
  const int64_t at = (NB - (NB >> (j - 1))) + ((NB >> j) - (NB >> (j + r - 1)));
  return scratch + (k * BUCKET_SCRATCH + 2 * NB + at) * PT;
}

// Step 0 for bucket b of batch row k.
template <int K>
__device__ __forceinline__ void bucket_load_thread(const uint32_t* tails,
                                                   const int32_t* tail_col,
                                                   const uint32_t* carries, uint32_t* scratch,
                                                   int64_t k, int64_t b, int64_t cols) {
  Pt B;
  load_bucket<K>(B, tails, tail_col, carries, k, b, cols);
  store_pt4(pt_at(bucket_v(scratch, k, 0), b), B);
}

// Adds of step s inside a chunk of 2^m buckets (s < m, or m = 12: the row).
__device__ __forceinline__ int64_t bucket_step_items(int s, int m) {
  const int64_t nv = ((int64_t)1 << m) >> s;
  return nv + s * (nv >> 1);
}

// Add w of step s in chunk c (of 2^m buckets) of batch row k: first the
// chunk's entries of Vs, then its entries of level s - j + 1 of each tree
// j = 1 .. s (the leaves of tree s are the odd entries of V(s-1)).
template <int K>
__device__ __forceinline__ void bucket_step_thread(uint32_t* scratch, int64_t k, int s, int m,
                                                   int64_t c, int64_t w) {
  const int64_t nv = ((int64_t)1 << m) >> s, nt = nv >> 1;
  const uint32_t* v_in = bucket_v(scratch, k, s - 1);
  Pt p, q;
  if (w < nv) {
    const int64_t i = c * nv + w;
    load_pt4(p, pt_at(v_in, 2 * i));
    load_pt4(q, pt_at(v_in, 2 * i + 1));
    add_pt<K>(p, p, q);
    store_pt4(pt_at(bucket_v(scratch, k, s), i), p);
    return;
  }
  w -= nv;
  const int j = 1 + (int)(w / nt), r = s - j + 1;
  const int64_t i = c * nt + w % nt;
  if (r == 1) {
    load_pt4(p, pt_at(v_in, 4 * i + 1));
    load_pt4(q, pt_at(v_in, 4 * i + 3));
  } else {
    const uint32_t* level = bucket_tree(scratch, k, j, r - 1);
    load_pt4(p, pt_at(level, 2 * i));
    load_pt4(q, pt_at(level, 2 * i + 1));
  }
  add_pt<K>(p, p, q);
  store_pt4(pt_at(bucket_tree(scratch, k, j, r), i), p);
}

// After step 11: out[k] = O_1 + 2 (O_2 + ... + 2 O_12), from the top down.
template <int K>
__device__ __forceinline__ void bucket_horner_thread(uint32_t* scratch, uint32_t* out,
                                                     int64_t k) {
  Pt acc, o;
  load_pt4(acc, pt_at(bucket_v(scratch, k, TREE_STEPS), 1));  // O_12 = V11_1
#pragma unroll 1
  for (int j = TREE_STEPS; j >= 1; --j) {
    dbl_pt<K>(acc, acc);
    load_pt4(o, pt_at(bucket_tree(scratch, k, j, WINDOW_BITS - j), 0));
    add_pt<K>(acc, acc, o);
  }
  store_pt4(pt_at(out, k), acc);
}

#ifdef __CUDACC__

template <int K>
__global__ void __launch_bounds__(BUCKET_MAX_THREADS)
    bucket_tree_kernel(const uint32_t* __restrict__ tails, const int32_t* __restrict__ tail_col,
                       const uint32_t* __restrict__ carries, uint32_t* scratch, int64_t cols,
                       int m) {
  const int64_t chunks = NB >> m, chunk = (int64_t)1 << m;
  const int64_t k = blockIdx.x / chunks, c = blockIdx.x % chunks;
  for (int64_t b = threadIdx.x; b < chunk; b += blockDim.x)
    bucket_load_thread<K>(tails, tail_col, carries, scratch, k, c * chunk + b, cols);
  for (int s = 1; s < m; ++s) {
    __syncthreads();
    for (int64_t w = threadIdx.x; w < bucket_step_items(s, m); w += blockDim.x)
      bucket_step_thread<K>(scratch, k, s, m, c, w);
  }
}

template <int K>
__global__ void __launch_bounds__(FINISH_THREADS)
    bucket_finish_kernel(uint32_t* scratch, uint32_t* __restrict__ out, int m) {
  const int64_t k = blockIdx.x;
  for (int s = m; s <= TREE_STEPS; ++s) {
    for (int64_t w = threadIdx.x; w < bucket_step_items(s, WINDOW_BITS); w += blockDim.x)
      bucket_step_thread<K>(scratch, k, s, WINDOW_BITS, 0, w);
    __syncthreads();
  }
  if (threadIdx.x == 0) bucket_horner_thread<K>(scratch, out, k);
}

#endif  // __CUDACC__

// ---------------------------------------------------------------------
// K9: sum_w 2^(12 w) S_w a batch row
// ---------------------------------------------------------------------
//
// sums (batch, W, 3, 8), least significant window first -> out (batch, 3, 8).
// Replaces vdf_tpu/curves/pallas_msm.py:234 _horner_kernel (the same chain
// on one live element of an (8, 128) vreg).  From the identity, for w =
// W - 1 down to 0: acc = 2^12 acc + S_w; the complete formulas take the
// identity and equal operands, so no case is special.  What bounds it: the
// chain, 264 doublings and 22 adds one after another (2^252 S_21 needs 252
// doublings whatever the schedule), and the MSM has one batch row; its
// 2.1 KB of input are nothing.  So the design cuts the latency of one
// operation: a group of GROUP lanes a batch row runs each add and doubling
// with the group law of curve.cuh (4 steps, two of them one product deep),
// where one thread runs 12 products an add and 8 a doubling.  The group first
// copies the row's 22 window sums into shared memory in 16-byte pieces and
// reduces each coordinate (canon), as the plain version does on load.

constexpr int HORNER_GROUPS = 4;                   // batch rows a block
constexpr int HORNER_PIECES = WINDOWS * PIECES;    // 16-byte pieces of a row's sums

// The group of batch row `row`: its window sums into `stage` ...
__device__ __forceinline__ void horner_stage_lane(U4* stage, const uint32_t* sums, int64_t row,
                                                  int lane) {
  const U4* src = pt_at(sums, row * WINDOWS);
  for (int q = lane; q < HORNER_PIECES; q += GROUP) stage[q] = src[q];
}

// ... each coordinate reduced below p, the zero slot and slot P = identity.
template <int K>
__device__ __forceinline__ void horner_setup_lane(U4* stage, uint32_t* buf, int lane) {
  uint32_t* words = reinterpret_cast<uint32_t*>(stage);
  for (int e = lane; e < 3 * WINDOWS; e += GROUP) canon<K>(words + e * NL);
  for (int j = lane; j < NL; j += GROUP) {
    buf[GS_ZERO * NL + j] = 0;
    buf[GS_P * NL + j] = 0;
    buf[(GS_P + 1) * NL + j] = mont_one<K>(j);
    buf[(GS_P + 2) * NL + j] = 0;
  }
}

// Lane l < PIECES: piece l of window sum w into slot Q.
__device__ __forceinline__ void horner_load_lane(uint32_t* buf, const U4* stage, int w,
                                                 int lane) {
  if (lane < PIECES) reinterpret_cast<U4*>(buf + GS_Q * NL)[lane] = stage[w * PIECES + lane];
}

template <int K, class Lanes>
__device__ __forceinline__ void horner_walk(Lanes& L, uint32_t* buf, U4* stage,
                                            const uint32_t* sums, uint32_t* out, int64_t row) {
  L.each([&](int lane) { horner_stage_lane(stage, sums, row, lane); });
  L.sync();
  L.each([&](int lane) { horner_setup_lane<K>(stage, buf, lane); });
  L.sync();
#pragma unroll 1
  for (int w = WINDOWS - 1; w >= 0; --w) {
#pragma unroll 1
    for (int b = 0; b < WINDOW_BITS; ++b) L.template dbl<K>(buf);
    L.each([&](int lane) { horner_load_lane(buf, stage, w, lane); });
    L.sync();
    L.template add<K>(buf);
  }
  L.each([&](int lane) { group_store_lane(buf, out, row, nullptr, 0, false, lane); });
}

#ifdef __CUDACC__

// A block of HORNER_GROUPS groups.
template <int K>
__global__ void __launch_bounds__(HORNER_GROUPS * GROUP)
    horner_kernel(const uint32_t* __restrict__ sums, uint32_t* __restrict__ out,
                  int64_t batch) {
  __shared__ U4 bufs[HORNER_GROUPS][GROUP_WORDS / 4];
  __shared__ U4 stages[HORNER_GROUPS][HORNER_PIECES];
  const int group = threadIdx.x / GROUP;
  const int64_t row = (int64_t)blockIdx.x * HORNER_GROUPS + group;
  if (row >= batch) return;  // the whole group
  GroupLanes L;
  horner_walk<K>(L, reinterpret_cast<uint32_t*>(bufs[group]), stages[group], sums, out, row);
}

#endif  // __CUDACC__

}  // namespace vdf
