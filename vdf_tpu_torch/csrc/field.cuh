// Pasta field arithmetic for one CUDA thread: 8 little-endian u32 limbs,
// Montgomery form with R = 2^256 (K0 of the port).
//
// Replaces vdf_tpu/fields/pallas_field.py::KernelField, the in-kernel
// field library of the TPU kernels (radix-2^12 int32 limb lists whose
// products fit the VPU's 32-bit lanes).  Hopper has a 32x32->64-bit
// integer multiply-add (IMAD.WIDE), so the port works on 32-bit limbs
// with 64-bit partial products.
//
// The multiplier knows the primes.  Both Pasta moduli are
//   p = 1 + c1 2^32 + c2 2^64 + c3 2^96 + 2^254,
// limbs [1, c1, c2, c3, 0, 0, 0, 2^30] (vdf_tpu_torch/_build.py refuses to
// build for a modulus of another shape), and every constant is a
// compile-time value of the field index K (0 = Fp, 1 = Fq) from the
// generated vdf_consts.h.  So -1/p mod 2^32 is 2^32 - 1 and one row of the
// Montgomery reduction is m = -t[0], three wide products m c1, m c2, m c3
// and a 30-bit shift of m: 24 wide products a reduction, not 72.
//
// The wide product.  A product is the full 16-limb a b (mul_wide: 64 wide
// products; sqr_wide: 36, the off-diagonal terms once, doubled, then the
// diagonal) followed by one shared mont_reduce.  The partial products
// a[j] b[i] of an even column i + j are summed in one accumulator, those of
// an odd column in a second one that sits one limb higher: the four
// products of a row that go to one accumulator lie side by side as 64-bit
// words, so each is a single IMAD.WIDE that adds into its word and hands
// its carry to the next through the carry flag; nothing else is added
// until the two accumulators meet in one pass at the end (merge_wide).  A
// row's two chains, and the chains of the rows after it, are independent
// but for that flag, so several multiplies are in flight.  In the
// reduction only m_i -> m_i c1 -> t[i + 1] -> m_(i + 1) is sequential; what
// a row carries out above limb i + 4 waits in one word for the next row,
// and the 2^254 term is added once, after the last row, as
// (m_7 .. m_0) << 30.
//
// Bounds.  p = 2^254 + c with a 126-bit c, so 2p < 3p < R but 4p > R: a
// lazy sum must stay below 3p to fit in 256 bits.  Every value this file
// returns is canonical (< p) unless its comment says otherwise:
//   mont_mul(a, b)  a, b < p (one of them may be a lazy value, below
//                   2p (1 + 2^-100)): a b < 2.1 p^2, so (a b + m p) / R < 2p,
//                   then one conditional subtraction;
//   mont_sqr(a)     a < p (canonical: for a in [p, 2p) the value before
//                   the subtraction could pass 2p);
//   mont_mul_lazy, mont_sqr_lazy
//                   operands and result below 2p (1 + 2^-100), no
//                   subtraction: for chains that end in canon();
//   add_raw(a, b)   a + b, no reduction: the caller keeps it < 2^256;
//   cond_sub_p(v)   v < 2p -> v < p (a lazy value + a canonical one, < 3p,
//                   -> below the lazy bound);
//   canon(v)        any 256-bit v (< 4p) -> v < p;
//   sub_mod(a, b)   a, b < p -> a - b mod p (a lazy a and a canonical b:
//                   a lazy value of the same residue).
//
// Carries.  Written as 64-bit C sums, every step of a carry pass compiled
// to three SASS operations (IADD3, IADD3.X and a shift) and every wide
// multiply-add with a 32-bit addend to a move that clears the addend's
// upper register, ~500 operations a product for 88 multiplies.  So every
// carry pass here is a chain of the PTX add.cc / addc.cc / sub.cc / subc.cc
// operations (add_cc .. subc below), one a limb, and the
// multiply-adds are mad.lo.cc / madc.hi.cc pairs (mad_wide_cc), which ptxas
// joins into one IMAD.WIDE where the two target registers can be a pair.  Compiled by a host compiler, the same functions keep the
// carry flag in a variable, so the CPU tests compile this very file with
// g++ and hold it against Python integers; the card checks the PTX forms.
#pragma once

#include <cstdint>

#include "vdf_consts.h"  // generated at build by vdf_tpu_torch/_build.py

namespace vdf {

constexpr int NL = 8;  // u32 limbs per field element

// Limb j of a constant of field K, for device code and for constant
// expressions alike.  After unrolling, j is a literal and the call folds
// to an immediate.
#ifdef __CUDACC__
#define VDF_HOST_DEVICE __host__ __device__
#else
#define VDF_HOST_DEVICE
#endif
#define VDF_LIMB_TABLE(fn, init)                                             \
  template <int K>                                                           \
  VDF_HOST_DEVICE constexpr uint32_t fn(int j) {                             \
    constexpr uint32_t v[2][NL] = init;                                      \
    return v[K][j];                                                          \
  }
VDF_LIMB_TABLE(modulus, VDF_P_INIT)          // p
VDF_LIMB_TABLE(two_modulus, VDF_TWO_P_INIT)  // 2p
VDF_LIMB_TABLE(mont_one, VDF_ONE_INIT)       // R mod p, the Montgomery one

__device__ __forceinline__ void copy(uint32_t r[NL], const uint32_t a[NL]) {
#pragma unroll
  for (int j = 0; j < NL; ++j) r[j] = a[j];
}

// ---------------------------------------------------------------------
// The carry flag.  add_cc starts a chain (writes the flag), addc_cc goes on
// (reads and writes it), addc ends it (reads it); sub_cc, subc_cc and subc
// likewise with a borrow.  A chain's statements follow each other with
// nothing of another chain between them.
// ---------------------------------------------------------------------
#ifdef __CUDACC__
#define VDF_CARRY_OP(fn, ptx)                                                  \
  __device__ __forceinline__ uint32_t fn(uint32_t a, uint32_t b) {             \
    uint32_t r;                                                                \
    asm volatile(ptx " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));               \
    return r;                                                                  \
  }
VDF_CARRY_OP(add_cc, "add.cc.u32")
VDF_CARRY_OP(addc_cc, "addc.cc.u32")
VDF_CARRY_OP(addc, "addc.u32")
VDF_CARRY_OP(sub_cc, "sub.cc.u32")
VDF_CARRY_OP(subc_cc, "subc.cc.u32")
VDF_CARRY_OP(subc, "subc.u32")
#undef VDF_CARRY_OP
// (hi : lo) += a b, starting a chain (mad_wide_cc) or going on with one
// (madc_wide_cc); the carry out of hi stays in the flag.  ptxas turns each
// lo / hi pair into one IMAD.WIDE.U32 with a carry predicate.
__device__ __forceinline__ void mad_wide_cc(uint32_t& lo, uint32_t& hi, uint32_t a,
                                            uint32_t b) {
  asm volatile("mad.lo.cc.u32 %0, %2, %3, %0; madc.hi.cc.u32 %1, %2, %3, %1;"
               : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
}
__device__ __forceinline__ void madc_wide_cc(uint32_t& lo, uint32_t& hi, uint32_t a,
                                             uint32_t b) {
  asm volatile("madc.lo.cc.u32 %0, %2, %3, %0; madc.hi.cc.u32 %1, %2, %3, %1;"
               : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
}
#else
static uint32_t host_carry;  // the flag, for the one thread that runs host code
inline uint32_t add_cc(uint32_t a, uint32_t b) {
  const uint64_t s = (uint64_t)a + b;
  host_carry = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
inline uint32_t addc_cc(uint32_t a, uint32_t b) {
  const uint64_t s = (uint64_t)a + b + host_carry;
  host_carry = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + host_carry; }
inline uint32_t sub_cc(uint32_t a, uint32_t b) {
  const uint64_t s = (uint64_t)a - b;
  host_carry = (uint32_t)(s >> 63);
  return (uint32_t)s;
}
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
  const uint64_t s = (uint64_t)a - b - host_carry;
  host_carry = (uint32_t)(s >> 63);
  return (uint32_t)s;
}
inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - host_carry; }
inline void madc_wide_cc(uint32_t& lo, uint32_t& hi, uint32_t a, uint32_t b) {
  const unsigned __int128 s = (unsigned __int128)((uint64_t)a * b) + lo +
                              ((uint64_t)hi << 32) + host_carry;
  lo = (uint32_t)s;
  hi = (uint32_t)(s >> 32);
  host_carry = (uint32_t)(s >> 64);
}
inline void mad_wide_cc(uint32_t& lo, uint32_t& hi, uint32_t a, uint32_t b) {
  host_carry = 0;
  madc_wide_cc(lo, hi, a, b);
}
#endif

__device__ __forceinline__ uint32_t lo32(uint64_t v) { return (uint32_t)v; }
__device__ __forceinline__ uint32_t hi32(uint64_t v) { return (uint32_t)(v >> 32); }

template <int K>
__device__ __forceinline__ void set_one(uint32_t r[NL]) {
#pragma unroll
  for (int j = 0; j < NL; ++j) r[j] = mont_one<K>(j);
}

// v -= m if v >= m (in place), for any 256-bit v and m.
__device__ __forceinline__ void cond_sub(uint32_t v[NL], const uint32_t m[NL]) {
  uint32_t d[NL];
  d[0] = sub_cc(v[0], m[0]);
#pragma unroll
  for (int j = 1; j < NL; ++j) d[j] = subc_cc(v[j], m[j]);
  const bool keep = subc(0u, 0u) != 0;  // a borrow: v < m
#pragma unroll
  for (int j = 0; j < NL; ++j) v[j] = keep ? v[j] : d[j];
}

template <int K>
__device__ __forceinline__ void cond_sub_p(uint32_t v[NL]) {
  uint32_t p[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) p[j] = modulus<K>(j);
  cond_sub(v, p);
}

template <int K>
__device__ __forceinline__ void canon(uint32_t v[NL]) {
  uint32_t two_p[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) two_p[j] = two_modulus<K>(j);
  cond_sub(v, two_p);  // < 4p -> < 2p
  cond_sub_p<K>(v);    // < 2p -> < p
}

// r = a + b, no reduction (a + b < 2^256 is the caller's bound).  r may
// alias a or b.
__device__ __forceinline__ void add_raw(uint32_t r[NL], const uint32_t a[NL],
                                        const uint32_t b[NL]) {
  r[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NL - 1; ++j) r[j] = addc_cc(a[j], b[j]);
  r[NL - 1] = addc(a[NL - 1], b[NL - 1]);
}

// r = a + b mod p for a, b < p.
template <int K>
__device__ __forceinline__ void add_mod(uint32_t r[NL], const uint32_t a[NL],
                                        const uint32_t b[NL]) {
  add_raw(r, a, b);  // < 2p < 2^256
  cond_sub_p<K>(r);
}

// r = a - b mod p for canonical a, b < p; r < p.  r may alias a or b.
template <int K>
__device__ __forceinline__ void sub_mod(uint32_t r[NL], const uint32_t a[NL],
                                        const uint32_t b[NL]) {
  r[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NL; ++j) r[j] = subc_cc(a[j], b[j]);
  // a < b: the limbs hold a - b + 2^256; adding p wraps back to a - b + p.
  const uint32_t mask = subc(0u, 0u);  // all ones on a borrow
  r[0] = add_cc(r[0], modulus<K>(0) & mask);
#pragma unroll
  for (int j = 1; j < NL - 1; ++j) r[j] = addc_cc(r[j], modulus<K>(j) & mask);
  r[NL - 1] = addc(r[NL - 1], modulus<K>(NL - 1) & mask);
}

// r = -a mod p where neg, else a, for canonical a; one code path either way.
template <int K>
__device__ __forceinline__ void cond_neg_mod(uint32_t r[NL], const uint32_t a[NL], bool neg) {
  const uint32_t zero[NL] = {0, 0, 0, 0, 0, 0, 0, 0};
  uint32_t n[NL];
  sub_mod<K>(n, zero, a);
#pragma unroll
  for (int j = 0; j < NL; ++j) r[j] = neg ? n[j] : a[j];
}

// r = k a mod p for a small k < 64 (the curve's 3b = 15, and 2, 3, 8, 45 in
// the group law) and any 256-bit a (a lazy value too): the same residue as a
// Montgomery product by k R mod p, so for canonical a the same limbs, for 16
// multiplies where that takes 88; r is canonical.  v = k a < 2^262 has nine
// limbs; q = v >> 254 is floor(v / p) or one more (p = 2^254 + c with
// c < 2^126, so v / 2^254 - v / p < 2^-120), so v - max(q - 1, 0) p lies in
// [0, 2p) and fits in 256 bits: the low limbs of v and of that multiple of p
// give it, and one conditional subtraction ends it.  r may alias a.
template <int K>
__device__ __forceinline__ void mul_small(uint32_t r[NL], const uint32_t a[NL], uint32_t k) {
  uint32_t v[NL], mp[NL], carry = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const uint64_t t = (uint64_t)a[j] * k + carry;
    v[j] = lo32(t);
    carry = hi32(t);
  }
  const uint32_t q = (carry << 2) | (v[NL - 1] >> 30);
  const uint32_t m = q ? q - 1 : 0;
  carry = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const uint64_t t = (uint64_t)modulus<K>(j) * m + carry;
    mp[j] = lo32(t);
    carry = hi32(t);
  }
  r[0] = sub_cc(v[0], mp[0]);
#pragma unroll
  for (int j = 1; j < NL - 1; ++j) r[j] = subc_cc(v[j], mp[j]);
  r[NL - 1] = subc(v[NL - 1], mp[NL - 1]);
  cond_sub_p<K>(r);
}

// acc[2k], acc[2k + 1] += a[2k] b for k < n, one carry chain through the n
// wide multiply-adds (their 64-bit targets lie side by side, so nothing
// else is added); the carry out goes to acc[2n] where `top` says that limb
// exists (where it does not, the caller's bound makes the carry 0).
__device__ __forceinline__ void mad_row(uint32_t* acc, const uint32_t* a, uint32_t b, int n,
                                        bool top) {
  if (n == 0) return;
  mad_wide_cc(acc[0], acc[1], a[0], b);
#pragma unroll
  for (int k = 1; k < n; ++k) madc_wide_cc(acc[2 * k], acc[2 * k + 1], a[2 * k], b);
  if (top) acc[2 * n] = addc(acc[2 * n], 0u);
}

// acc[2k], acc[2k + 1] = a[2k] b for k < n (the first row of an accumulator).
__device__ __forceinline__ void mul_row(uint32_t* acc, const uint32_t* a, uint32_t b, int n) {
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const uint64_t pr = (uint64_t)a[2 * k] * b;
    acc[2 * k] = lo32(pr);
    acc[2 * k + 1] = hi32(pr);
  }
}

// t = even + (odd << 32), 16 limbs (odd[15] is never reached).
__device__ __forceinline__ void merge_wide(uint32_t t[2 * NL], const uint32_t even[2 * NL],
                                           const uint32_t odd[2 * NL]) {
  t[0] = even[0];
  t[1] = add_cc(even[1], odd[0]);
#pragma unroll
  for (int k = 2; k < 2 * NL - 1; ++k) t[k] = addc_cc(even[k], odd[k - 1]);
  t[2 * NL - 1] = addc(even[2 * NL - 1], odd[2 * NL - 2]);
}

// The wide products keep two accumulators: `even` holds the partial
// products a[j] b[i] whose column i + j is even, as 64-bit words at limbs
// (i + j, i + j + 1); `odd` holds those of an odd column one limb lower
// (odd[k] is limb k + 1).  The four products of a row that go to one
// accumulator do not overlap, so they are one chain of IMAD.WIDE with a
// carry, no separate additions; the two meet in merge_wide.

// t = a b, 16 limbs: 64 wide products.
__device__ __forceinline__ void mul_wide(uint32_t t[2 * NL], const uint32_t a[NL],
                                         const uint32_t b[NL]) {
  uint32_t even[2 * NL], odd[2 * NL];
#pragma unroll
  for (int j = NL; j < 2 * NL; ++j) even[j] = odd[j] = 0;
  mul_row(even, a, b[0], NL / 2);
  mul_row(odd, a + 1, b[0], NL / 2);
#pragma unroll
  for (int i = 1; i < NL; ++i) {
    if (i % 2 == 0) {
      mad_row(even + i, a, b[i], NL / 2, i + NL < 2 * NL);
      mad_row(odd + i, a + 1, b[i], NL / 2, true);
    } else {
      mad_row(odd + i - 1, a, b[i], NL / 2, true);
      mad_row(even + i + 1, a + 1, b[i], NL / 2, i + 1 + NL < 2 * NL);
    }
  }
  merge_wide(t, even, odd);
}

// t = a^2, 16 limbs: the 28 products a[i] a[j], i < j, once (36 wide
// products in all), their sum doubled by a one-bit shift, then the 8
// squares a[i]^2 added at limb 2 i.
__device__ __forceinline__ void sqr_wide(uint32_t t[2 * NL], const uint32_t a[NL]) {
  uint32_t even[2 * NL], odd[2 * NL];
#pragma unroll
  for (int j = 0; j < 2 * NL; ++j) even[j] = odd[j] = 0;
  mul_row(odd, a + 1, a[0], NL / 2);           // a[0] a[1, 3, 5, 7]: columns 1, 3, 5, 7
  mul_row(even + 2, a + 2, a[0], NL / 2 - 1);  // a[0] a[2, 4, 6]: columns 2, 4, 6
#pragma unroll
  for (int i = 1; i < NL - 1; ++i) {
    // a[i] a[i + 1, i + 3, ..]: odd columns 2i + 1, ..; a[i] a[i + 2, ..]: even ones
    mad_row(odd + 2 * i, a + i + 1, a[i], (NL - i) / 2, true);
    mad_row(even + 2 * i + 2, a + i + 2, a[i], (NL - 1 - i) / 2, true);
  }
  merge_wide(t, even, odd);
  // The off-diagonal sum is below 2^511: doubling keeps 16 limbs.
#pragma unroll
  for (int j = 2 * NL - 1; j > 0; --j) t[j] = (t[j] << 1) | (t[j - 1] >> 31);
  uint64_t d[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) d[i] = (uint64_t)a[i] * a[i];
  t[0] = lo32(d[0]);  // the doubled sum has no limb 0
  t[1] = add_cc(t[1], hi32(d[0]));
#pragma unroll
  for (int i = 1; i < NL - 1; ++i) {
    t[2 * i] = addc_cc(t[2 * i], lo32(d[i]));
    t[2 * i + 1] = addc_cc(t[2 * i + 1], hi32(d[i]));
  }
  t[2 * NL - 2] = addc_cc(t[2 * NL - 2], lo32(d[NL - 1]));
  t[2 * NL - 1] = addc(t[2 * NL - 1], hi32(d[NL - 1]));
}

// r = t / R mod p for a 16-limb t (t is used up).  For t < 2 p^2 the value
// before the last step is below 2p and REDUCE subtracts p once: r < p.
// Without REDUCE, r is that value as it stands (the lazy products below).
//
// Row i adds m_i p 2^(32 i) with m_i = -t[i], which clears limb i:
//   limb i      t[i] + m_i = 2^32 (or 0 when m_i = 0): the carry that
//               starts the row's chain
//   limb i+1..4 m_i c1 at limbs (i + 1, i + 2) and m_i c3 at (i + 3, i + 4)
//               in that chain, then m_i c2 at (i + 2, i + 3) in a second one
//   limb i+5    what the two chains carry out waits in `cy` (<= 2) for the
//               next row, which adds it at its limb i + 4
//   limb i+7, 8 m_i << 30 and m_i >> 2 (the 2^254 term): only row 0's reaches
//               the low half (limb 7, read by row 7); the rest is added after
//               the last row as the limbs of (m_7 .. m_0) << 30.
// (t + m p) / R < 2^256 in every use, so the final sums carry nothing out.
template <int K, bool REDUCE = true>
__device__ __forceinline__ void mont_reduce(uint32_t r[NL], uint32_t t[2 * NL]) {
  static_assert(modulus<K>(0) == 1 && modulus<K>(4) == 0 && modulus<K>(5) == 0 &&
                    modulus<K>(6) == 0 && modulus<K>(7) == 0x40000000u,
                "mont_reduce is written for p = 1 + c1 2^32 + c2 2^64 + c3 2^96 + 2^254");
  constexpr uint32_t c1 = modulus<K>(1), c2 = modulus<K>(2), c3 = modulus<K>(3);
  uint32_t m[NL];
  uint32_t cy = 0, hc = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    m[i] = 0u - t[i];
    add_cc(t[i], m[i]);  // 0, and the carry (m_i != 0)
    madc_wide_cc(t[i + 1], t[i + 2], m[i], c1);
    madc_wide_cc(t[i + 3], t[i + 4], m[i], c3);
    const uint32_t ca = addc(0u, 0u);
    mad_wide_cc(t[i + 2], t[i + 3], m[i], c2);
    t[i + 4] = addc_cc(t[i + 4], cy);
    cy = addc(ca, 0u);  // <= 2, for limb i + 5
    if (i == 0) {
      t[7] = add_cc(t[7], m[0] << 30);
      hc = addc(0u, 0u);
    }
  }
  // r = t[8 .. 16) + ((m_7 .. m_0) << 30) / 2^256 + hc, then + cy 2^128
  add_cc(hc, 0xFFFFFFFFu);  // the carry (hc != 0)
#pragma unroll
  for (int j = 0; j < NL - 1; ++j)
    r[j] = addc_cc(t[NL + j], (m[j + 1] << 30) | (m[j] >> 2));
  r[NL - 1] = addc(t[2 * NL - 1], m[NL - 1] >> 2);
  r[4] = add_cc(r[4], cy);
  r[5] = addc_cc(r[5], 0u);
  r[6] = addc_cc(r[6], 0u);
  r[7] = addc(r[7], 0u);
  if (REDUCE) cond_sub_p<K>(r);
}

// r = a b / R mod p.  a, b < p (one may be lazy, see above); r < p.  r may
// alias a or b.
template <int K>
__device__ __forceinline__ void mont_mul(uint32_t r[NL], const uint32_t a[NL],
                                         const uint32_t b[NL]) {
  uint32_t t[2 * NL];
  mul_wide(t, a, b);
  mont_reduce<K>(r, t);
}

// r = a^2 / R mod p for canonical a < p; r < p.  r may alias a.
template <int K>
__device__ __forceinline__ void mont_sqr(uint32_t r[NL], const uint32_t a[NL]) {
  uint32_t t[2 * NL];
  sqr_wide(t, a);
  mont_reduce<K>(r, t);
}

// The same products without the last subtraction, for a chain of products
// whose intermediate values nobody compares: operands and results live in
// [0, L) with L = 2p (1 + 2^-100).  For a, b < 2p (1 + e), a b / R + p <
// p (1 + (1 + 2^-128) (1 + e)^2) < 2p (1 + e + 2^-128) for e < 2^-100: the
// bound's slack grows by 2^-128 a product, so it holds for 2^27 products
// in a row, and L < 2^256.  canon() brings the last value below p.
template <int K>
__device__ __forceinline__ void mont_mul_lazy(uint32_t r[NL], const uint32_t a[NL],
                                              const uint32_t b[NL]) {
  uint32_t t[2 * NL];
  mul_wide(t, a, b);
  mont_reduce<K, false>(r, t);
}

template <int K>
__device__ __forceinline__ void mont_sqr_lazy(uint32_t r[NL], const uint32_t a[NL]) {
  uint32_t t[2 * NL];
  sqr_wide(t, a);
  mont_reduce<K, false>(r, t);
}

}  // namespace vdf
