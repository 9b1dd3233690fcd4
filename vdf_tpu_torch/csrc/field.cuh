// Pasta field arithmetic for one CUDA thread: 8 little-endian u32 limbs,
// Montgomery form with R = 2^256 (K0 of the port).
//
// Replaces vdf_tpu/fields/pallas_field.py::KernelField, the in-kernel
// field library of the TPU kernels (radix-2^12 int32 limb lists whose
// products fit the VPU's 32-bit lanes).  Hopper has a 32x32->64-bit
// integer multiply, so the port uses the classic CIOS ladder over 32-bit
// limbs with 64-bit accumulators, as vdf_tpu/native/pasta.cpp does over
// 64-bit limbs on the host.
//
// Bounds.  p = 2^254 + c with a 126-bit c, so 2p < 3p < R but 4p > R: a
// lazy sum must stay below 3p to fit in 256 bits.  Every value this file
// returns is canonical (< p) unless its comment says otherwise:
//   mont_mul(a, b)  a, b < p (one of them may be < 2p): the CIOS value
//                   (ab + mp)/R < 2p, then one conditional subtraction;
//   add_raw(a, b)   a + b, no reduction: the caller keeps it < 2^256;
//   cond_sub_p(v)   v < 2p -> v < p;
//   canon(v)        any 256-bit v (< 4p) -> v < p;
//   sub_mod(a, b)   a, b < p -> a - b mod p.
#pragma once

#include <cstdint>

namespace vdf {

constexpr int NL = 8;  // u32 limbs per field element

struct FieldConsts {
  uint32_t p[NL];
  uint32_t two_p[NL];
  uint32_t one[NL];  // R mod p, the Montgomery one
  uint32_t pinv;     // -p^{-1} mod 2^32
};

__device__ __forceinline__ void copy(uint32_t r[NL], const uint32_t a[NL]) {
#pragma unroll
  for (int j = 0; j < NL; ++j) r[j] = a[j];
}

// v -= m if v >= m (in place), for any 256-bit v and m.
__device__ __forceinline__ void cond_sub(uint32_t v[NL], const uint32_t m[NL]) {
  uint32_t d[NL];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    uint64_t s = (uint64_t)v[j] - m[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = s >> 63;  // the difference wrapped: 1 borrow
  }
  const bool keep = borrow != 0;  // v < m
#pragma unroll
  for (int j = 0; j < NL; ++j) v[j] = keep ? v[j] : d[j];
}

__device__ __forceinline__ void cond_sub_p(uint32_t v[NL], const FieldConsts& F) {
  cond_sub(v, F.p);
}

__device__ __forceinline__ void canon(uint32_t v[NL], const FieldConsts& F) {
  cond_sub(v, F.two_p);  // < 4p -> < 2p
  cond_sub(v, F.p);      // < 2p -> < p
}

// r = a + b, no reduction (a + b < 2^256 is the caller's bound).
__device__ __forceinline__ void add_raw(uint32_t r[NL], const uint32_t a[NL],
                                        const uint32_t b[NL]) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    c += (uint64_t)a[j] + b[j];
    r[j] = (uint32_t)c;
    c >>= 32;
  }
}

// r = a - b mod p for canonical a, b < p; r < p.
__device__ __forceinline__ void sub_mod(uint32_t r[NL], const uint32_t a[NL],
                                        const uint32_t b[NL], const FieldConsts& F) {
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    uint64_t s = (uint64_t)a[j] - b[j] - borrow;
    r[j] = (uint32_t)s;
    borrow = s >> 63;
  }
  // a < b: the limbs hold a - b + 2^256; adding p wraps back to a - b + p.
  const uint32_t mask = borrow ? 0xFFFFFFFFu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    c += (uint64_t)r[j] + (F.p[j] & mask);
    r[j] = (uint32_t)c;
    c >>= 32;
  }
}

// r = a * b / R mod p (CIOS).  a, b < p (one may be < 2p); r < p.
// r may alias a or b.  Each 64-bit step a_j * b_i + t_j + carry is at
// most (2^32 - 1)^2 + 2 (2^32 - 1) = 2^64 - 1, so nothing overflows.
__device__ __forceinline__ void mont_mul(uint32_t r[NL], const uint32_t a[NL],
                                         const uint32_t b[NL], const FieldConsts& F) {
  uint32_t t[NL + 2];
#pragma unroll
  for (int j = 0; j < NL + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      c += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NL];
    t[NL] = (uint32_t)c;
    t[NL + 1] = (uint32_t)(c >> 32);

    const uint32_t m = t[0] * F.pinv;  // t + m p = 0 mod 2^32
    c = ((uint64_t)m * F.p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NL; ++j) {
      c += (uint64_t)m * F.p[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NL];
    t[NL - 1] = (uint32_t)c;
    t[NL] = t[NL + 1] + (uint32_t)(c >> 32);
  }
  // t < 2p < 2^256, so t[NL] == 0 here.
#pragma unroll
  for (int j = 0; j < NL; ++j) r[j] = t[j];
  cond_sub_p(r, F);
}

// r = a^2 / R mod p.  The first design squares through the general
// product; a dedicated squaring (off-diagonal terms once, doubled) is a
// later optimisation.
__device__ __forceinline__ void mont_sqr(uint32_t r[NL], const uint32_t a[NL],
                                         const FieldConsts& F) {
  mont_mul(r, a, a, F);
}

}  // namespace vdf
