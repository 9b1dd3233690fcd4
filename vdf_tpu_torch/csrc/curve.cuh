// Complete Pasta point add and double for one CUDA thread (K0c of the
// port), on the field library field.cuh.
//
// Replaces vdf_tpu/curves/pallas_curve.py::KernelCurve.add/double: the
// complete a=0 formulas of Renes–Costello–Batina 2015 (algorithms 7 and
// 9), homogeneous projective (X : Y : Z), identity (0 : 1 : 0).  They are
// the formulas of curves/point.py (the plain versions add16/double16) and
// curves/int_ops.py, step for step.
//
// Bounds.  mont_mul takes operands below p (one may be below 2p), mont_sqr
// a canonical operand, and the formulas multiply two sums,
// (x1 + y1)(x2 + y2).  Since 4p > 2^256 there is no room for the TPU
// kernel's lazy < 4p bookkeeping, so every sum and difference is reduced
// below p at once (add_mod, sub_mod in field.cuh): each value is canonical,
// and a result equals the plain version's limb for limb.  The coordinates
// that come in are canonical too: every kernel either reduces what it loads
// (canon) or reads points that a kernel or Field.encode wrote.
#pragma once

#include <cstdint>

#include "field.cuh"

namespace vdf {

struct Pt {
  uint32_t x[NL], y[NL], z[NL];
};

VDF_LIMB_TABLE(curve_b3, VDF_B3_INIT)  // 3b = 15 in Montgomery form
VDF_LIMB_TABLE(mont_r2, VDF_R2_INIT)   // R^2 mod p: mont_mul(a, r2) puts an integer into Montgomery form

template <int K>
__device__ __forceinline__ void set_identity(Pt& p) {
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    p.x[j] = 0;
    p.y[j] = mont_one<K>(j);
    p.z[j] = 0;
  }
}

// r = 3b a for a < p.
template <int K>
__device__ __forceinline__ void mul_b3(uint32_t r[NL], const uint32_t a[NL]) {
  uint32_t b3[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) b3[j] = curve_b3<K>(j);
  mont_mul<K>(r, b3, a);
}

// r = p + q (RCB15 algorithm 7, a = 0).  r may alias p or q.
template <int K>
__device__ __forceinline__ void point_add(Pt& r, const Pt& p, const Pt& q) {
  uint32_t t0[NL], t1[NL], t2[NL], t3[NL], t4[NL], y3[NL], s1[NL], s2[NL];
  mont_mul<K>(t0, p.x, q.x);
  mont_mul<K>(t1, p.y, q.y);
  mont_mul<K>(t2, p.z, q.z);
  add_mod<K>(s1, p.x, p.y);
  add_mod<K>(s2, q.x, q.y);
  mont_mul<K>(t3, s1, s2);
  add_mod<K>(s1, t0, t1);
  sub_mod<K>(t3, t3, s1);  // t3 = x1 y2 + x2 y1
  add_mod<K>(s1, p.y, p.z);
  add_mod<K>(s2, q.y, q.z);
  mont_mul<K>(t4, s1, s2);
  add_mod<K>(s1, t1, t2);
  sub_mod<K>(t4, t4, s1);  // t4 = y1 z2 + y2 z1
  add_mod<K>(s1, p.x, p.z);
  add_mod<K>(s2, q.x, q.z);
  mont_mul<K>(y3, s1, s2);
  add_mod<K>(s1, t0, t2);
  sub_mod<K>(y3, y3, s1);  // y3 = x1 z2 + x2 z1
  // p and q are not read below, so r may be written from here on.
  add_mod<K>(s2, t0, t0);
  add_mod<K>(s2, s2, t0);  // x3 = 3 t0
  mul_b3<K>(t2, t2);
  add_mod<K>(s1, t1, t2);  // z3 = t1 + 3b t2
  sub_mod<K>(t1, t1, t2);  // t1 - 3b t2
  mul_b3<K>(y3, y3);
  mont_mul<K>(t0, t3, t1);
  mont_mul<K>(t2, t4, y3);
  sub_mod<K>(r.x, t0, t2);  // X = t3 t1 - t4 y3
  mont_mul<K>(t0, t1, s1);
  mont_mul<K>(t2, y3, s2);
  add_mod<K>(r.y, t0, t2);  // Y = t1 z3 + y3 x3
  mont_mul<K>(t0, s1, t4);
  mont_mul<K>(t2, s2, t3);
  add_mod<K>(r.z, t0, t2);  // Z = z3 t4 + x3 t3
}

// r = 2p (RCB15 algorithm 9, a = 0: 6M + 2S).  r may alias p.
template <int K>
__device__ __forceinline__ void point_double(Pt& r, const Pt& p) {
  uint32_t t0[NL], t1[NL], t2[NL], xy[NL], z8[NL], y3[NL], u[NL];
  mont_sqr<K>(t0, p.y);
  mont_mul<K>(t1, p.y, p.z);
  mont_sqr<K>(t2, p.z);
  mont_mul<K>(xy, p.x, p.y);
  mul_b3<K>(t2, t2);  // t2 = 3b z^2
  add_mod<K>(z8, t0, t0);
  add_mod<K>(z8, z8, z8);
  add_mod<K>(z8, z8, z8);  // 8 t0
  add_mod<K>(y3, t0, t2);
  add_mod<K>(u, t2, t2);
  add_mod<K>(u, u, t2);
  sub_mod<K>(t0, t0, u);  // t0 - 3 t2
  mont_mul<K>(u, t2, z8);  // x3 = t2 z3
  mont_mul<K>(r.z, t1, z8);  // Z = t1 z3
  mont_mul<K>(y3, t0, y3);
  add_mod<K>(r.y, y3, u);  // Y = t0 y3 + x3
  mont_mul<K>(xy, xy, t0);
  add_mod<K>(r.x, xy, xy);  // X = 2 x y t0
}

}  // namespace vdf
