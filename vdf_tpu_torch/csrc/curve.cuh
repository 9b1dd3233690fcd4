// Complete Pasta point add and double for one CUDA thread (K0c of the
// port), on the field library field.cuh.
//
// Replaces vdf_tpu/curves/pallas_curve.py::KernelCurve.add/double: the
// complete a=0 formulas of Renes–Costello–Batina 2015 (algorithms 7 and
// 9), homogeneous projective (X : Y : Z), identity (0 : 1 : 0).  They are
// the formulas of curves/point.py (the plain versions add16/double16) and
// curves/int_ops.py, step for step.
//
// Bounds.  mont_mul takes operands below p (one may be below 2p), and the
// formulas multiply two sums, (x1 + y1)(x2 + y2).  Since 4p > 2^256 there
// is no room for the TPU kernel's lazy < 4p bookkeeping, so every sum and
// difference is reduced below p at once (add_mod, sub_mod): each value is
// canonical, and a result equals the plain version's limb for limb.
#pragma once

#include <cstdint>

#include "field.cuh"

namespace vdf {

struct Pt {
  uint32_t x[NL], y[NL], z[NL];
};

struct CurveConsts {
  uint32_t b3[NL];  // 3b = 15 in Montgomery form
  uint32_t r2[NL];  // R^2 mod p: mont_mul(a, r2) puts an integer into Montgomery form
};

// r = a + b mod p for a, b < p.
__device__ __forceinline__ void add_mod(uint32_t r[NL], const uint32_t a[NL],
                                        const uint32_t b[NL], const FieldConsts& F) {
  add_raw(r, a, b);  // < 2p < 2^256
  cond_sub_p(r, F);
}

__device__ __forceinline__ void set_identity(Pt& p, const FieldConsts& F) {
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    p.x[j] = 0;
    p.y[j] = F.one[j];
    p.z[j] = 0;
  }
}

// r = p + q (RCB15 algorithm 7, a = 0).  r may alias p or q.
__device__ __forceinline__ void point_add(Pt& r, const Pt& p, const Pt& q,
                                          const FieldConsts& F, const CurveConsts& C) {
  uint32_t t0[NL], t1[NL], t2[NL], t3[NL], t4[NL], y3[NL], s1[NL], s2[NL];
  mont_mul(t0, p.x, q.x, F);
  mont_mul(t1, p.y, q.y, F);
  mont_mul(t2, p.z, q.z, F);
  add_mod(s1, p.x, p.y, F);
  add_mod(s2, q.x, q.y, F);
  mont_mul(t3, s1, s2, F);
  add_mod(s1, t0, t1, F);
  sub_mod(t3, t3, s1, F);  // t3 = x1 y2 + x2 y1
  add_mod(s1, p.y, p.z, F);
  add_mod(s2, q.y, q.z, F);
  mont_mul(t4, s1, s2, F);
  add_mod(s1, t1, t2, F);
  sub_mod(t4, t4, s1, F);  // t4 = y1 z2 + y2 z1
  add_mod(s1, p.x, p.z, F);
  add_mod(s2, q.x, q.z, F);
  mont_mul(y3, s1, s2, F);
  add_mod(s1, t0, t2, F);
  sub_mod(y3, y3, s1, F);  // y3 = x1 z2 + x2 z1
  // p and q are not read below, so r may be written from here on.
  add_mod(s2, t0, t0, F);
  add_mod(s2, s2, t0, F);  // x3 = 3 t0
  mont_mul(t2, C.b3, t2, F);
  add_mod(s1, t1, t2, F);  // z3 = t1 + 3b t2
  sub_mod(t1, t1, t2, F);  // t1 - 3b t2
  mont_mul(y3, C.b3, y3, F);
  mont_mul(t0, t3, t1, F);
  mont_mul(t2, t4, y3, F);
  sub_mod(r.x, t0, t2, F);  // X = t3 t1 - t4 y3
  mont_mul(t0, t1, s1, F);
  mont_mul(t2, y3, s2, F);
  add_mod(r.y, t0, t2, F);  // Y = t1 z3 + y3 x3
  mont_mul(t0, s1, t4, F);
  mont_mul(t2, s2, t3, F);
  add_mod(r.z, t0, t2, F);  // Z = z3 t4 + x3 t3
}

// r = 2p (RCB15 algorithm 9, a = 0: 6M + 2S).  r may alias p.
__device__ __forceinline__ void point_double(Pt& r, const Pt& p, const FieldConsts& F,
                                             const CurveConsts& C) {
  uint32_t t0[NL], t1[NL], t2[NL], xy[NL], z8[NL], y3[NL], u[NL];
  mont_sqr(t0, p.y, F);
  mont_mul(t1, p.y, p.z, F);
  mont_sqr(t2, p.z, F);
  mont_mul(xy, p.x, p.y, F);
  mont_mul(t2, C.b3, t2, F);  // t2 = 3b z^2
  add_mod(z8, t0, t0, F);
  add_mod(z8, z8, z8, F);
  add_mod(z8, z8, z8, F);  // 8 t0
  add_mod(y3, t0, t2, F);
  add_mod(u, t2, t2, F);
  add_mod(u, u, t2, F);
  sub_mod(t0, t0, u, F);  // t0 - 3 t2
  mont_mul(u, t2, z8, F);  // x3 = t2 z3
  mont_mul(r.z, t1, z8, F);  // Z = t1 z3
  mont_mul(y3, t0, y3, F);
  add_mod(r.y, y3, u, F);  // Y = t0 y3 + x3
  mont_mul(xy, xy, t0, F);
  add_mod(r.x, xy, xy, F);  // X = 2 x y t0
}

}  // namespace vdf
