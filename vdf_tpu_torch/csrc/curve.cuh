// Complete Pasta point add and double (K0c of the port) on the field
// library field.cuh: for one CUDA thread (point_add, point_double), and on a
// group of GROUP = 8 threads (group_add, group_dbl; see their section).
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

// r = 3b a for a < p: a small-constant multiply (field.cuh), the residue a
// Montgomery product by curve_b3 gives.
template <int K>
__device__ __forceinline__ void mul_b3(uint32_t r[NL], const uint32_t a[NL]) {
  mul_small<K>(r, a, VDF_B3);
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

// r = 2p (RCB15 algorithm 9, a = 0: 5M + 2S and one 3b a).  r may alias p.
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

// r = 2p as point_double, on lazy coordinates (below 2p (1 + 2^-100), the
// bound of field.cuh's lazy products) in and out: the same residues, for
// chains of doublings that end in canon() (K7's thread form).  The products
// skip their last subtraction where a lazy result may follow; 3b z^2, 9b z^2,
// 8 y^2 and 2 x y are small-constant multiplies, which take any 256-bit
// operand and return it canonical; a lazy sum that feeds a product (a lazy
// value plus a canonical one, < 3p) is brought below 2p by one conditional
// subtraction; the difference y^2 - 9b z^2 is a lazy value minus a canonical
// one.  r may alias p.
template <int K>
__device__ __forceinline__ void point_double_lazy(Pt& r, const Pt& p) {
  uint32_t t0[NL], t1[NL], t2[NL], xy[NL], b3[NL], b9[NL], z8[NL], y3[NL];
  mont_sqr_lazy<K>(t0, p.y);         // y^2
  mont_mul_lazy<K>(t1, p.y, p.z);    // y z
  mont_sqr_lazy<K>(t2, p.z);         // z^2
  mont_mul_lazy<K>(xy, p.x, p.y);    // x y
  mul_small<K>(b3, t2, VDF_B3);      // 3b z^2, canonical
  mul_small<K>(b9, t2, 3 * VDF_B3);  // 9b z^2, canonical
  mul_small<K>(z8, t0, 8);           // z3 = 8 y^2, canonical
  mul_small<K>(xy, xy, 2);           // 2 x y, canonical
  add_raw(y3, t0, b3);
  cond_sub_p<K>(y3);                 // y3 = y^2 + 3b z^2
  sub_mod<K>(t0, t0, b9);            // y^2 - 9b z^2
  mont_mul<K>(t2, b3, z8);           // x3 = 3b z^2 z3, canonical
  mont_mul_lazy<K>(r.z, t1, z8);     // Z = y z z3
  mont_mul_lazy<K>(y3, t0, y3);
  mont_mul_lazy<K>(r.x, xy, t0);     // X = 2 x y (y^2 - 9b z^2)
  add_raw(r.y, y3, t2);
  cond_sub_p<K>(r.y);                // Y = (y^2 - 9b z^2) y3 + x3
}

// ---------------------------------------------------------------------
// The same add and doubling on a group of GROUP = 8 threads
// ---------------------------------------------------------------------
//
// The formulas are three products deep: an add's six products of sums
// (t0 = x1 x2, t1 = y1 y2, t2 = z1 z2, (x1 + y1)(x2 + y2), (y1 + z1)(y2 + z2),
// (x1 + z1)(x2 + z2)), its two 3b products, then six more; a doubling's four
// (y^2, y z, z^2, x y), one 3b product, then four.  With 3b a small-constant
// multiply (mul_small) the middle level is no product, so each operation is
// four steps, each a set of up to GROUP independent tasks that exchange
// whole field elements through the group's buffer in shared memory
// (GROUP_SLOTS slots of NL words):
//   1. product   task v: slot[out] = (slot[a] + slot[a2]) (slot[b] + slot[b2])
//   2. combine   task v: slot[out] = ka slot[a] -+ kb (slot[b] + slot[b2])
//   3. product   the six (four) final products
//   4. combine   the output sums, into slots P.
// Lane v of the group runs task v where the step has one (so the add is
// two products deep, the doubling two), and idles where not.  Each task
// reads its operands by a small index table (6 bits a task, packed in a
// 64-bit word) on the same code path as its neighbours: a task that needs
// no sum adds the zero slot (add_mod(a, 0) = a); a term that no task of the
// step needs (a sum, a multiplier other than 1, a sign) is left out at
// compile time.  Every value is canonical, so any schedule of the same
// formulas gives the limbs point_add and point_double give.  Within a step
// no task writes a slot that another task reads; between steps the group
// synchronises (__syncwarp of its own lanes, on the card).  The host test
// runs the tasks one after another, in order and reversed.

struct alignas(16) U4 {  // 16 bytes: a sixth of a point record, half a slot
  uint32_t w[4];
};

constexpr int GROUP = 8;         // lanes a group, and tasks a step at most
constexpr int GS_P = 0;          // P = (x, y, z): the input, and the output
constexpr int GS_Q = 3;          // Q: an add's second operand
constexpr int GS_ZERO = 6;       // 0, written once by the caller
constexpr int GS_R1 = 7;         // task v writes GS_R1 + v in steps 1 and 3
constexpr int GS_R2 = 15;        // task v writes GS_R2 + v in step 2
constexpr int GROUP_SLOTS = 23;
constexpr int GROUP_WORDS = GROUP_SLOTS * NL;
constexpr int GROUP_STEPS = 4;

struct GroupStep {
  bool product;
  int count;                                // tasks
  uint64_t a, a2, b, b2, ka, kb, neg, out;  // per task, 6 bits each
};

VDF_HOST_DEVICE constexpr uint64_t lanes8(int l0, int l1, int l2, int l3, int l4, int l5,
                                          int l6, int l7) {
  return (uint64_t)l0 | (uint64_t)l1 << 6 | (uint64_t)l2 << 12 | (uint64_t)l3 << 18 |
         (uint64_t)l4 << 24 | (uint64_t)l5 << 30 | (uint64_t)l6 << 36 | (uint64_t)l7 << 42;
}
VDF_HOST_DEVICE constexpr uint64_t all8(int v) { return lanes8(v, v, v, v, v, v, v, v); }

constexpr int G0 = GS_ZERO;
constexpr uint64_t R1_OUT = lanes8(7, 8, 9, 10, 11, 12, 13, 14);
constexpr uint64_t R2_OUT = lanes8(15, 16, 17, 18, 19, 20, 21, 22);
constexpr uint64_t P_OUT = lanes8(0, 1, 2, 0, 0, 0, 0, 0);

// Step i of an add (RCB15 algorithm 7).  Step 1 leaves L0 .. L5 in slots
// 7 .. 12, step 2 t3 = L3 - L0 - L1, t4 = L4 - L1 - L2, 3b y3 = 3b (L5 - L0
// - L2), x3 = 3 L0, z3 = L1 + 3b L2 and t1 = L1 - 3b L2 in slots 15 .. 20,
// step 3 t3 t1, t4 3b y3, t1 z3, 3b y3 x3, z3 t4, x3 t3 in slots 7 .. 12.
VDF_HOST_DEVICE constexpr GroupStep group_add_step(int i) {
  switch (i) {
    case 0:
      return {true, 6, lanes8(0, 1, 2, 0, 1, 0, G0, G0), lanes8(G0, G0, G0, 1, 2, 2, G0, G0),
              lanes8(3, 4, 5, 3, 4, 3, G0, G0), lanes8(G0, G0, G0, 4, 5, 5, G0, G0), all8(1),
              all8(1), all8(0), R1_OUT};
    case 1:
      return {false, 6, lanes8(10, 11, 12, 7, 8, 8, G0, G0), all8(G0),
              lanes8(7, 8, 7, G0, 9, 9, G0, G0), lanes8(8, 9, 9, G0, G0, G0, G0, G0),
              lanes8(1, 1, VDF_B3, 3, 1, 1, 1, 1), lanes8(1, 1, VDF_B3, 1, VDF_B3, VDF_B3, 1, 1),
              lanes8(1, 1, 1, 0, 0, 1, 0, 0), R2_OUT};
    case 2:
      return {true, 6, lanes8(15, 16, 20, 17, 19, 18, G0, G0), all8(G0),
              lanes8(20, 17, 19, 18, 16, 15, G0, G0), all8(G0), all8(1), all8(1), all8(0),
              R1_OUT};
    default:  // X = t3 t1 - t4 3b y3, Y = t1 z3 + 3b y3 x3, Z = z3 t4 + x3 t3
      return {false, 3, lanes8(7, 9, 11, G0, G0, G0, G0, G0), all8(G0),
              lanes8(8, 10, 12, G0, G0, G0, G0, G0), all8(G0), all8(1), all8(1),
              lanes8(1, 0, 0, 0, 0, 0, 0, 0), P_OUT};
  }
}

// Step i of a doubling (RCB15 algorithm 9).  Step 1 leaves t0 = y^2, t1 =
// y z, t2 = z^2, x y in slots 7 .. 10, step 2 3b t2, 8 t0, y3 = t0 + 3b t2,
// t0 - 9b t2, t1 and x y in slots 15 .. 20, step 3 the four products.
VDF_HOST_DEVICE constexpr GroupStep group_dbl_step(int i) {
  switch (i) {
    case 0:
      return {true, 4, lanes8(1, 1, 2, 0, G0, G0, G0, G0), all8(G0),
              lanes8(1, 2, 2, 1, G0, G0, G0, G0), all8(G0), all8(1), all8(1), all8(0), R1_OUT};
    case 1:
      return {false, 6, lanes8(9, 7, 7, 7, 8, 10, G0, G0), all8(G0),
              lanes8(G0, G0, 9, 9, G0, G0, G0, G0), all8(G0),
              lanes8(VDF_B3, 8, 1, 1, 1, 1, 1, 1), lanes8(1, 1, VDF_B3, 3 * VDF_B3, 1, 1, 1, 1),
              lanes8(0, 0, 0, 1, 0, 0, 0, 0), R2_OUT};
    case 2:
      return {true, 4, lanes8(15, 19, 18, 20, G0, G0, G0, G0), all8(G0),
              lanes8(16, 16, 17, 18, G0, G0, G0, G0), all8(G0), all8(1), all8(1), all8(0),
              R1_OUT};
    default:  // X = 2 x y t0', Y = t0' y3 + 3b t2 8 t0, Z = t1 8 t0
      return {false, 3, lanes8(10, 9, 8, G0, G0, G0, G0, G0), all8(G0),
              lanes8(G0, 7, G0, G0, G0, G0, G0, G0), all8(G0), lanes8(2, 1, 1, 1, 1, 1, 1, 1),
              all8(1), all8(0), P_OUT};
  }
}

__device__ __forceinline__ int task_field(uint64_t f, int v) { return (int)((f >> (6 * v)) & 63); }

__device__ __forceinline__ void load_slot(uint32_t r[NL], const uint32_t* buf, uint64_t f,
                                          int v) {
  const U4* s = reinterpret_cast<const U4*>(buf + task_field(f, v) * NL);
  const U4 lo = s[0], hi = s[1];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r[j] = lo.w[j];
    r[4 + j] = hi.w[j];
  }
}

__device__ __forceinline__ void store_slot(uint32_t* buf, uint64_t f, int v,
                                           const uint32_t a[NL]) {
  U4 lo, hi;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo.w[j] = a[j];
    hi.w[j] = a[4 + j];
  }
  U4* d = reinterpret_cast<U4*>(buf + task_field(f, v) * NL);
  d[0] = lo;
  d[1] = hi;
}

// Task v of one step, on its group's buffer.
template <int K>
__device__ __forceinline__ void group_task(uint32_t* buf, const GroupStep& s, int v) {
  uint32_t u[NL], w[NL], t[NL];
  load_slot(w, buf, s.b, v);
  if (s.b2 != all8(G0)) {
    load_slot(t, buf, s.b2, v);
    add_mod<K>(w, w, t);
  }
  load_slot(u, buf, s.a, v);
  if (s.product) {
    if (s.a2 != all8(G0)) {
      load_slot(t, buf, s.a2, v);
      add_mod<K>(u, u, t);
    }
    mont_mul<K>(u, u, w);
  } else {
    if (s.kb != all8(1)) mul_small<K>(w, w, task_field(s.kb, v));
    if (s.neg != all8(0)) cond_neg_mod<K>(w, w, task_field(s.neg, v) != 0);
    if (s.ka != all8(1)) mul_small<K>(u, u, task_field(s.ka, v));
    add_mod<K>(u, u, w);
  }
  store_slot(buf, s.out, v, u);
}

// What lane `lane` of the group does in one step: task `lane`, if the step
// has one.
template <int K>
__device__ __forceinline__ void group_step(uint32_t* buf, const GroupStep& s, int lane) {
  if (lane < s.count) group_task<K>(buf, s, lane);
}

#ifdef __CUDACC__

// The group of the calling thread: lanes GROUP g .. GROUP g + GROUP - 1 of
// its warp.
__device__ __forceinline__ unsigned group_mask() {
  return ((1u << GROUP) - 1) << ((threadIdx.x & 31) & ~(GROUP - 1));
}

// slot P = slot P + slot Q, on the group's buffer; every lane of the group
// calls it, after a __syncwarp that made P, Q and the zero slot visible, and
// the result is visible to the group when it returns.  Out of line, as
// add_pt is (msm_kernels.cuh).
template <int K>
__device__ __noinline__ void group_add(uint32_t* buf, int lane, unsigned mask) {
#pragma unroll
  for (int i = 0; i < GROUP_STEPS; ++i) {
    group_step<K>(buf, group_add_step(i), lane);
    __syncwarp(mask);
  }
}

// slot P = 2 slot P, as group_add.
template <int K>
__device__ __noinline__ void group_dbl(uint32_t* buf, int lane, unsigned mask) {
#pragma unroll
  for (int i = 0; i < GROUP_STEPS; ++i) {
    group_step<K>(buf, group_dbl_step(i), lane);
    __syncwarp(mask);
  }
}

#endif  // __CUDACC__

}  // namespace vdf
