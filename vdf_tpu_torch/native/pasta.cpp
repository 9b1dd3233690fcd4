// Native (host CPU) Pasta field/curve/MSM/VDF kernels.
//
// Plays the role of the reference's single native component, pasta-msm
// (supranational Pippenger under Rust bindings, SURVEY.md §2 D5), plus a
// reference-grade scalar MinRoot evaluator used to measure an honest
// CPU baseline for bench comparisons (the Rust reference's own workload,
// /root/reference/benches/vdf.rs).
//
// Field arithmetic: 4x64-bit Montgomery (R = 2^256) with __int128
// products — the classic CIOS ladder.  Constants are generated into
// pasta_constants.h by the Python build shim from the same primes the
// JAX side uses (single source of truth).
//
// Exposed via a C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

#include "pasta_constants.h"

typedef unsigned __int128 u128;
typedef uint64_t u64;

namespace {

struct FieldCtx {
  const u64* p;     // modulus, 4 limbs LE
  u64 pinv;         // -p^{-1} mod 2^64
  const u64* r2;    // R^2 mod p
  const u64* one;   // R mod p (Montgomery one)
};

static const FieldCtx FP_CTX = {FP_MOD, FP_PINV, FP_R2, FP_ONE};
static const FieldCtx FQ_CTX = {FQ_MOD, FQ_PINV, FQ_R2, FQ_ONE};

struct Fe {
  u64 v[4];
};

static inline bool ge_p(const Fe& a, const u64* p) {
  for (int i = 3; i >= 0; --i) {
    if (a.v[i] > p[i]) return true;
    if (a.v[i] < p[i]) return false;
  }
  return true;  // equal
}

static inline void sub_p(Fe& a, const u64* p) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - p[i] - (u64)borrow;
    a.v[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

static inline void fe_add(const FieldCtx& f, const Fe& a, const Fe& b, Fe& out) {
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.v[i] + b.v[i] + (u64)carry;
    out.v[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry || ge_p(out, f.p)) sub_p(out, f.p);
}

static inline void fe_sub(const FieldCtx& f, const Fe& a, const Fe& b, Fe& out) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - b.v[i] - (u64)borrow;
    out.v[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  if (borrow) {  // add p back
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)out.v[i] + f.p[i] + (u64)carry;
      out.v[i] = (u64)s;
      carry = s >> 64;
    }
  }
}

// Montgomery multiplication (CIOS).
static inline void fe_mul(const FieldCtx& f, const Fe& a, const Fe& b, Fe& out) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)a.v[j] * b.v[i] + t[j] + (u64)carry;
      t[j] = (u64)s;
      carry = s >> 64;
    }
    u128 s = (u128)t[4] + (u64)carry;
    t[4] = (u64)s;
    t[5] = (u64)(s >> 64);

    u64 m = t[0] * f.pinv;
    carry = 0;
    u128 s0 = (u128)m * f.p[0] + t[0];
    carry = s0 >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 sj = (u128)m * f.p[j] + t[j] + (u64)carry;
      t[j - 1] = (u64)sj;
      carry = sj >> 64;
    }
    u128 s4 = (u128)t[4] + (u64)carry;
    t[3] = (u64)s4;
    t[4] = t[5] + (u64)(s4 >> 64);
    t[5] = 0;
  }
  Fe r = {{t[0], t[1], t[2], t[3]}};
  if (t[4] || ge_p(r, f.p)) sub_p(r, f.p);
  out = r;
}

static inline void fe_sqr(const FieldCtx& f, const Fe& a, Fe& out) {
  fe_mul(f, a, a, out);
}

static inline void to_mont(const FieldCtx& f, const Fe& a, Fe& out) {
  Fe r2;
  std::memcpy(r2.v, f.r2, 32);
  fe_mul(f, a, r2, out);
}

static inline void from_mont(const FieldCtx& f, const Fe& a, Fe& out) {
  Fe one = {{1, 0, 0, 0}};
  fe_mul(f, a, one, out);
}

static inline bool fe_is_zero(const Fe& a) {
  return !(a.v[0] | a.v[1] | a.v[2] | a.v[3]);
}

// Windowed fixed-exponent power (w = 4), exponent canonical LE limbs.
static void fe_pow(const FieldCtx& f, const Fe& base, const u64* e, Fe& out) {
  Fe table[16];
  std::memcpy(table[0].v, f.one, 32);
  table[1] = base;
  for (int k = 2; k < 16; ++k) fe_mul(f, table[k - 1], base, table[k]);
  Fe acc;
  std::memcpy(acc.v, f.one, 32);
  bool started = false;
  for (int limb = 3; limb >= 0; --limb) {
    for (int nib = 15; nib >= 0; --nib) {
      int d = (e[limb] >> (nib * 4)) & 0xF;
      if (started) {
        fe_sqr(f, acc, acc);
        fe_sqr(f, acc, acc);
        fe_sqr(f, acc, acc);
        fe_sqr(f, acc, acc);
        if (d) fe_mul(f, acc, table[d], acc);
      } else if (d) {
        acc = table[d];
        started = true;
      }
    }
  }
  out = acc;
}

// ------------------------------------------------------------------
// MinRoot VDF (forward = inverse 5th root; inverse = x^5)
// ------------------------------------------------------------------

static void minroot_eval(const FieldCtx& f, const u64* inv_alpha, Fe& x, Fe& y,
                         Fe& i, u64 t, const u64* one_plain_mont) {
  Fe one;
  std::memcpy(one.v, one_plain_mont, 32);
  for (u64 k = 0; k < t; ++k) {
    Fe sum, nx;
    fe_add(f, x, y, sum);
    fe_pow(f, sum, inv_alpha, nx);
    Fe ny;
    fe_add(f, x, i, ny);
    fe_add(f, i, one, i);
    x = nx;
    y = ny;
  }
}

static void minroot_inverse(const FieldCtx& f, Fe& x, Fe& y, Fe& i, u64 t,
                            const u64* one_plain_mont) {
  Fe one;
  std::memcpy(one.v, one_plain_mont, 32);
  for (u64 k = 0; k < t; ++k) {
    Fe ni, nx, x2, x4, x5, ny;
    fe_sub(f, i, one, ni);
    fe_sub(f, y, ni, nx);
    fe_sqr(f, x, x2);
    fe_sqr(f, x2, x4);
    fe_mul(f, x4, x, x5);
    fe_sub(f, x5, nx, ny);
    x = nx;
    y = ny;
    i = ni;
  }
}

// ------------------------------------------------------------------
// Curve (Jacobian; host code may branch freely)
// ------------------------------------------------------------------

struct Pt {  // Jacobian (X, Y, Z); identity: Z == 0
  Fe x, y, z;
};

static void pt_identity(const FieldCtx& f, Pt& p) {
  std::memset(&p, 0, sizeof(Pt));
  std::memcpy(p.x.v, f.one, 32);
  std::memcpy(p.y.v, f.one, 32);
}

static void pt_double(const FieldCtx& f, const Pt& p, Pt& out) {
  if (fe_is_zero(p.z)) {
    out = p;
    return;
  }
  Fe a, b, c, d, e, g, x3, y3, z3, t;
  fe_sqr(f, p.x, a);            // A = X^2
  fe_sqr(f, p.y, b);            // B = Y^2
  fe_sqr(f, b, c);              // C = B^2
  fe_add(f, p.x, b, d);         // (X+B)
  fe_sqr(f, d, d);
  fe_sub(f, d, a, d);
  fe_sub(f, d, c, d);
  fe_add(f, d, d, d);           // D = 2((X+B)^2 - A - C)
  fe_add(f, a, a, e);
  fe_add(f, e, a, e);           // E = 3A
  fe_sqr(f, e, g);              // G = E^2
  fe_sub(f, g, d, x3);
  fe_sub(f, x3, d, x3);         // X3 = G - 2D
  fe_sub(f, d, x3, t);
  fe_mul(f, e, t, y3);
  fe_add(f, c, c, c);
  fe_add(f, c, c, c);
  fe_add(f, c, c, c);           // 8C
  fe_sub(f, y3, c, y3);         // Y3 = E(D - X3) - 8C
  fe_mul(f, p.y, p.z, z3);
  fe_add(f, z3, z3, z3);        // Z3 = 2YZ
  out.x = x3;
  out.y = y3;
  out.z = z3;
}

static void pt_add(const FieldCtx& f, const Pt& p, const Pt& q, Pt& out) {
  if (fe_is_zero(p.z)) {
    out = q;
    return;
  }
  if (fe_is_zero(q.z)) {
    out = p;
    return;
  }
  Fe z1z1, z2z2, u1, u2, s1, s2;
  fe_sqr(f, p.z, z1z1);
  fe_sqr(f, q.z, z2z2);
  fe_mul(f, p.x, z2z2, u1);
  fe_mul(f, q.x, z1z1, u2);
  Fe t;
  fe_mul(f, q.z, z2z2, t);
  fe_mul(f, p.y, t, s1);
  fe_mul(f, p.z, z1z1, t);
  fe_mul(f, q.y, t, s2);
  Fe h, r;
  fe_sub(f, u2, u1, h);
  fe_sub(f, s2, s1, r);
  if (fe_is_zero(h)) {
    if (fe_is_zero(r)) {
      pt_double(f, p, out);
      return;
    }
    pt_identity(f, out);
    return;
  }
  Fe hh, hhh, v, x3, y3, z3;
  fe_sqr(f, h, hh);
  fe_mul(f, h, hh, hhh);
  fe_mul(f, u1, hh, v);
  fe_sqr(f, r, x3);
  fe_sub(f, x3, hhh, x3);
  fe_sub(f, x3, v, x3);
  fe_sub(f, x3, v, x3);         // X3 = r^2 - H^3 - 2V
  fe_sub(f, v, x3, t);
  fe_mul(f, r, t, y3);
  fe_mul(f, s1, hhh, t);
  fe_sub(f, y3, t, y3);         // Y3 = r(V - X3) - S1*H^3
  fe_mul(f, p.z, q.z, z3);
  fe_mul(f, z3, h, z3);         // Z3 = Z1*Z2*H
  out.x = x3;
  out.y = y3;
  out.z = z3;
}

// Mixed add: q affine in Montgomery form (z == 1 implicit).
static void pt_add_affine(const FieldCtx& f, const Pt& p, const Fe& qx,
                          const Fe& qy, Pt& out) {
  if (fe_is_zero(p.z)) {
    out.x = qx;
    out.y = qy;
    std::memcpy(out.z.v, f.one, 32);
    return;
  }
  Fe z1z1, u2, s2;
  fe_sqr(f, p.z, z1z1);
  fe_mul(f, qx, z1z1, u2);
  Fe t;
  fe_mul(f, p.z, z1z1, t);
  fe_mul(f, qy, t, s2);
  Fe h, r;
  fe_sub(f, u2, p.x, h);
  fe_sub(f, s2, p.y, r);
  if (fe_is_zero(h)) {
    if (fe_is_zero(r)) {
      pt_double(f, p, out);
      return;
    }
    pt_identity(f, out);
    return;
  }
  Fe hh, hhh, v, x3, y3, z3;
  fe_sqr(f, h, hh);
  fe_mul(f, h, hh, hhh);
  fe_mul(f, p.x, hh, v);
  fe_sqr(f, r, x3);
  fe_sub(f, x3, hhh, x3);
  fe_sub(f, x3, v, x3);
  fe_sub(f, x3, v, x3);
  fe_sub(f, v, x3, t);
  fe_mul(f, r, t, y3);
  fe_mul(f, p.y, hhh, t);
  fe_sub(f, y3, t, y3);
  fe_mul(f, p.z, h, z3);
  out.x = x3;
  out.y = y3;
  out.z = z3;
}

// ------------------------------------------------------------------
// Pippenger MSM
// ------------------------------------------------------------------

static void msm_run(const FieldCtx& base, const u64* points /*n*8 canonical*/,
                    const u64* scalars /*n*4 canonical*/, u64 n,
                    u64* out /*12: projective canonical*/) {
  int c = 4;
  if (n >= 32) c = 8;
  if (n >= (1u << 14)) c = 12;
  int n_windows = (255 + c - 1) / c;
  int n_buckets = (1 << c) - 1;

  // Convert points to Montgomery affine once.
  std::vector<Fe> px(n), py(n);
  for (u64 i = 0; i < n; ++i) {
    Fe x = {{points[i * 8 + 0], points[i * 8 + 1], points[i * 8 + 2],
             points[i * 8 + 3]}};
    Fe y = {{points[i * 8 + 4], points[i * 8 + 5], points[i * 8 + 6],
             points[i * 8 + 7]}};
    to_mont(base, x, px[i]);
    to_mont(base, y, py[i]);
  }

  Pt total;
  pt_identity(base, total);
  std::vector<Pt> buckets(n_buckets);

  for (int w = n_windows - 1; w >= 0; --w) {
    for (int k = 0; k < c; ++k) pt_double(base, total, total);
    for (int b = 0; b < n_buckets; ++b) pt_identity(base, buckets[b]);
    for (u64 i = 0; i < n; ++i) {
      int bit = w * c;
      int limb = bit / 64, off = bit % 64;
      u64 d = scalars[i * 4 + limb] >> off;
      if (off + c > 64 && limb < 3) d |= scalars[i * 4 + limb + 1] << (64 - off);
      d &= (u64)n_buckets;  // low c bits (mask 2^c - 1)
      if (d) pt_add_affine(base, buckets[d - 1], px[i], py[i], buckets[d - 1]);
    }
    // suffix-sum: total += sum_d d * bucket[d]
    Pt running, acc;
    pt_identity(base, running);
    pt_identity(base, acc);
    for (int b = n_buckets - 1; b >= 0; --b) {
      pt_add(base, running, buckets[b], running);
      pt_add(base, acc, running, acc);
    }
    pt_add(base, total, acc, total);
  }

  // Output canonical projective (convert out of Montgomery).
  Fe ox, oy, oz;
  from_mont(base, total.x, ox);
  from_mont(base, total.y, oy);
  from_mont(base, total.z, oz);
  std::memcpy(out + 0, ox.v, 32);
  std::memcpy(out + 4, oy.v, 32);
  std::memcpy(out + 8, oz.v, 32);
}

// ------------------------------------------------------------------
// batched two-term point fold: out[i] = a*P[i] + b*Q[i]
// (the IPA prover's per-round generator fold — host-int tier)
// ------------------------------------------------------------------

static void pt_scalar_mul(const FieldCtx& f, const Pt& p, const u64* e,
                          Pt& out) {
  // MSB-first double-and-add over the significant bits of e.
  int top = -1;
  for (int bit = 255; bit >= 0; --bit) {
    if ((e[bit / 64] >> (bit % 64)) & 1) {
      top = bit;
      break;
    }
  }
  pt_identity(f, out);  // z == 0: the identity encoding
  if (top < 0) return;
  Pt acc = p;
  for (int bit = top - 1; bit >= 0; --bit) {
    pt_double(f, acc, acc);
    if ((e[bit / 64] >> (bit % 64)) & 1) pt_add(f, acc, p, acc);
  }
  out = acc;
}

static void fold_points_run(const FieldCtx& base, const u64* pts_p,
                            const u64* pts_q, const u64* sa, const u64* sb,
                            u64 n, u64* out_affine, u64* id_flags) {
  // Load + Montgomery-encode scalars' point operands; fold per point.
  std::vector<Pt> acc(n);
  for (u64 i = 0; i < n; ++i) {
    Fe px = {{pts_p[i * 8 + 0], pts_p[i * 8 + 1], pts_p[i * 8 + 2], pts_p[i * 8 + 3]}};
    Fe py = {{pts_p[i * 8 + 4], pts_p[i * 8 + 5], pts_p[i * 8 + 6], pts_p[i * 8 + 7]}};
    Fe qx = {{pts_q[i * 8 + 0], pts_q[i * 8 + 1], pts_q[i * 8 + 2], pts_q[i * 8 + 3]}};
    Fe qy = {{pts_q[i * 8 + 4], pts_q[i * 8 + 5], pts_q[i * 8 + 6], pts_q[i * 8 + 7]}};
    to_mont(base, px, px);
    to_mont(base, py, py);
    to_mont(base, qx, qx);
    to_mont(base, qy, qy);
    Pt P, Q, ta, tb;
    P.x = px; P.y = py; std::memcpy(P.z.v, base.one, 32);
    Q.x = qx; Q.y = qy; std::memcpy(Q.z.v, base.one, 32);
    pt_scalar_mul(base, P, sa, ta);
    pt_scalar_mul(base, Q, sb, tb);
    pt_add(base, ta, tb, acc[i]);
  }
  // Batch-normalize to affine: one inversion via prefix products.
  std::vector<Fe> prefix(n);
  Fe run;
  std::memcpy(run.v, base.one, 32);
  for (u64 i = 0; i < n; ++i) {
    prefix[i] = run;
    if (!fe_is_zero(acc[i].z)) fe_mul(base, run, acc[i].z, run);
  }
  // run = prod of nonzero z; invert by Fermat (e = p - 2).
  u64 pm2[4] = {base.p[0] - 2, base.p[1], base.p[2], base.p[3]};  // p odd, no borrow
  Fe inv_run;
  fe_pow(base, run, pm2, inv_run);
  for (u64 i = n; i-- > 0;) {
    if (fe_is_zero(acc[i].z)) {
      id_flags[i] = 1;
      std::memset(out_affine + i * 8, 0, 64);
      continue;
    }
    id_flags[i] = 0;
    Fe zinv;
    fe_mul(base, inv_run, prefix[i], zinv);   // 1 / z_i (others cancel)
    fe_mul(base, inv_run, acc[i].z, inv_run); // strip z_i from the running inverse
    Fe zi2, zi3, ax, ay;
    fe_sqr(base, zinv, zi2);
    fe_mul(base, zi2, zinv, zi3);
    fe_mul(base, acc[i].x, zi2, ax);
    fe_mul(base, acc[i].y, zi3, ay);
    from_mont(base, ax, ax);
    from_mont(base, ay, ay);
    std::memcpy(out_affine + i * 8 + 0, ax.v, 32);
    std::memcpy(out_affine + i * 8 + 4, ay.v, 32);
  }
}

}  // namespace

extern "C" {

// mode: 0 = Fp, 1 = Fq.  state: 12 u64 canonical [x, y, i]; in place.
void minroot_eval_native(int fq, u64* state, u64 t) {
  const FieldCtx& f = fq ? FQ_CTX : FP_CTX;
  const u64* ia = fq ? FQ_INVALPHA : FP_INVALPHA;
  Fe x = {{state[0], state[1], state[2], state[3]}};
  Fe y = {{state[4], state[5], state[6], state[7]}};
  Fe i = {{state[8], state[9], state[10], state[11]}};
  to_mont(f, x, x);
  to_mont(f, y, y);
  to_mont(f, i, i);
  minroot_eval(f, ia, x, y, i, t, f.one);
  from_mont(f, x, x);
  from_mont(f, y, y);
  from_mont(f, i, i);
  std::memcpy(state + 0, x.v, 32);
  std::memcpy(state + 4, y.v, 32);
  std::memcpy(state + 8, i.v, 32);
}

void minroot_inverse_native(int fq, u64* state, u64 t) {
  const FieldCtx& f = fq ? FQ_CTX : FP_CTX;
  Fe x = {{state[0], state[1], state[2], state[3]}};
  Fe y = {{state[4], state[5], state[6], state[7]}};
  Fe i = {{state[8], state[9], state[10], state[11]}};
  to_mont(f, x, x);
  to_mont(f, y, y);
  to_mont(f, i, i);
  minroot_inverse(f, x, y, i, t, f.one);
  from_mont(f, x, x);
  from_mont(f, y, y);
  from_mont(f, i, i);
  std::memcpy(state + 0, x.v, 32);
  std::memcpy(state + 4, y.v, 32);
  std::memcpy(state + 8, i.v, 32);
}

// curve: 0 = pallas (base Fp), 1 = vesta (base Fq).
// points: n * 8 u64 canonical affine; scalars: n * 4 u64 canonical.
// out: 12 u64 canonical projective.
void msm_native(int curve, const u64* points, const u64* scalars, u64 n,
                u64* out) {
  const FieldCtx& base = curve ? FQ_CTX : FP_CTX;
  msm_run(base, points, scalars, n, out);
}

// out[i] = a*P[i] + b*Q[i] for all i; affine canonical in/out (n*8 u64);
// id_flags[i] = 1 marks an identity result (out row zeroed).
void fold_points_native(int curve, const u64* pts_p, const u64* pts_q,
                        const u64* sa, const u64* sb, u64 n, u64* out,
                        u64* id_flags) {
  const FieldCtx& base = curve ? FQ_CTX : FP_CTX;
  fold_points_run(base, pts_p, pts_q, sa, sb, n, out, id_flags);
}

// ---------------------------------------------------------------------
// Complete projective (RCB15 a=0) ops + the EC fold-gadget witness
// emitter.  Mirrors nova/gadgets/ec.py value-for-value and allocation-
// for-allocation; the in-circuit fold's scalar-mul witness was ~25% of
// per-fold synthesis in Python ints.
// ---------------------------------------------------------------------

struct PPt {  // homogeneous projective (X : Y : Z); identity (0 : 1 : 0)
  Fe x, y, z;
};

// Emit helper: append canonical form of v to *out and advance.
static inline void emit_fe(const FieldCtx& f, const Fe& v, u64*& out) {
  Fe c;
  from_mont(f, v, c);
  std::memcpy(out, c.v, 32);
  out += 4;
}

// Complete add, emitting the 12 allocated products in gadget order
// (ec.py ProjPoint.add: t0,t1,t2,t3,t4,xz,x3a,x3b,y3a,y3b,z3a,z3b).
static void ppt_add_emit(const FieldCtx& f, const Fe& b3, const PPt& p,
                         const PPt& q, PPt& out, u64*& emit) {
  Fe t0, t1, t2, t3, t4, y3, x3, t2b, z3, t1n, y3b, x3a, x3b, y3a, y3bm, z3a, z3b, s;
  fe_mul(f, p.x, q.x, t0); emit_fe(f, t0, emit);
  fe_mul(f, p.y, q.y, t1); emit_fe(f, t1, emit);
  fe_mul(f, p.z, q.z, t2); emit_fe(f, t2, emit);
  Fe a1, a2;
  fe_add(f, p.x, p.y, a1); fe_add(f, q.x, q.y, a2);
  fe_mul(f, a1, a2, t3); emit_fe(f, t3, emit);
  fe_add(f, t0, t1, s); fe_sub(f, t3, s, t3);
  fe_add(f, p.y, p.z, a1); fe_add(f, q.y, q.z, a2);
  fe_mul(f, a1, a2, t4); emit_fe(f, t4, emit);
  fe_add(f, t1, t2, s); fe_sub(f, t4, s, t4);
  fe_add(f, p.x, p.z, a1); fe_add(f, q.x, q.z, a2);
  fe_mul(f, a1, a2, y3); emit_fe(f, y3, emit);  // "xz"
  fe_add(f, t0, t2, s); fe_sub(f, y3, s, y3);
  fe_add(f, t0, t0, x3); fe_add(f, x3, t0, x3);          // 3*t0
  fe_mul(f, b3, t2, t2b);
  fe_add(f, t1, t2b, z3);
  fe_sub(f, t1, t2b, t1n);
  fe_mul(f, b3, y3, y3b);
  fe_mul(f, t3, t1n, x3a); emit_fe(f, x3a, emit);
  fe_mul(f, t4, y3b, x3b); emit_fe(f, x3b, emit);
  fe_mul(f, t1n, z3, y3a); emit_fe(f, y3a, emit);
  fe_mul(f, y3b, x3, y3bm); emit_fe(f, y3bm, emit);
  fe_mul(f, z3, t4, z3a); emit_fe(f, z3a, emit);
  fe_mul(f, x3, t3, z3b); emit_fe(f, z3b, emit);
  fe_sub(f, x3a, x3b, out.x);
  fe_add(f, y3a, y3bm, out.y);
  fe_add(f, z3a, z3b, out.z);
}

// Complete double, emitting the 8 allocated products in gadget order
// (ec.py ProjPoint.double: t0,t1,zsq,x3,z3,y3,xy,x3f).
static void ppt_double_emit(const FieldCtx& f, const Fe& b3, const PPt& p,
                            PPt& out, u64*& emit) {
  Fe t0, t1, zsq, t2, x3, y3, z3, t1b, t0n, y3m, xy, x3f;
  fe_mul(f, p.y, p.y, t0); emit_fe(f, t0, emit);
  fe_add(f, t0, t0, z3); fe_add(f, z3, z3, z3); fe_add(f, z3, z3, z3);  // 8*t0
  fe_mul(f, p.y, p.z, t1); emit_fe(f, t1, emit);
  fe_mul(f, p.z, p.z, zsq); emit_fe(f, zsq, emit);
  fe_mul(f, b3, zsq, t2);
  fe_mul(f, t2, z3, x3); emit_fe(f, x3, emit);
  fe_add(f, t0, t2, y3);
  fe_mul(f, t1, z3, out.z); emit_fe(f, out.z, emit);  // "z3"
  fe_add(f, t2, t2, t1b); fe_add(f, t1b, t2, t1b);    // 3*t2
  fe_sub(f, t0, t1b, t0n);
  fe_mul(f, t0n, y3, y3m); emit_fe(f, y3m, emit);     // "y3"
  fe_add(f, y3m, x3, out.y);
  fe_mul(f, p.x, p.y, xy); emit_fe(f, xy, emit);
  fe_mul(f, xy, t0n, x3f); emit_fe(f, x3f, emit);
  fe_add(f, x3f, x3f, out.x);
}

static void fe_inv(const FieldCtx& f, const Fe& a, Fe& out) {
  // a^(p-2); p odd so p-2 has no borrow past limb 0.
  u64 e[4] = {f.p[0] - 2, f.p[1], f.p[2], f.p[3]};
  fe_pow(f, a, e, out);
}

// One scaled_add of the in-circuit NIFS fold (instance.py fold():
// term = pt.scalar_mul(r_bits); total = base + term; affine(total)),
// emitting every allocated witness value in gadget order:
//   per bit MSB-first: double(acc) 8 products, add(acc, pt) 12
//   products, select 3 coords; then final add 12 products; then
//   to_affine (inf, zinv, x, y).
static void ec_scaled_add_emit(const FieldCtx& f, const PPt& base,
                               const PPt& pt, const u64* r_bits_msb,
                               int n_bits, u64*& emit) {
  Fe b3raw = {{15, 0, 0, 0}}, b3;
  to_mont(f, b3raw, b3);
  PPt acc;
  std::memset(&acc, 0, sizeof(acc));
  std::memcpy(acc.y.v, f.one, 32);  // identity (0 : 1 : 0), Montgomery
  for (int j = 0; j < n_bits; ++j) {
    PPt dbl, added;
    ppt_double_emit(f, b3, acc, dbl, emit);
    ppt_add_emit(f, b3, dbl, pt, added, emit);
    const PPt& sel = r_bits_msb[j] ? added : dbl;
    emit_fe(f, sel.x, emit);
    emit_fe(f, sel.y, emit);
    emit_fe(f, sel.z, emit);
    acc = sel;
  }
  PPt total;
  ppt_add_emit(f, b3, base, acc, total, emit);
  // to_affine: inf bit, zinv, x, y (ec.py ProjPoint.to_affine order).
  Fe zc;
  from_mont(f, total.z, zc);
  bool inf = !(zc.v[0] | zc.v[1] | zc.v[2] | zc.v[3]);
  u64 infv[4] = {inf ? 1ULL : 0ULL, 0, 0, 0};
  std::memcpy(emit, infv, 32);
  emit += 4;
  Fe zinv = {{0, 0, 0, 0}}, ax = {{0, 0, 0, 0}}, ay = {{0, 0, 0, 0}};
  if (!inf) {
    fe_inv(f, total.z, zinv);
    fe_mul(f, total.x, zinv, ax);
    fe_mul(f, total.y, zinv, ay);
  }
  emit_fe(f, zinv, emit);
  emit_fe(f, ax, emit);
  emit_fe(f, ay, emit);
}

// EC fold-gadget witness values (see ec_scaled_add_emit above).
// base/pt: projective canonical (3*4 u64 each); r_bits_msb: n_bits u64
// of 0/1, MOST significant first; out: (n_bits*23 + 12 + 4) * 4 u64.
extern "C" void ec_fold_witness_native(int fq, const u64* base_proj,
                                       const u64* pt_proj,
                                       const u64* r_bits_msb, int n_bits,
                                       u64* out) {
  const FieldCtx& f = fq ? FQ_CTX : FP_CTX;
  PPt base, pt;
  std::memcpy(base.x.v, base_proj + 0, 32);
  std::memcpy(base.y.v, base_proj + 4, 32);
  std::memcpy(base.z.v, base_proj + 8, 32);
  std::memcpy(pt.x.v, pt_proj + 0, 32);
  std::memcpy(pt.y.v, pt_proj + 4, 32);
  std::memcpy(pt.z.v, pt_proj + 8, 32);
  to_mont(f, base.x, base.x); to_mont(f, base.y, base.y); to_mont(f, base.z, base.z);
  to_mont(f, pt.x, pt.x); to_mont(f, pt.y, pt.y); to_mont(f, pt.z, pt.z);
  u64* emit = out;
  ec_scaled_add_emit(f, base, pt, r_bits_msb, n_bits, emit);
}

// Poseidon permutation witness fast path (the host-int control plane's
// transcripts and the augmented circuit's value-only witness pass —
// poseidon/int_poseidon.py::permute_ints, nova/gadgets/sponge.py).
// Mirrors permute_ints round for round: half full rounds, r_p partial,
// full_rounds-half full; round constants added first, S-box x^5, MDS.
//
// state: width*4 u64 canonical, updated in place.
// rc: (full_rounds+r_p)*width*4 canonical.  mds: width*width*4 canonical.
// triples: if non-null, every S-box emits (x^2, x^4, x^5) canonical in
// gadget allocation order — (half*width + r_p + (full_rounds-half)*width)
// triples of 3*4 u64 (the in-circuit sponge's allocated values).
void poseidon_witness_native(int fq, int width, int half, int r_p,
                             int full_rounds, const u64* rc, const u64* mds,
                             u64* state, u64* triples) {
  const FieldCtx& f = fq ? FQ_CTX : FP_CTX;
  const int W = width;
  Fe s[16], rcm[16], m[256], tmp[16];
  for (int j = 0; j < W; ++j) {
    std::memcpy(s[j].v, state + 4 * j, 32);
    to_mont(f, s[j], s[j]);
  }
  for (int j = 0; j < W * W; ++j) {
    std::memcpy(m[j].v, mds + 4 * j, 32);
    to_mont(f, m[j], m[j]);
  }
  u64* tp = triples;
  int rnd = 0;
  auto add_rc = [&](int r) {
    for (int j = 0; j < W; ++j) {
      Fe c;
      std::memcpy(c.v, rc + 4 * (r * W + j), 32);
      to_mont(f, c, c);
      fe_add(f, s[j], c, s[j]);
    }
  };
  auto sbox = [&](Fe& x) {
    Fe x2, x4, x5;
    fe_sqr(f, x, x2);
    fe_sqr(f, x2, x4);
    fe_mul(f, x4, x, x5);
    if (tp) {
      Fe o;
      from_mont(f, x2, o); std::memcpy(tp, o.v, 32); tp += 4;
      from_mont(f, x4, o); std::memcpy(tp, o.v, 32); tp += 4;
      from_mont(f, x5, o); std::memcpy(tp, o.v, 32); tp += 4;
    }
    x = x5;
  };
  auto mds_mul = [&]() {
    for (int i = 0; i < W; ++i) {
      Fe acc = {{0, 0, 0, 0}};
      for (int j = 0; j < W; ++j) {
        Fe t;
        fe_mul(f, m[i * W + j], s[j], t);
        fe_add(f, acc, t, acc);
      }
      tmp[i] = acc;
    }
    for (int i = 0; i < W; ++i) s[i] = tmp[i];
  };
  for (int r = 0; r < half; ++r, ++rnd) {
    add_rc(rnd);
    for (int j = 0; j < W; ++j) sbox(s[j]);
    mds_mul();
  }
  for (int r = 0; r < r_p; ++r, ++rnd) {
    add_rc(rnd);
    sbox(s[0]);
    mds_mul();
  }
  for (int r = 0; r < full_rounds - half; ++r, ++rnd) {
    add_rc(rnd);
    for (int j = 0; j < W; ++j) sbox(s[j]);
    mds_mul();
  }
  for (int j = 0; j < W; ++j) {
    Fe o;
    from_mont(f, s[j], o);
    std::memcpy(state + 4 * j, o.v, 32);
  }
}

}  // extern "C"
