// Launchers of the device plane's field kernels K10-K12 (field_ops.cuh).

#include <cuda_runtime.h>

#include <cstdint>

#include "field_ops.cuh"

// ---------------------------------------------------------------------
// C interface (bound with ctypes by vdf_tpu_torch/_build.py).  Each
// launcher enqueues one kernel on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError(); a malformed call
// returns cudaErrorInvalidValue and launches nothing.  field: 0 = Fp,
// 1 = Fq.  Elements are (n, 8) u32 device buffers, indices int64.
// ---------------------------------------------------------------------

namespace {

using EwFn = void (*)(const uint32_t*, const uint32_t*, const uint32_t*, uint32_t*, int64_t,
                      int);

template <int K>
EwFn ew_kernel(int op) {
  switch (op) {
    case vdf::OP_ADD: return vdf::field_ew_kernel<K, vdf::OP_ADD>;
    case vdf::OP_SUB: return vdf::field_ew_kernel<K, vdf::OP_SUB>;
    case vdf::OP_MUL: return vdf::field_ew_kernel<K, vdf::OP_MUL>;
    case vdf::OP_SQR: return vdf::field_ew_kernel<K, vdf::OP_SQR>;
    case vdf::OP_NEG: return vdf::field_ew_kernel<K, vdf::OP_NEG>;
    case vdf::OP_CANON: return vdf::field_ew_kernel<K, vdf::OP_CANON>;
    default: return vdf::field_ew_kernel<K, vdf::OP_FOLD>;
  }
}

inline bool bad_field(int field) { return field != 0 && field != 1; }

inline dim3 grid_of(int64_t threads, int block) {
  return dim3((unsigned)((threads + block - 1) / block));
}

}  // namespace

// K10: out = op(a, b, c) over n elements; bit k of bcast: operand k is one
// element (stride 0).  b and c may be null where op reads fewer operands.
extern "C" int vdf_field_ew(int field, int op, const void* a, const void* b, const void* c,
                            void* out, int64_t n, int bcast, void* stream) {
  if (bad_field(field) || op < 0 || op >= vdf::N_FIELD_OPS || n < 0 || bcast < 0 ||
      bcast > 7)
    return (int)cudaErrorInvalidValue;
  const int operands = vdf::ew_operands(op);
  if (!a || !out || (operands >= 2 && !b) || (operands >= 3 && !c))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const EwFn kernel = field == 0 ? ew_kernel<0>(op) : ew_kernel<1>(op);
  kernel<<<grid_of(n, vdf::EW_BLOCK), vdf::EW_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (const uint32_t*)c, (uint32_t*)out, n, bcast);
  return (int)cudaGetLastError();
}

// K11: out[s] = the field sum of segment s of x, for s < segments; segments
// from offsets (segments + 1 int64 entries) or, with offsets null, runs of
// seg_len elements.
extern "C" int vdf_field_segsum(int field, const void* x, const void* offsets, void* out,
                                int64_t segments, int64_t seg_len, void* stream) {
  if (bad_field(field) || segments < 0 || seg_len < 0 || !out ||
      (!offsets && seg_len > 0 && !x))
    return (int)cudaErrorInvalidValue;
  if (segments == 0) return (int)cudaSuccess;
  auto kernel = field == 0 ? vdf::field_segsum_kernel<0> : vdf::field_segsum_kernel<1>;
  kernel<<<grid_of(segments, vdf::SEG_WARPS), vdf::SEG_WARPS * vdf::WARP, 0,
           (cudaStream_t)stream>>>((const uint32_t*)x, (const int64_t*)offsets, (uint32_t*)out,
                                   segments, seg_len);
  return (int)cudaGetLastError();
}

// K12: out = M z for a row-sorted COO (offsets: rows + 1 int64 CSR offsets
// into cols and vals).
extern "C" int vdf_r1cs_matvec(int field, const void* offsets, const void* cols,
                               const void* vals, const void* z, void* out, int64_t rows,
                               void* stream) {
  if (bad_field(field) || rows < 0 || !offsets || !out) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  auto kernel = field == 0 ? vdf::r1cs_matvec_kernel<0> : vdf::r1cs_matvec_kernel<1>;
  kernel<<<grid_of(rows, vdf::SEG_WARPS), vdf::SEG_WARPS * vdf::WARP, 0,
           (cudaStream_t)stream>>>((const int64_t*)offsets, (const int64_t*)cols,
                                   (const uint32_t*)vals, (const uint32_t*)z, (uint32_t*)out,
                                   rows);
  return (int)cudaGetLastError();
}
