// Launchers of the fixed-base commit kernels K3-K7 (msm_kernels.cuh).

#include <cuda_runtime.h>

#include <cstdint>

#include "msm_kernels.cuh"

// ---------------------------------------------------------------------
// C interface (bound with ctypes by vdf_tpu_torch/_build.py).  Each
// launcher enqueues its kernel(s) on the given stream, does not
// synchronise, allocates nothing (scratch comes from the caller) and
// returns cudaGetLastError().  field: 0 = Fp, 1 = Fq.  Points are
// (..., 3, 8) u32 device buffers; see msm_kernels.cuh for each layout.
// ---------------------------------------------------------------------

namespace {

inline dim3 grid_of(int64_t threads, int block) {
  return dim3((unsigned)((threads + block - 1) / block));
}

inline bool bad_field(int field) { return field != 0 && field != 1; }

}  // namespace

extern "C" int vdf_canon_digits(int field, const void* scalars, void* keys, int64_t n,
                                int64_t count, int64_t m_pad, void* stream) {
  if (bad_field(field) || n <= 0 || count % n != 0 || m_pad < vdf::WINDOWS * n)
    return (int)cudaErrorInvalidValue;
  if (count == 0) return (int)cudaSuccess;
  auto kernel = field == 0 ? vdf::canon_digits_kernel<0> : vdf::canon_digits_kernel<1>;
  kernel<<<grid_of(count, vdf::CBLOCK), vdf::CBLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)scalars, (int64_t*)keys, n, count, m_pad);
  return (int)cudaGetLastError();
}

extern "C" int vdf_canon_mont(int field, const void* in, void* out, int64_t count,
                              void* stream) {
  if (bad_field(field)) return (int)cudaErrorInvalidValue;
  if (count <= 0) return (int)cudaSuccess;
  auto kernel = field == 0 ? vdf::canon_mont_kernel<0> : vdf::canon_mont_kernel<1>;
  kernel<<<grid_of(count, vdf::CBLOCK), vdf::CBLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, count);
  return (int)cudaGetLastError();
}

extern "C" int vdf_shift_gens(int field, const void* gens, void* table, int64_t n,
                              void* stream) {
  if (bad_field(field)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  auto kernel = field == 0 ? vdf::shift_gens_kernel<0> : vdf::shift_gens_kernel<1>;
  kernel<<<grid_of(n, vdf::PBLOCK), vdf::PBLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)gens, (uint32_t*)table, n);
  return (int)cudaGetLastError();
}

extern "C" int vdf_scan(int field, const void* table, const void* keys, void* tails,
                        void* tail_col, void* col_sums, void* col_flags, int64_t m_pad,
                        int64_t rows, int64_t cols, int64_t batch, void* stream) {
  if (bad_field(field) || rows <= 0 || cols <= 0 || m_pad != rows * cols)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  auto kernel = field == 0 ? vdf::scan_kernel<0> : vdf::scan_kernel<1>;
  kernel<<<grid_of(batch * cols, vdf::PBLOCK), vdf::PBLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const int64_t*)keys, (uint32_t*)tails, (int32_t*)tail_col,
      (uint32_t*)col_sums, (int32_t*)col_flags, m_pad, rows, cols, batch);
  return (int)cudaGetLastError();
}

// K5: ceil(log2 cols) Hillis-Steele levels ping-ponging between the two
// halves of the scratch buffers (the inputs are only read), then the shift
// into `carries`.  scratch_v holds 2 * batch * cols points, scratch_f
// 2 * batch * cols int32.
extern "C" int vdf_colscan(int field, const void* sums, const void* flags, void* scratch_v,
                           void* scratch_f, void* carries, int64_t cols, int64_t batch,
                           void* stream) {
  if (bad_field(field) || cols <= 0) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  const int64_t total = batch * cols;
  const dim3 grid = grid_of(total, vdf::PBLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  auto step = field == 0 ? vdf::colscan_step_kernel<0> : vdf::colscan_step_kernel<1>;
  auto shift = field == 0 ? vdf::carry_shift_kernel<0> : vdf::carry_shift_kernel<1>;
  const uint32_t* v_in = (const uint32_t*)sums;
  const int32_t* f_in = (const int32_t*)flags;
  int half = 0;
  for (int64_t d = 1; d < cols; d *= 2, half ^= 1) {
    uint32_t* v_out = (uint32_t*)scratch_v + half * total * vdf::PT;
    int32_t* f_out = (int32_t*)scratch_f + half * total;
    step<<<grid, vdf::PBLOCK, 0, s>>>(v_in, f_in, v_out, f_out, cols, total, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    v_in = v_out;
    f_in = f_out;
  }
  shift<<<grid, vdf::PBLOCK, 0, s>>>(v_in, (uint32_t*)carries, cols, total);
  return (int)cudaGetLastError();
}

// K6: the three levels; lvl1 holds batch * 256 * 2 points, lvl2
// batch * 16 * 3, out batch points.
extern "C" int vdf_bucket(int field, const void* tails, const void* tail_col,
                          const void* carries, void* lvl1, void* lvl2, void* out,
                          int64_t cols, int64_t batch, void* stream) {
  if (bad_field(field) || cols <= 0) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  auto level1 = field == 0 ? vdf::bucket_level1_kernel<0> : vdf::bucket_level1_kernel<1>;
  auto level2 = field == 0 ? vdf::bucket_level2_kernel<0> : vdf::bucket_level2_kernel<1>;
  auto final_ = field == 0 ? vdf::bucket_final_kernel<0> : vdf::bucket_final_kernel<1>;
  level1<<<grid_of(batch * (vdf::NB / vdf::RADIX), vdf::PBLOCK), vdf::PBLOCK, 0, s>>>(
      (const uint32_t*)tails, (const int32_t*)tail_col, (const uint32_t*)carries,
      (uint32_t*)lvl1, cols, batch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  level2<<<grid_of(batch * vdf::RADIX, vdf::PBLOCK), vdf::PBLOCK, 0, s>>>(
      (const uint32_t*)lvl1, (uint32_t*)lvl2, batch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  final_<<<grid_of(batch, vdf::PBLOCK), vdf::PBLOCK, 0, s>>>((const uint32_t*)lvl2,
                                                              (uint32_t*)out, batch);
  return (int)cudaGetLastError();
}
