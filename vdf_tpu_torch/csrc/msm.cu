// Launchers of the bucket-accumulation kernels K3-K7 and K9 (msm_kernels.cuh).

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

inline bool bad_key_bits(int key_bits) { return key_bits != 32 && key_bits != 64; }

}  // namespace

// K3 mode 0: key_bits 32 (int32 keys; a row's items, W n or n, at most
// KEY32_ITEMS) or 64 (int64 keys).  Writes every key of the batch * (W or 1)
// rows of m_pad, the padding included.
extern "C" int vdf_canon_digits(int field, const void* scalars, void* keys, int64_t n,
                                int64_t count, int64_t m_pad, int window_rows, int key_bits,
                                void* stream) {
  const int64_t span = window_rows ? n : vdf::WINDOWS * n;  // items a key row
  if (bad_field(field) || bad_key_bits(key_bits) || n <= 0 || count % n != 0 ||
      m_pad < span || (key_bits == 32 && span > vdf::KEY32_ITEMS))
    return (int)cudaErrorInvalidValue;
  if (count == 0) return (int)cudaSuccess;
  const int64_t pads = count / n * (window_rows ? vdf::WINDOWS : 1) * (m_pad - span);
  auto kernel = field == 0 ? vdf::canon_digits_kernel<0> : vdf::canon_digits_kernel<1>;
  kernel<<<grid_of(count > pads ? count : pads, vdf::CBLOCK), vdf::CBLOCK, 0,
           (cudaStream_t)stream>>>((const uint32_t*)scalars, keys, n, count, m_pad,
                                   window_rows, key_bits);
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

// K7 in one of its two forms (msm_kernels.cuh): form 0, one thread a
// generator, or form 1, one group of GROUP threads a generator.
extern "C" int vdf_shift_gens(int field, const void* gens, void* table, int64_t n, int form,
                              void* stream) {
  if (bad_field(field) || (form != 0 && form != 1)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (form == 0) {
    auto kernel = field == 0 ? vdf::shift_gens_kernel<0> : vdf::shift_gens_kernel<1>;
    kernel<<<grid_of(n, vdf::PBLOCK), vdf::PBLOCK, 0, s>>>((const uint32_t*)gens,
                                                          (uint32_t*)table, n);
  } else {
    auto kernel =
        field == 0 ? vdf::shift_gens_group_kernel<0> : vdf::shift_gens_group_kernel<1>;
    kernel<<<grid_of(n, vdf::SHIFT_GROUPS), vdf::PBLOCK, 0, s>>>((const uint32_t*)gens,
                                                                (uint32_t*)table, n);
  }
  return (int)cudaGetLastError();
}

// K4 in one of its two forms (msm_kernels.cuh): form 0, one thread a column,
// or form 1, one group of GROUP threads a column (rows up to SCAN_MAX_ROWS),
// on keys of key_bits 32 or 64 (K3's two widths).
extern "C" int vdf_scan(int field, const void* table, const void* keys, void* tails,
                        void* tail_col, void* col_sums, void* col_flags, int64_t m_pad,
                        int64_t rows, int64_t cols, int64_t batch, int form, int key_bits,
                        void* stream) {
  if (bad_field(field) || bad_key_bits(key_bits) || rows <= 0 || cols <= 0 ||
      m_pad != rows * cols || !(form == 0 || (form == 1 && rows <= vdf::SCAN_MAX_ROWS)))
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (form == 0) {
    auto kernel = field == 0 ? vdf::scan_kernel<0> : vdf::scan_kernel<1>;
    kernel<<<grid_of(batch * cols, vdf::PBLOCK), vdf::PBLOCK, 0, s>>>(
        (const uint32_t*)table, keys, (uint32_t*)tails, (int32_t*)tail_col,
        (uint32_t*)col_sums, (int32_t*)col_flags, rows, cols, batch, key_bits);
  } else {
    auto kernel = field == 0 ? vdf::scan_group_kernel<0> : vdf::scan_group_kernel<1>;
    kernel<<<grid_of(batch * cols, vdf::SCAN_GROUPS), vdf::PBLOCK,
             (size_t)vdf::scan_group_shared_bytes(rows), s>>>(
        (const uint32_t*)table, keys, (uint32_t*)tails, (int32_t*)tail_col,
        (uint32_t*)col_sums, (int32_t*)col_flags, rows, cols, batch, key_bits);
  }
  return (int)cudaGetLastError();
}

// K5: the three passes of the blocked scan.  per_thread is L, the columns a
// thread owns: the caller derives it from cols and sizes the scratch by it
// (tiles = ceil(cols / (PBLOCK L)) a batch row): thread_v batch * tiles *
// PBLOCK points, thread_f as many int32, tile_incl batch * tiles points.
extern "C" int vdf_colscan(int field, const void* sums, const void* flags, void* thread_v,
                           void* thread_f, void* tile_incl, void* carries, int64_t cols,
                           int64_t batch, int per_thread, void* stream) {
  if (bad_field(field) || cols <= 0 || per_thread <= 0) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  const int64_t span = (int64_t)vdf::PBLOCK * per_thread;
  const int64_t tiles = (cols + span - 1) / span;
  const int64_t staged = vdf::stage_pieces(per_thread) * (int64_t)sizeof(vdf::U4);
  const int shared =
      (int)(staged > vdf::COLSCAN_SCAN_BYTES ? staged : vdf::COLSCAN_SCAN_BYTES);
  cudaStream_t s = (cudaStream_t)stream;
  auto tile = field == 0 ? vdf::colscan_tile_kernel<0> : vdf::colscan_tile_kernel<1>;
  auto rows = field == 0 ? vdf::colscan_rows_kernel<0> : vdf::colscan_rows_kernel<1>;
  auto carry = field == 0 ? vdf::colscan_carry_kernel<0> : vdf::colscan_carry_kernel<1>;
  cudaError_t err =
      cudaFuncSetAttribute(tile, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(carry, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(batch * tiles));
  tile<<<grid, vdf::PBLOCK, shared, s>>>((const uint32_t*)sums, (const int32_t*)flags,
                                         (uint32_t*)thread_v, (int32_t*)thread_f, cols, tiles,
                                         per_thread);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rows<<<dim3((unsigned)batch), vdf::PBLOCK, 0, s>>>(
      (const uint32_t*)thread_v, (const int32_t*)thread_f, (uint32_t*)tile_incl, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry<<<grid, vdf::PBLOCK, shared, s>>>(
      (const uint32_t*)sums, (const int32_t*)flags, (const uint32_t*)thread_v,
      (const int32_t*)thread_f, (const uint32_t*)tile_incl, (uint32_t*)carries, cols, tiles,
      per_thread);
  return (int)cudaGetLastError();
}

// K6: the halving steps of each chunk of 2^chunk_bits buckets with a block
// of `threads` a chunk, then the steps across chunks and the Horner with a
// block a batch row.  scratch holds batch * BUCKET_SCRATCH points.
extern "C" int vdf_bucket(int field, const void* tails, const void* tail_col,
                          const void* carries, void* scratch, void* out, int64_t cols,
                          int64_t batch, int chunk_bits, int threads, void* stream) {
  if (bad_field(field) || cols <= 0 || chunk_bits < 1 || chunk_bits > vdf::WINDOW_BITS ||
      threads < 1 || threads > vdf::BUCKET_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  auto tree = field == 0 ? vdf::bucket_tree_kernel<0> : vdf::bucket_tree_kernel<1>;
  auto finish = field == 0 ? vdf::bucket_finish_kernel<0> : vdf::bucket_finish_kernel<1>;
  tree<<<dim3((unsigned)(batch * (vdf::NB >> chunk_bits))), threads, 0, s>>>(
      (const uint32_t*)tails, (const int32_t*)tail_col, (const uint32_t*)carries,
      (uint32_t*)scratch, cols, chunk_bits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish<<<dim3((unsigned)batch), vdf::FINISH_THREADS, 0, s>>>((uint32_t*)scratch,
                                                               (uint32_t*)out, chunk_bits);
  return (int)cudaGetLastError();
}

// K9: one group of GROUP threads a batch row of W window sums, HORNER_GROUPS
// groups a block.
extern "C" int vdf_horner(int field, const void* sums, void* out, int64_t batch, void* stream) {
  if (bad_field(field)) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  constexpr int block = vdf::HORNER_GROUPS * vdf::GROUP;
  auto kernel = field == 0 ? vdf::horner_kernel<0> : vdf::horner_kernel<1>;
  kernel<<<grid_of(batch, vdf::HORNER_GROUPS), block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)sums, (uint32_t*)out, batch);
  return (int)cudaGetLastError();
}
