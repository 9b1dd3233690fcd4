// Launchers of the MinRoot kernels K1/K2 (minroot_kernels.cuh).

#include <cuda_runtime.h>

#include <cstdint>

#include "minroot_kernels.cuh"


// ---------------------------------------------------------------------
// C interface (bound with ctypes by vdf_tpu_torch/_build.py).  Each
// launcher enqueues one kernel on the given stream, does not
// synchronise, allocates nothing and returns cudaGetLastError().
// field: 0 = Fp, 1 = Fq.  Pointers are (lanes, 8) u32 device buffers.
// ---------------------------------------------------------------------

namespace {

using KernelFn = void (*)(const uint32_t*, const uint32_t*, const uint32_t*,
                          uint32_t*, uint32_t*, uint32_t*, int64_t, int64_t);

int launch(KernelFn fp, KernelFn fq, int field, const void* x, const void* y,
           const void* i, void* ox, void* oy, void* oi, int64_t lanes, int64_t t,
           void* stream) {
  if (field != 0 && field != 1) return (int)cudaErrorInvalidValue;
  if (lanes <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((lanes + vdf::BLOCK - 1) / vdf::BLOCK));
  const KernelFn kernel = field == 0 ? fp : fq;
  kernel<<<grid, vdf::BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)i, (uint32_t*)ox,
      (uint32_t*)oy, (uint32_t*)oi, lanes, t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vdf_minroot_eval(int field, const void* x, const void* y,
                                const void* i, void* ox, void* oy, void* oi,
                                int64_t lanes, int64_t t, void* stream) {
  return launch(vdf::minroot_eval_kernel<0>, vdf::minroot_eval_kernel<1>, field, x,
                y, i, ox, oy, oi, lanes, t, stream);
}

extern "C" int vdf_minroot_inverse(int field, const void* x, const void* y,
                                   const void* i, void* ox, void* oy, void* oi,
                                   int64_t lanes, int64_t t, void* stream) {
  return launch(vdf::minroot_inverse_kernel<0>, vdf::minroot_inverse_kernel<1>,
                field, x, y, i, ox, oy, oi, lanes, t, stream);
}

extern "C" const char* vdf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
