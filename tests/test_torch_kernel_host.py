"""The CUDA kernel bodies K1/K2, compiled as host C++ and run on the CPU.

``csrc/minroot_kernels.cuh`` uses no CUDA intrinsic, so with the CUDA
qualifiers defined away and ``threadIdx``/``blockIdx`` emulated, g++
compiles the very source nvcc builds for the card.  Running each thread
of each block in turn (threads share nothing but their own column of
the shared power table) gives the kernel's result on every lane, which
must equal the plain versions and Python-int MinRoot exactly.  This
checks the kernels' arithmetic here; launch, stream and the sm_90a build
are checked on the card (tests/test_torch_build.py -m gpu, chip_smoke.py).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from vdf_tpu_torch import _build
from vdf_tpu_torch.fields import FIELDS, get_field
from vdf_tpu_torch.fields.kernels import minroot_eval_plain, minroot_inverse_plain

# The plain versions are many small tensor ops: one intra-op thread runs
# them fastest, and test workers sharing the cores do not oversubscribe
# them (with a thread pool per worker they ran ~10x slower under load).
torch.set_num_threads(1)

HOST_SHIM = r"""
#include <cstdint>
#define __device__
#define __forceinline__ inline
#define __global__
#define __constant__
#define __restrict__
#define __launch_bounds__(n)
#define __shared__ static
struct HostDim { unsigned x; };
static HostDim threadIdx, blockIdx;
#include "minroot_kernels.cuh"

using Kernel = void (*)(const uint32_t*, const uint32_t*, const uint32_t*,
                        uint32_t*, uint32_t*, uint32_t*, int64_t, int64_t);

extern "C" void run(int field, int inverse, const uint32_t* x, const uint32_t* y,
                    const uint32_t* i, uint32_t* ox, uint32_t* oy, uint32_t* oi,
                    int64_t lanes, int64_t t) {
  const Kernel kernels[2][2] = {
      {vdf::minroot_eval_kernel<0>, vdf::minroot_eval_kernel<1>},
      {vdf::minroot_inverse_kernel<0>, vdf::minroot_inverse_kernel<1>}};
  const int64_t blocks = (lanes + vdf::BLOCK - 1) / vdf::BLOCK;
  for (int64_t b = 0; b < blocks; ++b) {
    for (int th = 0; th < vdf::BLOCK; ++th) {
      blockIdx.x = (unsigned)b;
      threadIdx.x = (unsigned)th;
      kernels[inverse][field](x, y, i, ox, oy, oi, lanes, t);
    }
  }
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel bodies as host code")
    d = tmp_path_factory.mktemp("host_kernels")
    (d / _build.CONSTS_HEADER).write_text(_build.constants_header())
    (d / "shim.cpp").write_text(HOST_SHIM)
    so = d / "libhost_kernels.so"
    proc = subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Wno-unknown-pragmas",
         "-I", str(_build.CSRC_DIR), "-I", str(d), "-o", str(so), str(d / "shim.cpp")],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.run.argtypes = [ctypes.c_int, ctypes.c_int, vp, vp, vp, vp, vp, vp,
                        ctypes.c_int64, ctypes.c_int64]
    lib.run.restype = None

    def run(field_name, inverse, x, y, i, t):
        ins = [np.ascontiguousarray(a.numpy()) for a in (x, y, i)]
        outs = [np.empty_like(a) for a in ins]
        lib.run(_build.FIELD_INDEX[field_name], int(inverse),
                *(a.ctypes.data for a in ins + outs), ins[0].shape[0], t)
        return tuple(torch.from_numpy(a) for a in outs)

    return run


def seeded_state(name: str, lanes: int, seed: int):
    p = FIELDS[name].modulus
    nrng = np.random.default_rng(seed)
    f = get_field(name)
    vals = [[int(v) % p for v in nrng.integers(0, 1 << 63, size=lanes)] for _ in range(3)]
    vals[0][:4] = [0, 1, p - 1, (1 << 256) % p]
    return vals, tuple(f.encode(v, device="cpu") for v in vals)


@pytest.mark.parametrize("name", ["Fp", "Fq"])
def test_kernel_bodies_match_plain_and_ints(host_kernels, name):
    """70 lanes (one full block and a ragged one) at t=2."""
    p, e = FIELDS[name].modulus, FIELDS[name].inv_alpha
    vals, s = seeded_state(name, 70, seed=8)
    t = 2
    fwd = host_kernels(name, False, *s, t)
    assert all(torch.equal(a, b) for a, b in zip(fwd, minroot_eval_plain(name, *s, t)))
    f = get_field(name)
    for lane in (0, 2, 69):
        x, y, i = (v[lane] for v in vals)
        for _ in range(t):
            x, y, i = pow((x + y) % p, e, p), (x + i) % p, (i + 1) % p
        assert tuple(f.decode(a[lane]) for a in fwd) == (x, y, i)
    back = host_kernels(name, True, *fwd, t)
    assert all(torch.equal(a, b) for a, b in zip(back, minroot_inverse_plain(name, *fwd, t)))
    assert all(torch.equal(a, b) for a, b in zip(back, s))


@pytest.mark.parametrize("inverse", [False, True], ids=["eval", "inverse"])
def test_kernel_bodies_canonicalise_any_limbs(host_kernels, inverse):
    """All-ones limbs (2^256 - 1 > p) are reduced on load, as in plain."""
    ones = torch.full((3, 8), -1, dtype=torch.int32)
    plain = minroot_inverse_plain if inverse else minroot_eval_plain
    got = host_kernels("Fq", inverse, ones, ones, ones, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, plain("Fq", ones, ones, ones, 1)))
