"""The CUDA kernel bodies K3-K7, compiled as host C++ and run on the CPU.

``csrc/msm_kernels.cuh`` and ``csrc/curve.cuh`` use no CUDA intrinsic, so
with the CUDA qualifiers defined away and ``threadIdx``/``blockIdx``
emulated, g++ compiles the very source nvcc builds for the card.  Each
grid runs thread by thread; K5 and K6 are sequenced level by level as
``csrc/msm.cu`` launches them.  Every output must equal the plain version
(curves/kernels.py) bit for bit.  Launch, stream and the sm_90a build are
checked on the card (tests/test_torch_build.py -m gpu, chip_smoke.py).
"""

import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from vdf_tpu_torch import _build
from vdf_tpu_torch.curves import CURVES, get_curve, hash_to_curve_ints, stack_point
from vdf_tpu_torch.curves import kernels as K
from vdf_tpu_torch.curves.bucket_msm import layout

# The plain versions are many small tensor ops: one intra-op thread runs
# them fastest, and test workers sharing the cores do not oversubscribe
# them (with a thread pool per worker they ran ~10x slower under load).
torch.set_num_threads(1)

HOST_SHIM = r"""
#include <cstdint>
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __global__
#define __constant__
#define __restrict__
#define __launch_bounds__(n)
#define __shared__ static
struct HostDim { unsigned x; };
static HostDim threadIdx, blockIdx;
#include "msm_kernels.cuh"

using namespace vdf;

template <class Body>
static void grid(int64_t threads, int block, Body body) {
  for (int64_t b = 0; b * block < threads; ++b) {
    for (int th = 0; th < block; ++th) {
      blockIdx.x = (unsigned)b;
      threadIdx.x = (unsigned)th;
      body();
    }
  }
}

extern "C" void host_canon_digits(int f, const uint32_t* s, int64_t* keys, int64_t n,
                                  int64_t count, int64_t m_pad) {
  grid(count, CBLOCK, [&] {
    (f ? canon_digits_kernel<1> : canon_digits_kernel<0>)(s, keys, n, count, m_pad);
  });
}

extern "C" void host_canon_mont(int f, const uint32_t* in, uint32_t* out, int64_t count) {
  grid(count, CBLOCK, [&] { (f ? canon_mont_kernel<1> : canon_mont_kernel<0>)(in, out, count); });
}

extern "C" void host_shift_gens(int f, const uint32_t* gens, uint32_t* table, int64_t n) {
  grid(n, PBLOCK, [&] { (f ? shift_gens_kernel<1> : shift_gens_kernel<0>)(gens, table, n); });
}

extern "C" void host_scan(int f, const uint32_t* table, const int64_t* keys, uint32_t* tails,
                          int32_t* tail_col, uint32_t* sums, int32_t* flags, int64_t m_pad,
                          int64_t rows, int64_t cols, int64_t batch) {
  grid(batch * cols, PBLOCK, [&] {
    (f ? scan_kernel<1> : scan_kernel<0>)(table, keys, tails, tail_col, sums, flags, m_pad,
                                          rows, cols, batch);
  });
}

// As vdf_colscan in msm.cu: levels ping-ponging through scratch, then the shift.
extern "C" void host_colscan(int f, const uint32_t* sums, const int32_t* flags,
                             uint32_t* scratch_v, int32_t* scratch_f, uint32_t* carries,
                             int64_t cols, int64_t batch) {
  const int64_t total = batch * cols;
  const uint32_t* v_in = sums;
  const int32_t* f_in = flags;
  int half = 0;
  for (int64_t d = 1; d < cols; d *= 2, half ^= 1) {
    uint32_t* v_out = scratch_v + half * total * PT;
    int32_t* f_out = scratch_f + half * total;
    grid(total, PBLOCK, [&] {
      (f ? colscan_step_kernel<1> : colscan_step_kernel<0>)(v_in, f_in, v_out, f_out, cols,
                                                            total, d);
    });
    v_in = v_out;
    f_in = f_out;
  }
  grid(total, PBLOCK, [&] {
    (f ? carry_shift_kernel<1> : carry_shift_kernel<0>)(v_in, carries, cols, total);
  });
}

// As vdf_bucket in msm.cu: the three levels.
extern "C" void host_bucket(int f, const uint32_t* tails, const int32_t* tail_col,
                            const uint32_t* carries, uint32_t* lvl1, uint32_t* lvl2,
                            uint32_t* out, int64_t cols, int64_t batch) {
  grid(batch * (NB / RADIX), PBLOCK, [&] {
    (f ? bucket_level1_kernel<1> : bucket_level1_kernel<0>)(tails, tail_col, carries, lvl1,
                                                            cols, batch);
  });
  grid(batch * RADIX, PBLOCK, [&] {
    (f ? bucket_level2_kernel<1> : bucket_level2_kernel<0>)(lvl1, lvl2, batch);
  });
  grid(batch, PBLOCK, [&] {
    (f ? bucket_final_kernel<1> : bucket_final_kernel<0>)(lvl2, out, batch);
  });
}
"""


class HostKernels:
    """The kernel bodies on numpy buffers; outputs as torch tensors."""

    def __init__(self, lib):
        self.lib = lib

    @staticmethod
    def _p(a):
        return ctypes.c_void_p(a.ctypes.data)

    def canon_digits(self, field, scalars, m_pad):
        s = np.ascontiguousarray(scalars.numpy())
        k, n = s.shape[:2]
        keys = np.zeros((k, m_pad), dtype=np.int64)
        self.lib.host_canon_digits(_build.FIELD_INDEX[field], self._p(s), self._p(keys),
                                   ctypes.c_int64(n), ctypes.c_int64(k * n),
                                   ctypes.c_int64(m_pad))
        return torch.from_numpy(keys)

    def canon_mont(self, field, values):
        v = np.ascontiguousarray(values.numpy())
        out = np.empty_like(v)
        self.lib.host_canon_mont(_build.FIELD_INDEX[field], self._p(v), self._p(out),
                                 ctypes.c_int64(v.shape[0]))
        return torch.from_numpy(out)

    def shift_gens(self, field, gens):
        g = np.ascontiguousarray(gens.numpy())
        table = np.empty((K.WINDOWS * g.shape[0], 3, 8), dtype=np.int32)
        self.lib.host_shift_gens(_build.FIELD_INDEX[field], self._p(g), self._p(table),
                                 ctypes.c_int64(g.shape[0]))
        return torch.from_numpy(table)

    def bucket_scan(self, field, table, keys, rows):
        t, kk = np.ascontiguousarray(table.numpy()), np.ascontiguousarray(keys.numpy())
        k, m_pad = kk.shape
        cols = m_pad // rows
        tails = K._identity_rows(field, (k, K.NB), "cpu").numpy().copy()
        tail_col = np.full((k, K.NB), -1, dtype=np.int32)
        sums = np.empty((k, cols, 3, 8), dtype=np.int32)
        flags = np.empty((k, cols), dtype=np.int32)
        self.lib.host_scan(_build.FIELD_INDEX[field], self._p(t), self._p(kk),
                           self._p(tails), self._p(tail_col), self._p(sums), self._p(flags),
                           ctypes.c_int64(m_pad), ctypes.c_int64(rows), ctypes.c_int64(cols),
                           ctypes.c_int64(k))
        return tuple(map(torch.from_numpy, (tails, tail_col, sums, flags)))

    def column_carries(self, field, sums, flags):
        s, f = np.ascontiguousarray(sums.numpy()), np.ascontiguousarray(flags.numpy())
        k, cols = f.shape
        sv = np.empty((2, k, cols, 3, 8), dtype=np.int32)
        sf = np.empty((2, k, cols), dtype=np.int32)
        carries = np.empty_like(s)
        self.lib.host_colscan(_build.FIELD_INDEX[field], self._p(s), self._p(f), self._p(sv),
                              self._p(sf), self._p(carries), ctypes.c_int64(cols),
                              ctypes.c_int64(k))
        return torch.from_numpy(carries)

    def bucket_sums(self, field, tails, tail_col, carries):
        t = np.ascontiguousarray(tails.numpy())
        tc = np.ascontiguousarray(tail_col.numpy())
        c = np.ascontiguousarray(carries.numpy())
        k, cols = c.shape[:2]
        lvl1 = np.empty((k, K.NB // K.RADIX, 2, 3, 8), dtype=np.int32)
        lvl2 = np.empty((k, K.RADIX, 3, 3, 8), dtype=np.int32)
        out = np.empty((k, 3, 8), dtype=np.int32)
        self.lib.host_bucket(_build.FIELD_INDEX[field], self._p(t), self._p(tc), self._p(c),
                             self._p(lvl1), self._p(lvl2), self._p(out), ctypes.c_int64(cols),
                             ctypes.c_int64(k))
        return torch.from_numpy(out)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel bodies as host code")
    d = tmp_path_factory.mktemp("host_msm_kernels")
    (d / _build.CONSTS_HEADER).write_text(_build.constants_header())
    (d / "shim.cpp").write_text(HOST_SHIM)
    so = d / "libhost_msm.so"
    proc = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Wno-unknown-pragmas",
         "-I", str(_build.CSRC_DIR), "-I", str(d), "-o", str(so), str(d / "shim.cpp")],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr
    return HostKernels(ctypes.CDLL(str(so)))


def _scalars(curve_name: str, k: int, n: int, seed: int) -> torch.Tensor:
    """(k, n, 8) Montgomery scalars: random, with 0, 1, q - 1 and a
    repeated value (equal digits give runs that cross columns)."""
    c = get_curve(curve_name)
    q = c.scalar.params.modulus
    rng = random.Random(seed)
    vals = [rng.randrange(q) for _ in range(k * n)]
    vals[:4] = [0, 1, q - 1, vals[4]]
    return c.scalar.encode(vals).reshape(k, n, 8)


@pytest.mark.parametrize("curve_name", ["pallas", "vesta"])
def test_commit_kernel_bodies_match_plain(host, curve_name):
    """K3 (both modes), K7, K4, K5 and K6 bodies == plain, on a K = 2
    batch of n = 6 over the real generators; rows = 5 leaves a padded,
    ragged last column."""
    params = CURVES[curve_name]
    bf, sf = params.base_field, params.scalar_field
    n, k, rows = 6, 2, 5
    pts = hash_to_curve_ints(curve_name, n, domain=b"vdf_tpu/t")
    ints = torch.from_numpy(np.frombuffer(
        b"".join(v.to_bytes(32, "little") for pt in pts for v in pt), dtype="<u4"
    ).view(np.int32).copy()).reshape(-1, 8)
    ints[0] = -1  # an all-ones limb pattern (2^256 - 1 > p) is reduced too
    mont = host.canon_mont(bf, ints)
    assert torch.equal(mont, K.canon_mont_plain(bf, ints))
    gens = stack_point(get_curve(curve_name).from_affine_ints(pts)).contiguous()
    table = host.shift_gens(bf, gens)
    assert torch.equal(table, K.shift_gens_plain(bf, gens))

    s = _scalars(curve_name, k, n, seed=3)
    s[1, 5] = -1  # all-ones limbs: reduced mod q on load
    _, m_pad = layout(n, rows)
    keys = host.canon_digits(sf, s, m_pad)
    assert torch.equal(keys, K.canon_digits_plain(sf, s, m_pad))
    keys = torch.sort(keys, dim=-1).values
    got = host.bucket_scan(bf, table, keys, rows)
    want = K.bucket_scan_plain(bf, table, keys, rows)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    tails, tail_col, sums, flags = want
    assert (tail_col >= 0).any()  # some run's head lies in an earlier column
    carries = host.column_carries(bf, sums, flags)
    assert torch.equal(carries, K.column_carries_plain(bf, sums, flags))
    out = host.bucket_sums(bf, tails, tail_col, carries)
    assert torch.equal(out, K.bucket_sums_plain(bf, tails, tail_col, carries))
