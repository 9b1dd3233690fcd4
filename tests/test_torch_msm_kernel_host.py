"""The CUDA kernel bodies K3-K7 and K9, compiled as host C++ and run on the CPU.

With the CUDA qualifiers defined away and ``threadIdx``/``blockIdx``
emulated, g++ compiles the very source nvcc builds for the card
(``csrc/msm_kernels.cuh``, ``csrc/curve.cuh``).  K3 and the thread forms of
K7 and K4 use no CUDA intrinsic: each grid runs thread by thread.  K5 and K6
synchronise inside a block, and the group forms of K7 and K4 and K9 inside a
group of 8 threads, so the source gives what a thread does between two barriers as
``__device__`` functions on explicit buffers; the shim below calls them as
``csrc/msm.cu``'s kernels do, pass after pass, level after level, thread
(or lane) after thread (the barriers, the vote and the copies through shared
memory are the card's).  Every output must equal the plain version
(curves/kernels.py) bit for bit, also at the shapes that stress K5's tiles
and K6's inputs; and the plain K5 and K6 equal oracles that share nothing of
their schedule.  Launch, stream, the races between blocks and the sm_90a
build are checked on the card (tests/test_torch_build.py -m gpu,
chip_smoke.py).
"""

import ctypes
import functools
import itertools
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from vdf_tpu_torch import _build
from vdf_tpu_torch.curves import (
    CURVES,
    get_curve,
    get_int_curve,
    hash_to_curve_ints,
    stack_point,
)
from vdf_tpu_torch.curves import kernels as K
from vdf_tpu_torch.curves.bucket_msm import layout
from vdf_tpu_torch.curves.point import add16, double16, point_from_digits, point_to_digits
from vdf_tpu_torch.fields import FIELDS
from vdf_tpu_torch.fields.params import int_to_limbs

# The plain versions are many small tensor ops: one intra-op thread runs
# them fastest, and test workers sharing the cores do not oversubscribe
# them (with a thread pool per worker they ran ~10x slower under load).
torch.set_num_threads(1)

HOST_SHIM = r"""
#include <cstdint>
#include <vector>
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

// K3 mode 0 as vdf_canon_digits launches it: the grid covers the scalars and
// the padding positions, whichever are more.
extern "C" void host_canon_digits(int f, const uint32_t* s, void* keys, int64_t n,
                                  int64_t count, int64_t m_pad, int window_rows, int key_bits) {
  const int64_t span = window_rows ? n : WINDOWS * n;
  const int64_t pads = count / n * (window_rows ? WINDOWS : 1) * (m_pad - span);
  grid(count > pads ? count : pads, CBLOCK, [&] {
    (f ? canon_digits_kernel<1> : canon_digits_kernel<0>)(s, keys, n, count, m_pad,
                                                          window_rows, key_bits);
  });
}

// The lanes of a group, one after another at each step (the card runs them
// at once, GroupLanes in msm_kernels.cuh); `reverse` runs them from the last
// down, which must give the same bits: no lane reads what another lane
// writes in the same step.
struct SerialLanes {
  bool reverse = false;
  U4 pre_[GROUP];
  template <class F>
  void each(F f) {
    for (int i = 0; i < GROUP; ++i) f(reverse ? GROUP - 1 - i : i);
  }
  void sync() {}
  U4& pre(int lane) { return pre_[lane]; }
  template <int K>
  void add(uint32_t* buf) {
    for (int i = 0; i < GROUP_STEPS; ++i)
      each([&](int lane) { group_step<K>(buf, group_add_step(i), lane); });
  }
  template <int K>
  void dbl(uint32_t* buf) {
    for (int i = 0; i < GROUP_STEPS; ++i)
      each([&](int lane) { group_step<K>(buf, group_dbl_step(i), lane); });
  }
};

// One add (op 0) or doubling (op 1) on the buffer of a group whose unused
// slots hold a pattern nobody may read (grouped), or on one thread
// (point_add, point_double; op 2: point_double_lazy, its result reduced
// with canon); points as (3, 8) words.
template <int K>
static void point_op_host(const uint32_t* p, const uint32_t* q, uint32_t* r, int op, int grouped,
                          int reverse) {
  if (grouped) {
    std::vector<U4> b(GROUP_WORDS / 4);
    uint32_t* buf = reinterpret_cast<uint32_t*>(b.data());
    for (int j = 0; j < GROUP_WORDS; ++j) buf[j] = 0xA5A5A5A5u ^ (uint32_t)j;
    for (int j = 0; j < NL; ++j) buf[GS_ZERO * NL + j] = 0;
    for (int j = 0; j < PT; ++j) buf[GS_P * NL + j] = p[j];
    if (op == 0)
      for (int j = 0; j < PT; ++j) buf[GS_Q * NL + j] = q[j];
    SerialLanes L;
    L.reverse = reverse != 0;
    if (op == 0) L.add<K>(buf); else L.dbl<K>(buf);
    for (int j = 0; j < PT; ++j) r[j] = buf[GS_P * NL + j];
    return;
  }
  Pt a, b;
  for (int j = 0; j < NL; ++j) {
    a.x[j] = p[j], a.y[j] = p[NL + j], a.z[j] = p[2 * NL + j];
    b.x[j] = q[j], b.y[j] = q[NL + j], b.z[j] = q[2 * NL + j];
  }
  if (op == 0) {
    point_add<K>(a, a, b);
  } else if (op == 1) {
    point_double<K>(a, a);
  } else {
    point_double_lazy<K>(a, a);
    canon<K>(a.x);
    canon<K>(a.y);
    canon<K>(a.z);
  }
  for (int j = 0; j < NL; ++j) r[j] = a.x[j], r[NL + j] = a.y[j], r[2 * NL + j] = a.z[j];
}

extern "C" void host_point_op(int f, const uint32_t* p, const uint32_t* q, uint32_t* r, int op,
                              int grouped, int reverse) {
  (f ? point_op_host<1> : point_op_host<0>)(p, q, r, op, grouped, reverse);
}

// r = k a by the small-constant multiply (small != 0) or by a Montgomery
// product with k R mod p (small == 0; k must be 3b: curve_b3).
extern "C" void host_mul_small(int f, const uint32_t* a, uint32_t k, uint32_t* r, int small) {
  uint32_t b3[NL];
  for (int j = 0; j < NL; ++j) b3[j] = f ? curve_b3<1>(j) : curve_b3<0>(j);
  if (small) {
    (f ? mul_small<1> : mul_small<0>)(r, a, k);
  } else {
    (f ? mont_mul<1> : mont_mul<0>)(r, a, b3);
  }
}

// K9 as vdf_horner launches it: a group a batch row, its lanes one after
// another.
extern "C" void host_horner(int f, const uint32_t* sums, uint32_t* out, int64_t batch,
                            int reverse) {
  for (int64_t row = 0; row < batch; ++row) {
    std::vector<U4> buf(GROUP_WORDS / 4), stage(HORNER_PIECES);
    uint32_t* b = reinterpret_cast<uint32_t*>(buf.data());
    SerialLanes L;
    L.reverse = reverse != 0;
    if (f) horner_walk<1>(L, b, stage.data(), sums, out, row);
    else horner_walk<0>(L, b, stage.data(), sums, out, row);
  }
}

extern "C" void host_canon_mont(int f, const uint32_t* in, uint32_t* out, int64_t count) {
  grid(count, CBLOCK, [&] { (f ? canon_mont_kernel<1> : canon_mont_kernel<0>)(in, out, count); });
}

template <int K>
static void shift_gens_host(const uint32_t* gens, uint32_t* table, int64_t n, int form,
                            int reverse) {
  if (form == 0) {
    grid(n, PBLOCK, [&] { shift_gens_kernel<K>(gens, table, n); });
    return;
  }
  std::vector<U4> buf(GROUP_WORDS / 4);
  for (int64_t i = 0; i < n; ++i) {
    SerialLanes L;
    L.reverse = reverse != 0;
    shift_gens_walk<K>(L, reinterpret_cast<uint32_t*>(buf.data()), gens, table, n, i);
  }
}

// K7 as vdf_shift_gens launches it: form 0, the thread form (thread after
// thread); form 1, the group form (a group a generator, its lanes one after
// another).
extern "C" void host_shift_gens(int f, const uint32_t* gens, uint32_t* table, int64_t n,
                                int form, int reverse) {
  (f ? shift_gens_host<1> : shift_gens_host<0>)(gens, table, n, form, reverse);
}

template <int K>
static void scan_host(const uint32_t* table, const void* keys, uint32_t* tails,
                      int32_t* tail_col, uint32_t* sums, int32_t* flags, int64_t rows,
                      int64_t cols, int64_t batch, int form, int reverse, int key_bits) {
  const int64_t columns = batch * cols;
  if (form == 0) {
    grid(columns, PBLOCK, [&] {
      scan_kernel<K>(table, keys, tails, tail_col, sums, flags, rows, cols, batch, key_bits);
    });
    return;
  }
  std::vector<U4> buf(GROUP_WORDS / 4);
  std::vector<int64_t> gkeys(rows + 2);
  for (int64_t g = 0; g < columns; ++g) {
    SerialLanes L;
    L.reverse = reverse != 0;
    scan_group_walk<K>(L, reinterpret_cast<uint32_t*>(buf.data()), gkeys.data(), table, keys,
                       key_bits, tails, tail_col, sums, flags, rows, cols, g);
  }
}

// K4 as vdf_scan in msm.cu launches it: form 0, the thread form (thread
// after thread); form 1, the group form (a group a column, its lanes one
// after another); keys of key_bits 32 or 64.
extern "C" void host_scan(int f, const uint32_t* table, const void* keys, uint32_t* tails,
                          int32_t* tail_col, uint32_t* sums, int32_t* flags, int64_t rows,
                          int64_t cols, int64_t batch, int form, int reverse, int key_bits) {
  (f ? scan_host<1> : scan_host<0>)(table, keys, tails, tail_col, sums, flags, rows, cols,
                                    batch, form, reverse, key_bits);
}

// K5 as vdf_colscan in msm.cu launches it: what each thread does in each
// pass, the passes and the scan's levels in order.  The staged tile and the
// scan buffers are shared memory on the card.
template <int K>
static void colscan_host(const uint32_t* sums, const int32_t* flags, uint32_t* thread_v,
                         int32_t* thread_f, uint32_t* tile_incl, uint32_t* carries,
                         int64_t cols, int64_t batch, int per_thread) {
  const int64_t span = (int64_t)PBLOCK * per_thread, tiles = (cols + span - 1) / span;
  std::vector<U4> stage(stage_pieces(per_thread));
  std::vector<uint32_t> v(2 * SCAN_WORDS);
  std::vector<int32_t> f(2 * PBLOCK);
  auto scan = [&]() {
    int cur = 0;
    for (int d = 1; d < PBLOCK; d *= 2) {
      bool any = false;
      for (int t = 0; t < PBLOCK; ++t) any |= colscan_level_adds(f.data() + cur * PBLOCK, t, d);
      if (!any) break;
      for (int t = 0; t < PBLOCK; ++t)
        colscan_level_thread<K>(v.data() + cur * SCAN_WORDS, f.data() + cur * PBLOCK,
                                v.data() + (cur ^ 1) * SCAN_WORDS,
                                f.data() + (cur ^ 1) * PBLOCK, t, d);
      cur ^= 1;
    }
    return cur;
  };
  auto records_of = [&](int64_t tile) {
    return cols - tile * span < span ? cols - tile * span : span;
  };
  auto stage_in = [&](int64_t k, int64_t tile) {
    const U4* src = pt_at(sums, k * cols + tile * span);
    for (int64_t q = 0; q < records_of(tile) * PIECES; ++q)
      stage[stage_piece(q, per_thread)] = src[q];
  };
  for (int64_t k = 0; k < batch; ++k) {
    for (int64_t tile = 0; tile < tiles; ++tile) {  // pass 1
      stage_in(k, tile);
      Pt acc;
      for (int t = 0; t < PBLOCK; ++t) {
        f[t] = colscan_reduce_thread<K>(acc, stage.data(), flags + k * cols,
                                        tile * span + (int64_t)t * per_thread, cols, t,
                                        per_thread);
        store_scan(v.data(), t, acc);
      }
      const int cur = scan();
      for (int t = 0; t < PBLOCK; ++t) {
        const int64_t g = (k * tiles + tile) * PBLOCK + t;
        load_scan(acc, v.data() + cur * SCAN_WORDS, t);
        store_pt4(pt_at(thread_v, g), acc);
        thread_f[g] = f[cur * PBLOCK + t];
      }
    }
  }
  for (int64_t k = 0; k < batch; ++k) {  // pass 2
    for (int64_t tile0 = 0; tile0 < tiles; tile0 += PBLOCK) {
      for (int t = 0; t < PBLOCK; ++t)
        colscan_rows_load_thread<K>(v.data(), f.data(), thread_v, thread_f, k, tiles, tile0, t);
      const int cur = scan();
      for (int t = 0; t < PBLOCK; ++t)
        colscan_rows_store_thread<K>(v.data() + cur * SCAN_WORDS, f.data() + cur * PBLOCK,
                                     tile_incl, k, tiles, tile0, t);
    }
  }
  for (int64_t k = 0; k < batch; ++k) {  // pass 3
    for (int64_t tile = 0; tile < tiles; ++tile) {
      stage_in(k, tile);
      for (int t = 0; t < PBLOCK; ++t)
        colscan_carry_thread<K>(stage.data(), flags + k * cols, thread_v, thread_f, tile_incl,
                                k, tile, tiles, cols, t, per_thread);
      U4* dst = pt_at(carries, k * cols + tile * span);
      for (int64_t q = 0; q < records_of(tile) * PIECES; ++q)
        dst[q] = stage[stage_piece(q, per_thread)];
    }
  }
}

extern "C" void host_colscan(int f, const uint32_t* sums, const int32_t* flags,
                             uint32_t* thread_v, int32_t* thread_f, uint32_t* tile_incl,
                             uint32_t* carries, int64_t cols, int64_t batch, int per_thread) {
  (f ? colscan_host<1> : colscan_host<0>)(sums, flags, thread_v, thread_f, tile_incl, carries,
                                          cols, batch, per_thread);
}

// K6 as vdf_bucket in msm.cu launches it: step 0 and steps 1 .. m - 1 a chunk
// of 2^m buckets with `threads` threads, then the steps from m on and the
// Horner a batch row.
template <int K>
static void bucket_host(const uint32_t* tails, const int32_t* tail_col, const uint32_t* carries,
                        uint32_t* scratch, uint32_t* out, int64_t cols, int64_t batch, int m,
                        int threads) {
  const int64_t chunks = NB >> m, chunk = (int64_t)1 << m;
  for (int64_t k = 0; k < batch; ++k) {
    for (int64_t c = 0; c < chunks; ++c) {
      for (int th = 0; th < threads; ++th)
        for (int64_t b = th; b < chunk; b += threads)
          bucket_load_thread<K>(tails, tail_col, carries, scratch, k, c * chunk + b, cols);
      for (int s = 1; s < m; ++s)
        for (int th = 0; th < threads; ++th)
          for (int64_t w = th; w < bucket_step_items(s, m); w += threads)
            bucket_step_thread<K>(scratch, k, s, m, c, w);
    }
  }
  for (int64_t k = 0; k < batch; ++k) {
    for (int s = m; s <= TREE_STEPS; ++s)
      for (int th = 0; th < FINISH_THREADS; ++th)
        for (int64_t w = th; w < bucket_step_items(s, WINDOW_BITS); w += FINISH_THREADS)
          bucket_step_thread<K>(scratch, k, s, WINDOW_BITS, 0, w);
    bucket_horner_thread<K>(scratch, out, k);
  }
}

extern "C" void host_bucket(int f, const uint32_t* tails, const int32_t* tail_col,
                            const uint32_t* carries, uint32_t* scratch, uint32_t* out,
                            int64_t cols, int64_t batch, int m, int threads) {
  (f ? bucket_host<1> : bucket_host<0>)(tails, tail_col, carries, scratch, out, cols, batch, m,
                                        threads);
}
"""


class HostKernels:
    """The kernel bodies on numpy buffers; outputs as torch tensors."""

    def __init__(self, lib):
        self.lib = lib

    @staticmethod
    def _p(a):
        return ctypes.c_void_p(a.ctypes.data)

    def canon_digits(self, field, scalars, m_pad, window_rows=False, key_bits=None):
        """K3 mode 0 into keys filled with a pattern no key has: the kernel
        writes every position, the padding too."""
        s = np.ascontiguousarray(scalars.numpy())
        k, n = s.shape[:2]
        bits = K.key_width(n if window_rows else K.WINDOWS * n, key_bits)
        keys = np.full((k, K.WINDOWS, m_pad) if window_rows else (k, m_pad), 0x5A5A5A5A,
                       dtype=np.int32 if bits == 32 else np.int64)
        self.lib.host_canon_digits(_build.FIELD_INDEX[field], self._p(s), self._p(keys),
                                   ctypes.c_int64(n), ctypes.c_int64(k * n),
                                   ctypes.c_int64(m_pad), ctypes.c_int(int(window_rows)),
                                   ctypes.c_int(bits))
        return torch.from_numpy(keys)

    def horner(self, field, sums, reverse=False):
        v = np.ascontiguousarray(sums.numpy())
        out = np.empty((v.shape[0], 3, 8), dtype=np.int32)
        self.lib.host_horner(_build.FIELD_INDEX[field], self._p(v), self._p(out),
                             ctypes.c_int64(v.shape[0]), ctypes.c_int(int(reverse)))
        return torch.from_numpy(out)

    def point_op(self, field, p, q, op, grouped, reverse=False):
        """One add (op 0: p + q) or doubling (op 1: 2 p) of (3, 8) int32
        points, on a group's lanes (in order, or reversed) or on one
        thread."""
        a, b = np.ascontiguousarray(p.numpy()), np.ascontiguousarray(q.numpy())
        r = np.empty((3, 8), dtype=np.int32)
        self.lib.host_point_op(_build.FIELD_INDEX[field], self._p(a), self._p(b), self._p(r),
                               ctypes.c_int(op), ctypes.c_int(int(grouped)),
                               ctypes.c_int(int(reverse)))
        return torch.from_numpy(r)

    def mul_small(self, field, a, k, small=True):
        v = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
        r = np.empty(8, dtype=np.uint32)
        self.lib.host_mul_small(_build.FIELD_INDEX[field], self._p(v), ctypes.c_uint32(k),
                                self._p(r), ctypes.c_int(int(small)))
        return r

    def canon_mont(self, field, values):
        v = np.ascontiguousarray(values.numpy())
        out = np.empty_like(v)
        self.lib.host_canon_mont(_build.FIELD_INDEX[field], self._p(v), self._p(out),
                                 ctypes.c_int64(v.shape[0]))
        return torch.from_numpy(out)

    def shift_gens(self, field, gens, form="thread", reverse=False):
        """K7 in one of its forms (K.SHIFT_FORMS)."""
        g = np.ascontiguousarray(gens.numpy())
        table = np.empty((K.WINDOWS * g.shape[0], 3, 8), dtype=np.int32)
        self.lib.host_shift_gens(_build.FIELD_INDEX[field], self._p(g), self._p(table),
                                 ctypes.c_int64(g.shape[0]), ctypes.c_int(K.SHIFT_FORMS.index(form)),
                                 ctypes.c_int(int(reverse)))
        return torch.from_numpy(table)

    def bucket_scan(self, field, table, keys, rows, form="thread", reverse=False):
        """K4 in one of its forms (K.SCAN_FORMS)."""
        t, kk = np.ascontiguousarray(table.numpy()), np.ascontiguousarray(keys.numpy())
        k, m_pad = kk.shape
        cols = m_pad // rows
        tails = K._identity_rows(field, (k, K.NB), "cpu").numpy().copy()
        tail_col = np.full((k, K.NB), -1, dtype=np.int32)
        sums = np.empty((k, cols, 3, 8), dtype=np.int32)
        flags = np.empty((k, cols), dtype=np.int32)
        self.lib.host_scan(_build.FIELD_INDEX[field], self._p(t), self._p(kk),
                           self._p(tails), self._p(tail_col), self._p(sums), self._p(flags),
                           ctypes.c_int64(rows), ctypes.c_int64(cols), ctypes.c_int64(k),
                           ctypes.c_int(K.SCAN_FORMS.index(form)),
                           ctypes.c_int(int(reverse)), ctypes.c_int(K.key_bits_of(keys)))
        return tuple(map(torch.from_numpy, (tails, tail_col, sums, flags)))

    def column_carries(self, field, sums, flags, per_thread=None):
        s, f = np.ascontiguousarray(sums.numpy()), np.ascontiguousarray(flags.numpy())
        k, cols = f.shape
        per_thread = K.carry_columns(cols) if per_thread is None else per_thread
        tiles = -(-cols // (K.PBLOCK * per_thread))
        thread_v = np.empty((k, tiles * K.PBLOCK, 3, 8), dtype=np.int32)
        thread_f = np.empty((k, tiles * K.PBLOCK), dtype=np.int32)
        tile_incl = np.empty((k, tiles, 3, 8), dtype=np.int32)
        carries = np.empty_like(s)
        self.lib.host_colscan(_build.FIELD_INDEX[field], self._p(s), self._p(f),
                              self._p(thread_v), self._p(thread_f), self._p(tile_incl),
                              self._p(carries), ctypes.c_int64(cols), ctypes.c_int64(k),
                              ctypes.c_int(per_thread))
        return torch.from_numpy(carries)

    def bucket_sums(self, field, tails, tail_col, carries, chunk_bits=K.BUCKET_CHUNK_BITS,
                    threads=K.BUCKET_THREADS):
        t = np.ascontiguousarray(tails.numpy())
        tc = np.ascontiguousarray(tail_col.numpy())
        c = np.ascontiguousarray(carries.numpy())
        k, cols = c.shape[:2]
        scratch = np.empty((k, K.BUCKET_SCRATCH, 3, 8), dtype=np.int32)
        out = np.empty((k, 3, 8), dtype=np.int32)
        self.lib.host_bucket(_build.FIELD_INDEX[field], self._p(t), self._p(tc), self._p(c),
                             self._p(scratch), self._p(out), ctypes.c_int64(cols),
                             ctypes.c_int64(k), ctypes.c_int(chunk_bits), ctypes.c_int(threads))
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
    return c.scalar.encode(vals, device="cpu").reshape(k, n, 8)


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
    gens = stack_point(get_curve(curve_name).from_affine_ints(pts, device="cpu")).contiguous()
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


@pytest.mark.parametrize("curve_name", ["pallas", "vesta"])
def test_msm_kernel_bodies_match_plain(host, curve_name):
    """K3's window-row layout (n = 7 in rows of m_pad = 10: the key of
    (digit, i), the padding key (0, 0) beyond n) and K9 (B = 3 rows of 22
    window sums: table points, the identity, an all-ones limb pattern) ==
    plain, bit for bit."""
    params = CURVES[curve_name]
    bf, sf = params.base_field, params.scalar_field
    n, k, m_pad = 7, 2, 10
    s = _scalars(curve_name, k, n, seed=5)
    s[0, 6] = -1
    keys = host.canon_digits(sf, s, m_pad, window_rows=True)
    want = K.canon_digits_plain(sf, s, m_pad, window_rows=True)
    assert keys.shape == (k, K.WINDOWS, m_pad) and torch.equal(keys, want)
    pad = keys[:, :, n:]
    assert (K.key_digit(pad) == 0).all() and (K.key_item(pad) == 0).all()
    assert K.key_item(keys[0, :, :n]).tolist() == [list(range(n))] * K.WINDOWS

    pts = hash_to_curve_ints(curve_name, 3, domain=b"vdf_tpu/t")
    gens = stack_point(get_curve(curve_name).from_affine_ints(pts, device="cpu")).contiguous()
    table = K.shift_gens_plain(bf, gens)  # (66, 3, 8): 2^(12 w) G_i, not all z = 1
    sums = table.reshape(K.WINDOWS, 3, 3, 8).transpose(0, 1).contiguous()  # (3, W, 3, 8)
    sums[1, 4] = K._identity_rows(bf, (), "cpu")
    sums[2, 0, 0] = -1  # x = 2^256 - 1: reduced on load
    want = K.horner_plain(bf, sums)
    assert torch.equal(host.horner(bf, sums), want)
    assert torch.equal(host.horner(bf, sums, reverse=True), want)  # lanes in any order


# ---------------------------------------------------------------------
# K5 and K6 at the shapes that stress their structure
# ---------------------------------------------------------------------

P = K.PBLOCK
# name -> (batch rows, columns, L = columns a thread, how the run heads lie)
CARRY_CASES = {
    "one_column": (2, 1, 1, "random"),
    "tile_plus_one": (2, 2 * P + 1, 2, "random"),  # L = 2: a tile is 256 columns
    "ragged_last_tile": (2, 300, 2, "random"),  # 44 columns in tile 1, thread 22 ends the row
    "every_column_a_head": (2, P + 12, 1, "all"),
    "one_run": (2, 2 * P + 44, 1, "none"),  # no head after column 0 (and none flagged at 0)
    "four_a_thread": (1, 8 * P + 9, 4, "sparse"),  # the MSM shape's L: two tiles and 9 columns
    "eight_a_thread": (1, 8 * P + 9, 8, "sparse"),  # runs over many threads
    "more_tiles_than_a_block": (1, P * (P + 1) + 5, 1, "rare"),  # pass 2 takes two rounds
}
# name -> (which buckets take a carry, whether every tail is the identity)
BUCKET_CASES = {
    "no_carry": ("none", False),
    "every_bucket_a_carry": ("all", False),
    "identity_tails": ("some", True),
    "mixed": ("some", False),
}
BUCKET_CUTS = [(12, 512), (9, 512), (5, 32)]  # other places to cut K6's schedule: same bits


def _some_points(curve_name: str, count: int, seed: int) -> torch.Tensor:
    """(count, 3, 8) points drawn from 66 multiples 2^(12 w) G_i (z != 1 on most)."""
    bf = CURVES[curve_name].base_field
    pts = hash_to_curve_ints(curve_name, 3, domain=b"vdf_tpu/t")
    gens = stack_point(get_curve(curve_name).from_affine_ints(pts, device="cpu")).contiguous()
    table = K.shift_gens_plain(bf, gens)
    idx = np.random.default_rng(seed).integers(0, table.shape[0], size=count)
    return table[torch.from_numpy(idx)].contiguous()


def carry_case(curve_name: str, case: str):
    k, cols, per_thread, heads = CARRY_CASES[case]
    sums = _some_points(curve_name, k * cols, seed=cols).reshape(k, cols, 3, 8)
    rng = np.random.default_rng(cols + 1)
    share = {"random": 0.3, "all": 1.0, "none": 0.0, "sparse": 0.02, "rare": 0.0004}[heads]
    flags = torch.from_numpy((rng.random((k, cols)) < share).astype(np.int32))
    if heads != "none":
        flags[:, 0] = 1  # as K4 writes it
    return sums, flags, per_thread


def bucket_case(curve_name: str, case: str):
    carried, identity_tails = BUCKET_CASES[case]
    bf = CURVES[curve_name].base_field
    cols = 7
    rng = np.random.default_rng(len(case))
    tails = _some_points(curve_name, K.NB, seed=5)[None]
    if identity_tails:
        tails = K._identity_rows(bf, (1, K.NB), "cpu")
    tail_col = torch.from_numpy(rng.integers(0, cols, size=(1, K.NB)).astype(np.int32))
    if carried == "none":
        tail_col[:] = -1
    elif carried == "some":
        tail_col[0, torch.from_numpy(rng.random(K.NB) < 0.5)] = -1
    carries = _some_points(curve_name, cols, seed=6)[None]
    carries[0, 0] = K._identity_rows(bf, (), "cpu")
    return tails, tail_col, carries


@functools.cache
def plain_carries(curve_name: str, case: str) -> torch.Tensor:
    """The plain K5 on a case's inputs (both tests of a case read it)."""
    sums, flags, per_thread = carry_case(curve_name, case)
    return K.column_carries_plain(CURVES[curve_name].base_field, sums, flags, per_thread)


def affine_points(curve_name: str, pts: torch.Tensor) -> list:
    """(n, 3, 8) stacked points -> affine int pairs (None: the identity)."""
    c, ic = get_curve(curve_name), get_int_curve(curve_name)
    return [ic.to_affine(p) for p in zip(*(c.field.decode(pts[:, j]) for j in range(3)))]


@pytest.mark.parametrize("case", list(CARRY_CASES))
@pytest.mark.parametrize("curve_name", ["pallas", "vesta"])
def test_column_carry_bodies_match_plain_at_edge_shapes(host, curve_name, case):
    """K5's three passes, thread by thread == the plain version, bit for bit."""
    bf = CURVES[curve_name].base_field
    sums, flags, per_thread = carry_case(curve_name, case)
    got = host.column_carries(bf, sums, flags, per_thread)
    assert torch.equal(got, plain_carries(curve_name, case))


@pytest.mark.parametrize("case", list(CARRY_CASES))
@pytest.mark.parametrize("curve_name", ["pallas", "vesta"])
def test_column_carries_plain_matches_serial_sum(curve_name, case):
    """The plain K5 against an oracle that shares nothing of its schedule: one
    IntCurve walk along each row, restarting at each head; compared in affine.
    Column 0 takes the identity itself, limb for limb."""
    bf = CURVES[curve_name].base_field
    c, ic = get_curve(curve_name), get_int_curve(curve_name)
    sums, flags, per_thread = carry_case(curve_name, case)
    got = plain_carries(curve_name, case)
    assert got.shape == sums.shape
    assert torch.equal(got[:, 0], K._identity_rows(bf, (sums.shape[0],), "cpu"))
    for row_sums, row_flags, row_got in zip(sums, flags.tolist(), got):
        vals = list(zip(*(c.field.decode(row_sums[:, j]) for j in range(3))))
        want, acc = [], (0, 1, 0)
        for col, (v, head) in enumerate(zip(vals, row_flags)):
            want.append(ic.to_affine(acc))
            acc = v if head or col == 0 else ic.add(acc, v)
        assert affine_points(curve_name, row_got) == want


@pytest.mark.parametrize("case", list(BUCKET_CASES))
@pytest.mark.parametrize("curve_name", ["pallas", "vesta"])
def test_bucket_sum_bodies_match_plain_at_edge_inputs(host, curve_name, case):
    """K6's steps, thread by thread == the plain version, bit for bit, and the
    same bits wherever the schedule is cut between its two launches."""
    bf = CURVES[curve_name].base_field
    tails, tail_col, carries = bucket_case(curve_name, case)
    want = K.bucket_sums_plain(bf, tails, tail_col, carries)
    assert torch.equal(host.bucket_sums(bf, tails, tail_col, carries), want)
    for chunk_bits, threads in BUCKET_CUTS:
        assert torch.equal(host.bucket_sums(bf, tails, tail_col, carries, chunk_bits, threads),
                           want)


@pytest.mark.parametrize("case", list(BUCKET_CASES))
@pytest.mark.parametrize("curve_name", ["pallas", "vesta"])
def test_bucket_sums_plain_matches_weighted_sum(curve_name, case):
    """The plain K6 against sum_b b B_b through IntCurve (running sums from
    the top bucket down), in affine."""
    bf = CURVES[curve_name].base_field
    c, ic = get_curve(curve_name), get_int_curve(curve_name)
    tails, tail_col, carries = bucket_case(curve_name, case)
    got = affine_points(curve_name, K.bucket_sums_plain(bf, tails, tail_col, carries))
    t = list(zip(*(c.field.decode(tails[0, :, j]) for j in range(3))))
    cr = list(zip(*(c.field.decode(carries[0, :, j]) for j in range(3))))
    run, total = (0, 1, 0), (0, 1, 0)
    for b in range(K.NB - 1, 0, -1):
        col = int(tail_col[0, b])
        run = ic.add(run, ic.add(t[b], cr[col]) if col >= 0 else t[b])
        total = ic.add(total, run)
    assert got == [ic.to_affine(total)]
    if case == "identity_tails":
        assert got != [None]  # the carries alone make the sum


# ---------------------------------------------------------------------
# The group law on a group of 8 lanes (curve.cuh), the small-constant
# multiply (field.cuh), and K4's two forms
# ---------------------------------------------------------------------


def _enc_point(curve_name: str, pt) -> torch.Tensor:
    """Projective int triple -> (3, 8) Montgomery limbs."""
    f = get_curve(curve_name).field
    return torch.stack([f.encode([v], device="cpu")[0] for v in pt]).contiguous()


def _dec_point(curve_name: str, t: torch.Tensor) -> tuple:
    f = get_curve(curve_name).field
    return tuple(f.decode(t[j : j + 1])[0] for j in range(3))


# name -> (op: 0 add, 1 doubling; how the operands are made)
GROUP_LAW_CASES = {
    "add_random": (0, "random"),
    "add_identity_left": (0, "identity_left"),
    "add_identity_right": (0, "identity_right"),
    "add_p_plus_p": (0, "equal"),
    "add_p_plus_minus_p": (0, "negated"),
    "double_random": (1, "random"),
    "double_identity": (1, "identity_left"),
}


@pytest.mark.parametrize("case", list(GROUP_LAW_CASES))
@pytest.mark.parametrize("curve_name", ["pallas", "vesta"])
def test_group_law_steps_match_one_thread_and_int_curve(host, curve_name, case):
    """An add or doubling as the four steps of a group of 8 lanes, run
    lane after lane (in order and reversed: no task reads what another
    task of the same step writes) == the one-thread body (point_add /
    point_double) == the plain add16 / double16, limb for limb, and ==
    IntCurve.  Pasta's groups have prime order: no point of order 2."""
    bf = CURVES[curve_name].base_field
    ic = get_int_curve(curve_name)
    op, how = GROUP_LAW_CASES[case]
    p, q = _some_points(curve_name, 2, seed=len(case))
    ident = K._identity_rows(bf, (), "cpu")
    if how == "identity_left":
        p = ident
    elif how == "identity_right":
        q = ident
    elif how == "equal":
        q = p.clone()
    elif how == "negated":
        q = _enc_point(curve_name, ic.neg(_dec_point(curve_name, p)))
    got = host.point_op(bf, p, q, op, grouped=False)
    for reverse in (False, True):
        assert torch.equal(host.point_op(bf, p, q, op, True, reverse), got), reverse
    p16, q16 = point_to_digits(p[None]), point_to_digits(q[None])
    plain = add16(bf, p16, q16) if op == 0 else double16(bf, p16)
    assert torch.equal(point_from_digits(plain)[0], got)
    P, Q = _dec_point(curve_name, p), _dec_point(curve_name, q)
    want = ic.add(P, Q) if op == 0 else ic.double(P)
    assert _dec_point(curve_name, got) == want
    if how == "negated" or (op == 1 and how == "identity_left"):
        assert ic.to_affine(want) is None


def _mul_small_values(name: str) -> list[int]:
    p = FIELDS[name].modulus
    rng = random.Random(17)
    return [0, 1, p - 1, 1 << 254, *(rng.randrange(p) for _ in range(20))]


@pytest.mark.parametrize("k", [15, 2, 3, 8, 45])
@pytest.mark.parametrize("name", ["Fp", "Fq"])
def test_mul_small_matches_mont_mul_and_ints(host, name, k):
    """r = k a mod p by the small-constant multiply == Python ints at 0, 1,
    p - 1, 2^254 and random values; for k = 3b = 15 also == the Montgomery
    product by curve_b3 it replaces."""
    p = FIELDS[name].modulus
    for a in _mul_small_values(name):
        limbs = int_to_limbs(a).astype(np.uint32)
        got = host.mul_small(name, limbs, k)
        assert int.from_bytes(got.astype("<u4").tobytes(), "little") == k * a % p
        if k == 15:
            assert (host.mul_small(name, limbs, k, small=False) == got).all()


def scan_case(curve_name: str, shape: str):
    """(table, sorted keys, rows): the commit test's shape (K = 2, n = 6,
    rows = 5, a ragged last column), or one in which a run of equal digits
    crosses three columns (K = 1, n = 16 equal scalars, rows = 4)."""
    params = CURVES[curve_name]
    bf, sf = params.base_field, params.scalar_field
    n, k, rows = (6, 2, 5) if shape == "commit" else (16, 1, 4)
    pts = hash_to_curve_ints(curve_name, n, domain=b"vdf_tpu/t")
    gens = stack_point(get_curve(curve_name).from_affine_ints(pts, device="cpu")).contiguous()
    table = K.shift_gens_plain(bf, gens)
    s = _scalars(curve_name, k, n, seed=3)
    if shape == "long_run":
        s[:] = s[0, 4]
    _, m_pad = layout(n, rows)
    keys = torch.sort(K.canon_digits_plain(sf, s, m_pad), dim=-1).values
    return table, keys, rows


@pytest.mark.parametrize("shape", ["commit", "long_run"])
@pytest.mark.parametrize("form, reverse", [("thread", False), ("group", False), ("group", True)],
                         ids=["thread", "group", "group_reversed"])
@pytest.mark.parametrize("curve_name", ["pallas", "vesta"])
def test_scan_bodies_match_plain_in_both_forms(host, curve_name, form, reverse, shape):
    """K4 in each form (one thread a column; a group of 8 lanes a column on
    the group law, lanes in order and reversed) == the plain version, bit
    for bit."""
    bf = CURVES[curve_name].base_field
    table, keys, rows = scan_case(curve_name, shape)
    want = K.bucket_scan_plain(bf, table, keys, rows)
    got = host.bucket_scan(bf, table, keys, rows, form=form, reverse=reverse)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if shape == "long_run":  # some digit's run covers parts of three columns
        d = K.key_digit(keys[0]).tolist()
        runs = [len(list(g)) for _, g in itertools.groupby(d)]
        assert max(runs) >= rows + 2 and (want[1] >= 0).any()


# ---------------------------------------------------------------------
# K7's two forms, the lazy doubling of its thread form, and K3's and K4's
# two key widths
# ---------------------------------------------------------------------


def _plus_p(curve_name: str, limbs: torch.Tensor) -> torch.Tensor:
    """(..., 8) canonical limbs -> the same residues as v + p (below 2p):
    lazy, non-canonical representations."""
    p = CURVES[curve_name].base_field
    mod = FIELDS[p].modulus
    vals = [int.from_bytes(r.numpy().astype("<u4").tobytes(), "little") + mod
            for r in limbs.reshape(-1, 8)]
    out = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), dtype="<u4")
    return torch.from_numpy(out.view(np.int32).copy()).reshape(limbs.shape)


@functools.cache
def shift_case(curve_name: str, n: int):
    """(generators (n, 3, 8), the plain table): points drawn from table
    multiples (z != 1 on most), generator 1 in a non-canonical form (each
    coordinate + p, which the kernels reduce on load)."""
    bf = CURVES[curve_name].base_field
    gens = _some_points(curve_name, n, seed=n + 2)
    if n > 1:
        gens[1] = _plus_p(curve_name, gens[1])
    return gens, K.shift_gens_plain(bf, gens)


@pytest.mark.parametrize("n", [1, 5, 66])
@pytest.mark.parametrize("form, reverse", [("thread", False), ("group", False), ("group", True)],
                         ids=["thread", "group", "group_reversed"])
@pytest.mark.parametrize("curve_name", ["pallas", "vesta"])
def test_shift_gens_bodies_match_plain_in_both_forms(host, curve_name, form, reverse, n):
    """K7 in each form (one thread a generator on the lazy 12-doubling
    chain; a group of 8 lanes a generator on the group law, lanes in order
    and reversed) == the plain table, bit for bit: every window canonical."""
    gens, want = shift_case(curve_name, n)
    got = host.shift_gens(CURVES[curve_name].base_field, gens, form=form, reverse=reverse)
    assert torch.equal(got, want)


@pytest.mark.parametrize("how", ["random", "identity", "lazy_input"])
@pytest.mark.parametrize("curve_name", ["pallas", "vesta"])
def test_lazy_doubling_matches_point_double(host, curve_name, how):
    """point_double_lazy, its result reduced, == point_double: on a point in
    projective form, on the identity, and on the same point with every
    coordinate given as its value + p (a lazy operand, below 2p)."""
    bf = CURVES[curve_name].base_field
    p = _some_points(curve_name, 1, seed=len(how))[0]
    if how == "identity":
        p = K._identity_rows(bf, (), "cpu")
    want = host.point_op(bf, p, p, 1, grouped=False)
    if how == "lazy_input":
        p = _plus_p(curve_name, p)
    assert torch.equal(host.point_op(bf, p, p, 2, grouped=False), want)


@pytest.mark.parametrize("window_rows", [False, True], ids=["window_major", "window_rows"])
@pytest.mark.parametrize("key_bits", [32, 64])
@pytest.mark.parametrize("curve_name", ["pallas", "vesta"])
def test_canon_digits_bodies_match_plain_in_both_widths(host, curve_name, key_bits, window_rows):
    """K3 mode 0 in each key width and layout == plain, bit for bit, with the
    padding it writes (rows of m_pad = items + 5, keys filled with a pattern
    beforehand; more padding positions than scalars in the window-row
    layout)."""
    sf = CURVES[curve_name].scalar_field
    n, k = 3, 2
    s = _scalars(curve_name, k, n + 1, seed=7)[:, 1:].contiguous()
    s[1, 2] = -1
    m_pad = (n if window_rows else K.WINDOWS * n) + 5
    got = host.canon_digits(sf, s, m_pad, window_rows, key_bits)
    want = K.canon_digits_plain(sf, s, m_pad, window_rows, key_bits)
    assert got.dtype == K.KEY_DTYPES[key_bits] and torch.equal(got, want)
    pad = got[..., m_pad - 5 :]
    assert (K.key_digit(pad) == 0).all() and (K.key_item(pad) == 0).all()


@pytest.mark.parametrize("form", ["thread", "group"])
@pytest.mark.parametrize("curve_name", ["pallas", "vesta"])
def test_scan_bodies_read_both_key_widths(host, curve_name, form):
    """K4 in each form on int64 keys == the plain version on the same data's
    32-bit keys (the run across three columns of scan_case), bit for bit."""
    bf, sf = CURVES[curve_name].base_field, CURVES[curve_name].scalar_field
    table, keys, rows = scan_case(curve_name, "long_run")
    s = _scalars(curve_name, 1, 16, seed=3)
    s[:] = s[0, 4]
    keys64 = torch.sort(K.canon_digits_plain(sf, s, keys.shape[1], key_bits=64), -1).values
    assert keys.dtype == torch.int32 and keys64.dtype == torch.int64
    want = K.bucket_scan_plain(bf, table, keys, rows)
    for g, w in zip(host.bucket_scan(bf, table, keys64, rows, form=form), want):
        assert torch.equal(g, w)
