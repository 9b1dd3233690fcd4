"""The CUDA kernel bodies K3-K7 and K9, compiled as host C++ and run on the CPU.

With the CUDA qualifiers defined away and ``threadIdx``/``blockIdx``
emulated, g++ compiles the very source nvcc builds for the card
(``csrc/msm_kernels.cuh``, ``csrc/curve.cuh``).  K3, K4, K7 and K9 use no
CUDA intrinsic: each grid runs thread by thread.  K5 and K6 synchronise
inside a block, so the source gives what a thread does between two barriers
as ``__device__`` functions on explicit buffers; the shim below calls them
as ``csrc/msm.cu``'s kernels do, pass after pass, level after level, thread
after thread (the barriers, the vote and the copies through shared memory
are the card's).  Every output must equal the plain version
(curves/kernels.py) bit for bit, also at the shapes that stress K5's tiles
and K6's inputs; and the plain K5 and K6 equal oracles that share nothing of
their schedule.  Launch, stream, the races between blocks and the sm_90a
build are checked on the card (tests/test_torch_build.py -m gpu,
chip_smoke.py).
"""

import ctypes
import functools
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

extern "C" void host_canon_digits(int f, const uint32_t* s, int64_t* keys, int64_t n,
                                  int64_t count, int64_t m_pad, int window_rows) {
  grid(count, CBLOCK, [&] {
    (f ? canon_digits_kernel<1> : canon_digits_kernel<0>)(s, keys, n, count, m_pad,
                                                          window_rows);
  });
}

extern "C" void host_horner(int f, const uint32_t* sums, uint32_t* out, int64_t batch) {
  grid(batch, PBLOCK, [&] { (f ? horner_kernel<1> : horner_kernel<0>)(sums, out, batch); });
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

    def canon_digits(self, field, scalars, m_pad, window_rows=False):
        s = np.ascontiguousarray(scalars.numpy())
        k, n = s.shape[:2]
        keys = np.zeros((k, K.WINDOWS, m_pad) if window_rows else (k, m_pad), dtype=np.int64)
        self.lib.host_canon_digits(_build.FIELD_INDEX[field], self._p(s), self._p(keys),
                                   ctypes.c_int64(n), ctypes.c_int64(k * n),
                                   ctypes.c_int64(m_pad), ctypes.c_int(int(window_rows)))
        return torch.from_numpy(keys)

    def horner(self, field, sums):
        v = np.ascontiguousarray(sums.numpy())
        out = np.empty((v.shape[0], 3, 8), dtype=np.int32)
        self.lib.host_horner(_build.FIELD_INDEX[field], self._p(v), self._p(out),
                             ctypes.c_int64(v.shape[0]))
        return torch.from_numpy(out)

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
    """K3's window-row layout (n = 7 in rows of m_pad = 10: digit << 32 | i,
    zero beyond n) and K9 (B = 3 rows of 22 window sums: table points, the
    identity, an all-ones limb pattern) == plain, bit for bit."""
    params = CURVES[curve_name]
    bf, sf = params.base_field, params.scalar_field
    n, k, m_pad = 7, 2, 10
    s = _scalars(curve_name, k, n, seed=5)
    s[0, 6] = -1
    keys = host.canon_digits(sf, s, m_pad, window_rows=True)
    want = K.canon_digits_plain(sf, s, m_pad, window_rows=True)
    assert keys.shape == (k, K.WINDOWS, m_pad) and torch.equal(keys, want)
    assert (keys[:, :, n:] == 0).all() and (keys[0, :, :n] & 0xFFFFFFFF).tolist() == [
        list(range(n))] * K.WINDOWS

    pts = hash_to_curve_ints(curve_name, 3, domain=b"vdf_tpu/t")
    gens = stack_point(get_curve(curve_name).from_affine_ints(pts, device="cpu")).contiguous()
    table = K.shift_gens_plain(bf, gens)  # (66, 3, 8): 2^(12 w) G_i, not all z = 1
    sums = table.reshape(K.WINDOWS, 3, 3, 8).transpose(0, 1).contiguous()  # (3, W, 3, 8)
    sums[1, 4] = K._identity_rows(bf, (), "cpu")
    sums[2, 0, 0] = -1  # x = 2^256 - 1: reduced on load
    assert torch.equal(host.horner(bf, sums), K.horner_plain(bf, sums))


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
