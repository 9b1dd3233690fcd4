"""The CUDA kernel bodies K1/K2 and the field library K0, compiled as host
C++ and run on the CPU.

``csrc/minroot_kernels.cuh`` and ``csrc/field.cuh`` use no CUDA intrinsic,
so with the CUDA qualifiers defined away and ``threadIdx``/``blockIdx``
emulated, g++ compiles the very source nvcc builds for the card.  Running
each thread of each block in turn (threads share nothing but their own
column of the shared power table) gives the kernel's result on every lane,
which must equal the plain versions and Python-int MinRoot exactly;
``mont_mul`` and ``mont_sqr`` alone are held against Python integers.  This
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

// out[k] = mont_mul(a[k], b[k]) (sqr == 0) or mont_sqr(a[k]), or their lazy
// forms, n elements of 8 limbs.
extern "C" void product(int field, int sqr, int lazy, const uint32_t* a, const uint32_t* b,
                        uint32_t* out, int64_t n) {
  for (int64_t k = 0; k < n; ++k) {
    const uint32_t *ak = a + 8 * k, *bk = b + 8 * k;
    uint32_t* r = out + 8 * k;
    if (sqr && lazy) {
      field ? vdf::mont_sqr_lazy<1>(r, ak) : vdf::mont_sqr_lazy<0>(r, ak);
    } else if (sqr) {
      field ? vdf::mont_sqr<1>(r, ak) : vdf::mont_sqr<0>(r, ak);
    } else if (lazy) {
      field ? vdf::mont_mul_lazy<1>(r, ak, bk) : vdf::mont_mul_lazy<0>(r, ak, bk);
    } else {
      field ? vdf::mont_mul<1>(r, ak, bk) : vdf::mont_mul<0>(r, ak, bk);
    }
  }
}

// v[k] = canon(v[k]) in place.
extern "C" void canon(int field, uint32_t* v, int64_t n) {
  for (int64_t k = 0; k < n; ++k) field ? vdf::canon<1>(v + 8 * k) : vdf::canon<0>(v + 8 * k);
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
    lib.product.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, vp, vp, vp,
                            ctypes.c_int64]
    lib.product.restype = None
    lib.canon.argtypes = [ctypes.c_int, vp, ctypes.c_int64]
    lib.canon.restype = None

    def run(field_name, inverse, x, y, i, t):
        ins = [np.ascontiguousarray(a.numpy()) for a in (x, y, i)]
        outs = [np.empty_like(a) for a in ins]
        lib.run(_build.FIELD_INDEX[field_name], int(inverse),
                *(a.ctypes.data for a in ins + outs), ins[0].shape[0], t)
        return tuple(torch.from_numpy(a) for a in outs)

    run.lib = lib
    return run


def _limbs(vals) -> np.ndarray:
    """Integers below 2^256 as (n, 8) little-endian u32 limbs."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(raw, dtype="<u4").reshape(len(vals), 8).copy()


def _ints(limbs: np.ndarray) -> list[int]:
    return [int.from_bytes(row.astype("<u4").tobytes(), "little") for row in limbs]


def host_product(host_kernels, name, a, b=None, lazy=False):
    """mont_mul(a, b), or mont_sqr(a) with b None, on lists of integers;
    ``lazy`` takes the forms without the last subtraction."""
    la = _limbs(a)
    lb = la if b is None else _limbs(b)
    out = np.empty_like(la)
    host_kernels.lib.product(_build.FIELD_INDEX[name], int(b is None), int(lazy), la.ctypes.data,
                             lb.ctypes.data, out.ctypes.data, len(a))
    return _ints(out)


def edge_values(name: str, seed: int) -> list[int]:
    """0, 1, p - 1, R mod p, values whose low limb is 0 (m = 0 in the first
    reduction row), all-ones limbs after canon, and 200 seeded values."""
    p = FIELDS[name].modulus
    nrng = np.random.default_rng(seed)
    rand = [int.from_bytes(nrng.bytes(32), "little") % p for _ in range(200)]
    low_zero = [(rand[0] >> 32) << 32, 1 << 32, ((p - 1) >> 64) << 64]
    return [0, 1, p - 1, (1 << 256) % p, *low_zero, ((1 << 256) - 1) % p, *rand]


def seeded_state(name: str, lanes: int, seed: int):
    p = FIELDS[name].modulus
    nrng = np.random.default_rng(seed)
    f = get_field(name)
    vals = [[int(v) % p for v in nrng.integers(0, 1 << 63, size=lanes)] for _ in range(3)]
    vals[0][:4] = [0, 1, p - 1, (1 << 256) % p][:lanes]
    return vals, tuple(f.encode(v, device="cpu") for v in vals)


@pytest.mark.parametrize("name", ["Fp", "Fq"])
def test_canon_reduces_any_limbs(host_kernels, name):
    p = FIELDS[name].modulus
    vals = [(1 << 256) - 1, p, p - 1, 2 * p, 2 * p - 1, 3 * p, 3 * p + 5, 0]
    v = _limbs(vals)
    host_kernels.lib.canon(_build.FIELD_INDEX[name], v.ctypes.data, len(vals))
    assert _ints(v) == [x % p for x in vals]


@pytest.mark.parametrize("name", ["Fp", "Fq"])
def test_mont_mul_matches_python_ints(host_kernels, name):
    """a b / R mod p, canonical, over the edge values pairwise-shifted; one
    operand in [p, 2p) is within the contract."""
    p = FIELDS[name].modulus
    rinv = pow(1 << 256, -1, p)
    a = edge_values(name, seed=21)
    for shift in (0, 1, 3, 8):
        b = a[shift:] + a[:shift]
        assert host_product(host_kernels, name, a, b) == [x * y * rinv % p for x, y in zip(a, b)]
    lazy = [x + p for x in a]  # < 2p < 2^256
    b = a[5:] + a[:5]
    want = [x * y * rinv % p for x, y in zip(a, b)]
    assert host_product(host_kernels, name, lazy, b) == want
    assert host_product(host_kernels, name, b, lazy) == want


@pytest.mark.parametrize("name", ["Fp", "Fq"])
def test_mont_sqr_matches_python_ints(host_kernels, name):
    """a^2 / R mod p for canonical a, and equal to mont_mul(a, a)."""
    p = FIELDS[name].modulus
    rinv = pow(1 << 256, -1, p)
    a = edge_values(name, seed=22)
    got = host_product(host_kernels, name, a)
    assert got == [x * x * rinv % p for x in a]
    assert got == host_product(host_kernels, name, a, a)


@pytest.mark.parametrize("name", ["Fp", "Fq"])
def test_lazy_products_stay_in_their_range(host_kernels, name):
    """Operands up to the lazy bound 2p (1 + 2^-100): the result is congruent
    to a b / R and stays below that bound, through a chain of 300 squarings
    that starts at the bound as well."""
    p = FIELDS[name].modulus
    rinv = pow(1 << 256, -1, p)
    bound = 2 * p + (2 * p >> 100)
    small = edge_values(name, seed=23)
    a = [bound - 1, bound - 1, 2 * p, 2 * p - 1, p, *(x + p for x in small), *small]
    b = [bound - 1, p - 1, 2 * p, 1, p, *small, *(x + p for x in small[::-1])]
    got = host_product(host_kernels, name, a, b, lazy=True)
    assert all(g < bound for g in got)
    assert [g % p for g in got] == [x * y * rinv % p for x, y in zip(a, b)]
    got = host_product(host_kernels, name, a, lazy=True)
    assert all(g < bound for g in got)
    assert [g % p for g in got] == [x * x * rinv % p for x in a]
    chain, want = a[:8], [x % p for x in a[:8]]
    for _ in range(300):
        chain = host_product(host_kernels, name, chain, lazy=True)
        want = [x * x * rinv % p for x in want]
    assert all(g < bound for g in chain) and [g % p for g in chain] == want


@pytest.mark.parametrize("lanes", [1, 3, 33, 70])
@pytest.mark.parametrize("name", ["Fp", "Fq"])
def test_kernel_bodies_ragged_lane_counts(host_kernels, name, lanes):
    """Lane counts that fill no block, one block and a bit, two and a bit."""
    _, s = seeded_state(name, lanes, seed=9)
    fwd = host_kernels(name, False, *s, 1)
    assert all(torch.equal(a, b) for a, b in zip(fwd, minroot_eval_plain(name, *s, 1)))
    back = host_kernels(name, True, *fwd, 1)
    assert all(torch.equal(a, b) for a, b in zip(back, minroot_inverse_plain(name, *fwd, 1)))
    assert all(torch.equal(a, b) for a, b in zip(back, s))


@pytest.mark.parametrize("name", ["Fp", "Fq"])
def test_kernel_bodies_match_plain_and_ints(host_kernels, name):
    """70 lanes (full blocks and a ragged one) at t=2."""
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
