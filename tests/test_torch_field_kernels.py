"""The device plane's field kernels K10-K12 (vdf_tpu_torch.fields.kernels:
``field_ew``, ``field_segsum``, ``r1cs_matvec``) and the callers routed
through them.

On the CPU: the plain versions against the JAX package's field ops,
``_sum_rows`` and ``DeviceMatrix.matvec`` on the same seeded inputs; the
kernel bodies of csrc/field_ops.cuh compiled with g++ as host code (CUDA
qualifiers defined away, ``threadIdx``/``blockIdx`` emulated, K11's and
K12's lanes run one after another before their combine step) against
Python integers and the plain versions, with the worst-case accumulators,
empty segments and the corners 0, p - 1 and 2^256 - 1; the row-sorted
matvec against the unsorted COO and blocks of entries against the whole;
the dispatch.  Tolerance is exact equality everywhere: every output is
canonical integer arithmetic.  On the card (no jax there), each kernel
against its plain version: tests/test_torch_build.py -m gpu and
chip_smoke.py.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from vdf_tpu.fields import get_field as jax_get_field
from vdf_tpu.nova import augmented as jax_augmented
from vdf_tpu.nova.r1cs_device import DeviceShape as JaxDeviceShape
from vdf_tpu.spartan.sumcheck import _sum_rows as jax_sum_rows
from vdf_tpu_torch import _build, interop
from vdf_tpu_torch.curves import CURVES, get_curve, hash_to_curve_ints, stack_point
from vdf_tpu_torch.curves import kernels as CK
from vdf_tpu_torch.curves.bucket_msm import layout
from vdf_tpu_torch.errors import KernelError
from vdf_tpu_torch.fields import FIELDS, get_field
from vdf_tpu_torch.fields import kernels as FK
from vdf_tpu_torch.fields import ops as field_ops
from vdf_tpu_torch.fields.ops import Field
from vdf_tpu_torch.nova import augmented
from vdf_tpu_torch.nova.r1cs_device import DeviceMatrix, DeviceShape
from vdf_tpu_torch.spartan.sumcheck import _sum_rows

# The plain versions are many small tensor ops: one intra-op thread runs
# them fastest, and test workers sharing the cores do not oversubscribe
# them (with a thread pool per worker they ran ~10x slower under load).
torch.set_num_threads(1)

NAMES = ["Fp", "Fq"]
OPS = ["add", "sub", "mul", "sqr", "neg", "canon"]
R = 1 << 256
ALL_ONES = R - 1


def limbs(vals) -> torch.Tensor:
    """Integers below 2^256 as (n, 8) int32 limb bit patterns."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return torch.from_numpy(np.frombuffer(raw, dtype="<u4").reshape(-1, 8).view(np.int32).copy())


def ints(t: torch.Tensor) -> list[int]:
    raw = t.reshape(-1, 8).contiguous().numpy().astype("<u4").tobytes()
    return [int.from_bytes(raw[k : k + 32], "little") for k in range(0, len(raw), 32)]


def corners(p: int) -> list[int]:
    """0, p - 1 and 2^256 - 1, with 1, p, 2p - 1, 2^255 and R mod p."""
    return [0, 1, p - 1, p, 2 * p - 1, 1 << 255, R % p, ALL_ONES]


def seeded(p: int, n: int, seed: int, canonical: bool = True) -> list[int]:
    nrng = np.random.default_rng(seed)
    vals = [int.from_bytes(nrng.bytes(32), "little") for _ in range(n)]
    return [v % p for v in vals] if canonical else vals


# ---------------------------------------------------------------------
# Python-integer models of the plain versions (the digit code of
# fields/ops.py), exact on any 256-bit input
# ---------------------------------------------------------------------


def m_cond_sub(v, m):
    return v - m if v >= m else v


def m_canon(p, v):
    return m_cond_sub(m_cond_sub(v, 2 * p), p)


def m_add(p, a, b):
    return m_cond_sub((a + b) % R, p)


def m_sub(p, a, b):
    return m_canon(p, (a + 2 * p - b) % R)


def m_mul(p, a, b):
    """REDC as mul16 computes it: (a b + m p) / R mod 2^256, then < 2p -> < p."""
    t = a * b
    m = (-t * pow(p, -1, R)) % R
    return m_cond_sub(((t + m * p) >> 256) % R, p)


def m_op(p, op, a, b=None, c=None):
    if op == "add":
        return m_add(p, a, b)
    if op == "sub":
        return m_sub(p, a, b)
    if op == "mul":
        return m_mul(p, a, b)
    if op == "sqr":
        return m_mul(p, a, a)
    if op == "neg":
        return m_sub(p, 0, m_canon(p, a))
    if op == "canon":
        return m_canon(p, a)
    return m_add(p, a, m_mul(p, b, c))  # fold a + r b, operands (a, r, b)


def m_reduce_wide(p, s):
    """reduce_wide16 of an exact sum below 2^288."""
    lo, hi = s % R, s >> 256
    return m_cond_sub((m_canon(p, lo) + m_mul(p, hi, R * R % p)) % R, p)


# ---------------------------------------------------------------------
# plain versions against the JAX package
# ---------------------------------------------------------------------


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", NAMES)
def test_ew_plain_equals_jax_field_op(name, op):
    """Field.<op> on CPU tensors (the plain K10) against the JAX package's
    Field.<op> on the same seeded canonical values, at the canonical
    integers; the public method and field_ew_plain give the same bits."""
    p = FIELDS[name].modulus
    a = [0, 1, p - 1] + seeded(p, 40, seed=101)
    b = [p - 1, 0, p - 1] + seeded(p, 40, seed=102)
    f, jf = get_field(name), jax_get_field(name)
    ta, tb = f.encode(a, device="cpu"), f.encode(b, device="cpu")
    args = (ta,) if FK.EW_OPS[op][1] == 1 else (ta, tb)
    got = FK.field_ew_plain(name, op, *args)
    assert torch.equal(getattr(f, op)(*args), got)
    jargs = tuple(interop.to_jax(name, t) for t in args)
    want = getattr(jf, op)(*jargs)
    assert f.decode(got) == interop.jax_limbs_to_ints(name, want)
    assert all(g < p for g in ints(got))


@pytest.mark.parametrize("name", NAMES)
def test_fold_equals_add_of_mul_in_both_packages(name):
    """The linear fold a + r b with r broadcast (one element, stride 0):
    field_ew_plain's fold, Field.fold and f.add(a, f.mul(r, b)) on the port,
    jf.add(a, jf.mul(r, b)) in the JAX package."""
    p = FIELDS[name].modulus
    a, b = seeded(p, 33, seed=103), seeded(p, 33, seed=104)
    a[:2], b[:2] = [p - 1, 0], [p - 1, p - 1]
    r = seeded(p, 1, seed=105)[0]
    f, jf = get_field(name), jax_get_field(name)
    ta, tb, tr = f.encode(a, device="cpu"), f.encode(b, device="cpu"), f.encode(r, device="cpu")
    got = f.fold(ta, tr, tb)
    assert torch.equal(got, FK.field_ew_plain(name, "fold", ta, tr.expand_as(tb), tb))
    assert torch.equal(got, f.add(ta, f.mul(tr.expand_as(tb), tb)))
    ja, jb = (interop.to_jax(name, t) for t in (ta, tb))
    jr = interop.to_jax(name, tr[None].expand_as(tb))
    assert f.decode(got) == interop.jax_limbs_to_ints(name, jf.add(ja, jf.mul(jr, jb)))
    assert f.decode(got) == [(x + r * y) % p for x, y in zip(a, b)]


@pytest.mark.parametrize("n", [1, 37, 300])
@pytest.mark.parametrize("name", NAMES)
def test_segsum_plain_equals_jax_sum_rows(name, n):
    """field_segsum_plain (one segment, and through _sum_rows along either
    axis) against vdf_tpu/spartan/sumcheck.py:20 on the same seeded rows."""
    p = FIELDS[name].modulus
    vals = seeded(p, 3 * n, seed=106 + n)
    vals[:2] = [p - 1, p - 1][: len(vals)]
    f = get_field(name)
    t = f.encode(vals, device="cpu").reshape(3, n, 8)
    jf = jax_get_field(name)
    want = [interop.jax_limbs_to_ints(name, jax_sum_rows(jf, interop.to_jax(name, t[k])))[0]
            for k in range(3)]
    assert want == [sum(vals[k * n : (k + 1) * n]) % p for k in range(3)]
    rows = _sum_rows(f, t, dim=1)
    assert f.decode(rows) == want
    for k in range(3):
        assert torch.equal(FK.field_segsum_plain(name, t[k], segments=1)[0], rows[k])
    cols = _sum_rows(f, t.transpose(0, 1), dim=1)  # (n, 3) -> sum over the 3
    assert f.decode(cols) == [sum(vals[j :: n]) % p for j in range(n)]
    offsets = torch.tensor([0, n, n, 3 * n], dtype=torch.int64)  # an empty segment
    by_off = FK.field_segsum_plain(name, t.reshape(-1, 8), offsets)
    assert f.decode(by_off) == [want[0], 0, (want[1] + want[2]) % p]


@pytest.fixture(scope="module")
def augmented_primary():
    """The primary of make_circuits(1) (the shape entry.py folds) in both
    packages, as device shapes on the CPU, and a seeded z."""
    shape = augmented.make_circuits(1)[0].shape()
    jshape = jax_augmented.make_circuits(1)[0].shape()
    f, jf = get_field("Fq"), jax_get_field("Fq")
    n_z = shape.num_aux + 1 + shape.num_inputs
    z = f.encode(seeded(f.params.modulus, n_z, seed=107), device="cpu")
    return shape, DeviceShape.build(f, shape, device="cpu"), JaxDeviceShape.build(jf, jshape), z


def test_matvec_plain_equals_jax_on_the_augmented_shape(augmented_primary):
    """DeviceMatrix.matvec (the plain K12) of A, B and C of the real t = 1
    augmented primary shape against vdf_tpu/nova/r1cs_device.py:28."""
    _, dev, jdev, z = augmented_primary
    f, jf = get_field("Fq"), jax_get_field("Fq")
    jz = interop.to_jax("Fq", z)
    for m, jm in ((dev.a, jdev.a), (dev.b, jdev.b), (dev.c, jdev.c)):
        got = m.matvec(f, z)
        assert got.shape == (m.num_rows, 8)
        assert f.decode(got) == interop.jax_limbs_to_ints("Fq", jm.matvec(jf, jz))


def test_matvec_row_sorted_equals_unsorted_coo(augmented_primary):
    """DeviceShape.build keeps each matrix in row order with its CSR offsets;
    the product equals that of the shape's COO shuffled (the plain version
    sums by row id in any order), and the offsets are the rows' bounds."""
    shape, dev, _, z = augmented_primary
    f = get_field("Fq")
    nrng = np.random.default_rng(108)
    for coo, m in zip((shape.a_coo, shape.b_coo, shape.c_coo), (dev.a, dev.b, dev.c)):
        rows = m.rows
        assert bool((rows[1:] >= rows[:-1]).all())
        counts = torch.bincount(rows, minlength=m.num_rows)
        assert torch.equal(m.offsets, torch.cat([torch.zeros(1, dtype=torch.int64),
                                                 counts.cumsum(0)]))
        perm = nrng.permutation(len(coo[0]))
        r = torch.from_numpy(np.asarray(coo[0], dtype=np.int64)[perm])
        c = torch.from_numpy(np.asarray(coo[1], dtype=np.int64)[perm])
        v = f.encode([int(coo[2][k]) for k in perm], device="cpu")
        unsorted = FK.r1cs_matvec_plain("Fq", r, c, v, z, m.num_rows)
        assert torch.equal(m.matvec(f, z), unsorted)


# ---------------------------------------------------------------------
# the kernel bodies, compiled with g++ as host code
# ---------------------------------------------------------------------

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
#include "field_ops.cuh"

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

// K10 over n elements, block after block, thread after thread.
extern "C" void ew(int field, int op, const uint32_t* a, const uint32_t* b, const uint32_t* c,
                   uint32_t* out, int64_t n, int bcast) {
  const EwFn kernel = field ? ew_kernel<1>(op) : ew_kernel<0>(op);
  const int64_t blocks = (n + vdf::EW_BLOCK - 1) / vdf::EW_BLOCK;
  for (int64_t blk = 0; blk < blocks; ++blk) {
    for (int th = 0; th < vdf::EW_BLOCK; ++th) {
      blockIdx.x = (unsigned)blk;
      threadIdx.x = (unsigned)th;
      kernel(a, b, c, out, n, bcast);
    }
  }
}

// The 32 lanes' partial sums in the [limb][lane] layout the warp shares,
// then the combine step that lane 0 runs.
template <int K, class Lane>
void warp_segment(uint32_t* out, Lane lane_sum) {
  uint32_t parts[vdf::WL * vdf::WARP], acc[vdf::WL];
  for (int lane = vdf::WARP - 1; lane >= 0; --lane) {  // any order: lanes share nothing
    lane_sum(acc, lane);
    for (int j = 0; j < vdf::WL; ++j) parts[j * vdf::WARP + lane] = acc[j];
  }
  vdf::segment_combine<K>(out, parts);
}

extern "C" void segsum(int field, const uint32_t* x, const int64_t* offsets, uint32_t* out,
                       int64_t segments, int64_t seg_len) {
  for (int64_t s = 0; s < segments; ++s) {
    int64_t begin, end;
    vdf::segment_of(offsets, seg_len, s, begin, end);
    auto lane_sum = [&](uint32_t* acc, int lane) { vdf::segsum_lane(acc, x, begin, end, lane); };
    field ? warp_segment<1>(out + 8 * s, lane_sum) : warp_segment<0>(out + 8 * s, lane_sum);
  }
}

extern "C" void matvec(int field, const int64_t* offsets, const int64_t* cols,
                       const uint32_t* vals, const uint32_t* z, uint32_t* out, int64_t rows) {
  for (int64_t r = 0; r < rows; ++r) {
    const int64_t begin = offsets[r], end = offsets[r + 1];
    if (field) {
      warp_segment<1>(out + 8 * r, [&](uint32_t* acc, int lane) {
        vdf::matvec_lane<1>(acc, cols, vals, z, begin, end, lane);
      });
    } else {
      warp_segment<0>(out + 8 * r, [&](uint32_t* acc, int lane) {
        vdf::matvec_lane<0>(acc, cols, vals, z, begin, end, lane);
      });
    }
  }
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel bodies as host code")
    d = tmp_path_factory.mktemp("field_ops_host")
    (d / _build.CONSTS_HEADER).write_text(_build.constants_header())
    (d / "shim.cpp").write_text(HOST_SHIM)
    so = d / "libfield_ops_host.so"
    proc = subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Wno-unknown-pragmas",
         "-Wno-unused-function", "-I", str(_build.CSRC_DIR), "-I", str(d), "-o", str(so),
         str(d / "shim.cpp")],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ew.argtypes = [ci, ci, vp, vp, vp, vp, i64, ci]
    lib.segsum.argtypes = [ci, vp, vp, vp, i64, i64]
    lib.matvec.argtypes = [ci, vp, vp, vp, vp, vp, i64]
    for fn in (lib.ew, lib.segsum, lib.matvec):
        fn.restype = None
    return lib


def host_ew(lib, name, op, *operands):
    """K10's body on CPU tensors: (n, 8) operands, or one element (8,)
    broadcast with its flag."""
    n = max(a.shape[0] for a in operands if a.dim() == 2)
    out = torch.empty((n, 8), dtype=torch.int32)
    bcast = sum(1 << k for k, a in enumerate(operands) if a.dim() == 1)
    keep = [a.contiguous() for a in operands]
    ptrs = [a.data_ptr() for a in keep] + [None] * (3 - len(keep))
    lib.ew(_build.FIELD_INDEX[name], FK.EW_OPS[op][0], *ptrs, out.data_ptr(), n, bcast)
    return out


def host_segsum(lib, name, x, offsets=None, segments=None):
    x = x.contiguous()
    if offsets is None:
        seg_len = x.shape[0] // segments if segments else 0
        off_ptr = None
    else:
        offsets = offsets.contiguous()
        segments, seg_len, off_ptr = offsets.shape[0] - 1, 0, offsets.data_ptr()
    out = torch.empty((segments, 8), dtype=torch.int32)
    lib.segsum(_build.FIELD_INDEX[name], x.data_ptr(), off_ptr, out.data_ptr(), segments,
               seg_len)
    return out


def host_matvec(lib, name, offsets, cols, vals, z):
    args = [a.contiguous() for a in (offsets, cols, vals, z)]
    out = torch.empty((offsets.shape[0] - 1, 8), dtype=torch.int32)
    lib.matvec(_build.FIELD_INDEX[name], *(a.data_ptr() for a in args), out.data_ptr(),
               out.shape[0])
    return out


@pytest.mark.parametrize("op", OPS + ["fold"])
@pytest.mark.parametrize("name", NAMES)
def test_ew_body_equals_ints_and_plain_on_any_limbs(host, name, op):
    """Every K10 op over the corners crossed with each other and seeded
    256-bit patterns (canonical or not, 300 elements: a ragged second
    block): the body, the plain version and the Python model agree bit
    for bit, and on canonical inputs give the field's value."""
    p = FIELDS[name].modulus
    cs = corners(p)
    a = [x for x in cs for _ in cs] + seeded(p, 120, 109) + seeded(p, 116, 110, canonical=False)
    b = [y for _ in cs for y in cs] + seeded(p, 120, 111) + seeded(p, 116, 112, canonical=False)
    c = b[::-1]
    arity = FK.EW_OPS[op][1]
    args = (limbs(a), limbs(b), limbs(c))[:arity]
    got = host_ew(host, name, op, *args)
    assert torch.equal(got, FK.field_ew_plain(name, op, *args))
    assert ints(got) == [m_op(p, op, *v) for v in zip(a, b, c)]
    canon = [k for k, v in enumerate(zip(a, b, c)) if max(v[:arity]) < p]
    rinv = pow(R, -1, p)
    field_value = {"add": lambda x, y, z: (x + y) % p, "sub": lambda x, y, z: (x - y) % p,
                   "mul": lambda x, y, z: x * y * rinv % p, "sqr": lambda x, y, z: x * x * rinv % p,
                   "neg": lambda x, y, z: -x % p, "canon": lambda x, y, z: x,
                   "fold": lambda x, y, z: (x + y * z * rinv) % p}[op]
    got_ints = ints(got)
    assert all(got_ints[k] == field_value(a[k], b[k], c[k]) for k in canon)


@pytest.mark.parametrize("name", NAMES)
def test_ew_body_broadcasts_one_element(host, name):
    """A stride-0 operand (the fold's r, a constant) in each position."""
    p = FIELDS[name].modulus
    a, b = limbs(seeded(p, 70, 113)), limbs(seeded(p, 70, 114))
    one = limbs([p - 1])[0]
    assert torch.equal(host_ew(host, name, "fold", a, one, b),
                       FK.field_ew_plain(name, "fold", a, one.expand_as(b), b))
    assert torch.equal(host_ew(host, name, "mul", one, b),
                       FK.field_ew_plain(name, "mul", one.expand_as(b), b))
    assert torch.equal(host_ew(host, name, "sub", a, one),
                       FK.field_ew_plain(name, "sub", a, one.expand_as(a)))


@pytest.mark.parametrize("name", NAMES)
def test_segsum_body_worst_cases_and_empty_segments(host, name):
    """K11's body: a segment of 2^16 copies of p - 1 and one of 2^16 copies
    of 2^256 - 1 (a 272-bit sum), empty segments, one-element segments and
    seeded runs, by offsets and as equal segments, against Python ints and
    the plain version."""
    p = FIELDS[name].modulus
    long = 1 << 16
    vals = [p - 1] * long + [ALL_ONES] * long + seeded(p, 100, 115) + [ALL_ONES, 0, p - 1]
    x = limbs(vals)
    bounds = [0, long, 2 * long, 2 * long, 2 * long + 1, 2 * long + 100, len(vals), len(vals)]
    offsets = torch.tensor(bounds, dtype=torch.int64)
    got = host_segsum(host, name, x, offsets)
    want = [m_reduce_wide(p, sum(vals[lo:hi])) for lo, hi in zip(bounds, bounds[1:])]
    assert ints(got) == want
    assert want[0] == long * (p - 1) % p and want[2] == 0 and want[-1] == 0
    assert torch.equal(got, FK.field_segsum_plain(name, x, offsets))
    eq = host_segsum(host, name, x[: 2 * long], segments=2)
    assert torch.equal(eq, got[:2]) and torch.equal(eq, FK.field_segsum_plain(
        name, x[: 2 * long], segments=2))
    assert host_segsum(host, name, x[:0], segments=3).tolist() == [[0] * 8] * 3


@pytest.mark.parametrize("name", NAMES)
def test_matvec_body_worst_row_and_empty_rows(host, name):
    """K12's body: a row of MAX_ROW_NNZ = 2^15 entries of p - 1 times z = p - 1
    (every product R^-1, the row 2^15 R^-1), a row of 2^15 entries whose
    products are p - 1, empty rows first, between and last, and seeded short
    rows, against Python ints and the plain version."""
    p = FIELDS[name].modulus
    rinv = pow(R, -1, p)
    nnz = 1 << 15
    z_ints = [p - 1, R % p] + seeded(p, 30, 116)  # (p - 1) (R mod p) / R = p - 1
    z = limbs(z_ints)
    nrng = np.random.default_rng(117)
    short = [(int(nrng.integers(2, 32)), v) for v in seeded(p, 40, 118)]
    row_entries = [[], [(0, p - 1)] * nnz, [], [(1, p - 1)] * nnz, *([e] for e in short), []]
    rows = [r for r, es in enumerate(row_entries) for _ in es]
    cols = [c for es in row_entries for c, _ in es]
    vals = [v for es in row_entries for _, v in es]
    counts = [len(es) for es in row_entries]
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int64)
    cols_t, rows_t = (torch.tensor(a, dtype=torch.int64) for a in (cols, rows))
    got = host_matvec(host, name, offsets, cols_t, limbs(vals), z)
    want = [sum(v * z_ints[c] for c, v in es) * rinv % p for es in row_entries]
    assert ints(got) == want
    assert want[1] == nnz * rinv % p and want[3] == nnz * (p - 1) % p and want[0] == 0
    assert torch.equal(got, FK.r1cs_matvec_plain(name, rows_t, cols_t, limbs(vals), z,
                                                 len(row_entries)))


def test_matvec_body_blocks_of_entries_sum_to_the_whole(host, augmented_primary):
    """The sharded case: the augmented primary's A split into three blocks
    of entries at points inside rows; each block's CSR offsets come from
    searchsorted on its rows (DeviceMatrix), the body and the plain version
    agree on each block, and the blocks' field sum is the whole product."""
    _, dev, _, z = augmented_primary
    f, m = get_field("Fq"), dev.a
    whole = host_matvec(host, "Fq", m.offsets, m.cols, m.vals, z)
    assert torch.equal(whole, m.matvec(f, z))
    nnz = m.rows.shape[0]
    inside = [k for k in range(1, nnz) if m.rows[k - 1] == m.rows[k]]  # cuts that split a row
    cuts = [0, inside[len(inside) // 3], inside[2 * len(inside) // 3], nnz]
    acc = None
    for lo, hi in zip(cuts, cuts[1:]):
        block = DeviceMatrix(m.rows[lo:hi], m.cols[lo:hi], m.vals[lo:hi], m.num_rows)
        part = host_matvec(host, "Fq", block.offsets, block.cols, block.vals, z)
        assert torch.equal(part, block.matvec(f, z))
        acc = part if acc is None else f.add(acc, part)
    assert torch.equal(acc, whole)


# ---------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------


def _no_plain(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a tensor that is not on the CPU")

    for name in ("field_ew_plain", "field_segsum_plain", "r1cs_matvec_plain"):
        monkeypatch.setattr(FK, name, refuse)


def test_meta_tensors_raise_and_never_run_the_plain_versions(monkeypatch):
    _no_plain(monkeypatch)
    f = get_field("Fq")
    a = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    idx = torch.zeros(4, dtype=torch.int64, device="meta")
    for call in (lambda: f.add(a, a), lambda: f.mul(a, a), lambda: f.fold(a, a[0], a),
                 lambda: f.canon(a), lambda: f.neg(a), lambda: f.sqr(a),
                 lambda: FK.field_segsum("Fq", a, segments=2),
                 lambda: FK.r1cs_matvec("Fq", idx, torch.zeros(3, dtype=torch.int64,
                                                               device="meta"), idx, a, a)):
        with pytest.raises(KernelError, match="no kernel for device meta"):
            call()


def test_malformed_operands_raise_kernel_error():
    f = get_field("Fp")
    a = f.encode([1, 2, 3], device="cpu")
    idx = torch.zeros(3, dtype=torch.int64)
    bad = [
        lambda: FK.field_ew("Fr", "add", a, a),
        lambda: FK.field_ew("Fp", "pow", a, a),
        lambda: FK.field_ew("Fp", "add", a),
        lambda: FK.field_ew("Fp", "add", a, a.to(torch.int64)),
        lambda: FK.field_ew("Fp", "mul", a, a[:, :4]),
        lambda: FK.field_ew("Fp", "sub", a, a.to("meta")),
        lambda: FK.field_segsum("Fp", a, segments=2),
        lambda: FK.field_segsum("Fp", a.reshape(3, 1, 8), segments=3),
        lambda: FK.field_segsum("Fp", a, offsets=idx.to(torch.int32)),
        lambda: FK.r1cs_matvec("Fp", idx, torch.tensor([0, 3]), idx[:2], a, a),
        lambda: FK.r1cs_matvec("Fp", idx, torch.tensor([0, 3]), idx, a, a.reshape(-1)),
    ]
    for call in bad:
        with pytest.raises(KernelError):
            call()


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    FK.reset_launches()
    field_ops.reset_digit_calls()
    f = get_field("Fq")
    a = f.encode([5, 6], device="cpu")
    assert f.decode(f.fold(a, a[0], a)) == [30, 36]
    assert f.decode(_sum_rows(f, a)) == 11
    assert FK.LAUNCHES == dict.fromkeys(FK.LAUNCHES, 0)
    assert field_ops.digit_calls() == 0  # the CPU is not counted


def _routed_ops_raise(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version of K1-K9 called a routed Field op")

    for op in ("add", "sub", "mul", "sqr", "neg", "canon", "fold", "pow", "inv", "eq",
               "is_zero", "from_mont", "to_mont"):
        monkeypatch.setattr(Field, op, refuse)


def test_k1_plain_touches_no_routed_op(monkeypatch):
    """minroot_eval_plain / minroot_inverse_plain run on the digit methods
    alone, so they stay independent of K10, which they help check."""
    name = "Fq"
    p = FIELDS[name].modulus
    f = get_field(name)
    s = tuple(f.encode(seeded(p, 5, seed), device="cpu") for seed in (119, 120, 121))
    want_fwd = FK.minroot_eval_plain(name, *s, 2)
    _routed_ops_raise(monkeypatch)
    fwd = FK.minroot_eval_plain(name, *s, 2)
    back = FK.minroot_inverse_plain(name, *fwd, 2)
    assert all(torch.equal(x, y) for x, y in zip(fwd, want_fwd))
    assert all(torch.equal(x, y) for x, y in zip(back, s))


def test_k3_and_k4_plain_touch_no_routed_op(monkeypatch):
    """canon_digits_plain and bucket_scan_plain (K3, K4) on a small commit's
    inputs give the same bits with every routed Field op made to raise."""
    curve_name, n, rows = "pallas", 6, 5
    c = get_curve(curve_name)
    params = CURVES[curve_name]
    gens = stack_point(c.from_affine_ints(
        hash_to_curve_ints(curve_name, n, domain=b"vdf_tpu/t"), device="cpu")).contiguous()
    table = CK.shift_gens_plain(params.base_field, gens)
    q = c.scalar.params.modulus
    s = c.scalar.encode([0, 1, q - 1, *seeded(q, n - 3, 122)], device="cpu")[None]
    _, m_pad = layout(n, rows)

    def run():
        keys = torch.sort(CK.canon_digits_plain(params.scalar_field, s, m_pad), -1).values
        return keys, CK.bucket_scan_plain(params.base_field, table, keys, rows)

    want_keys, want = run()
    _routed_ops_raise(monkeypatch)
    keys, got = run()
    assert torch.equal(keys, want_keys)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
