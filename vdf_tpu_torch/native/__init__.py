"""The native C++ tier, as the port's host-side oracle.

``pasta.cpp`` is a byte-identical copy of ``vdf_tpu/native/pasta.cpp``
(the port cannot import ``vdf_tpu.native``: ``vdf_tpu`` pulls in jax).
It is never on the commit path: tests and chip_smoke.py hold the CUDA
commit against its CPU Pippenger, ``msm_native``.

The library builds at first use with g++ into
``vdf_tpu_torch/_build/native-<key>/`` (git-ignored), next to the
generated ``pasta_constants.h``; ``<key>`` hashes the source, the header
and the flags.  The finished library is renamed into place, so several
processes (the test workers) can build at once and each sees a whole
library or none.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess

import numpy as np

from ..fields.params import FP, FQ

_SRC = pathlib.Path(__file__).resolve().parent / "pasta.cpp"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC"]  # no -march=native: the build dir may travel


def _fmt_limbs(v: int, n: int = 4) -> str:
    limbs = [(v >> (64 * k)) & ((1 << 64) - 1) for k in range(n)]
    return "{" + ", ".join(f"0x{x:016x}ULL" for x in limbs) + "}"


def constants_header() -> str:
    """pasta_constants.h, as vdf_tpu/native writes it."""
    lines = ["// Generated by vdf_tpu_torch.native — do not edit.", "#pragma once",
             "#include <cstdint>"]
    for name, P in (("FP", FP), ("FQ", FQ)):
        mod = P.modulus
        r = 1 << 256
        lines += [
            f"static const uint64_t {name}_MOD[4] = {_fmt_limbs(mod)};",
            f"static const uint64_t {name}_PINV = 0x{(-pow(mod, -1, 1 << 64)) % (1 << 64):016x}ULL;",
            f"static const uint64_t {name}_R2[4] = {_fmt_limbs((r * r) % mod)};",
            f"static const uint64_t {name}_ONE[4] = {_fmt_limbs(r % mod)};",
            f"static const uint64_t {name}_INVALPHA[4] = {_fmt_limbs(P.inv_alpha)};",
        ]
    return "\n".join(lines) + "\n"


@functools.cache
def load() -> ctypes.CDLL:
    header = constants_header()
    key = hashlib.sha256(_SRC.read_bytes() + header.encode() + " ".join(_FLAGS).encode())
    out_dir = _BUILD_DIR / f"native-{key.hexdigest()[:16]}"
    so = out_dir / "libpasta_native.so"
    if not so.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "pasta_constants.h").write_text(header)
        tmp = out_dir / f"libpasta_native.{os.getpid()}.tmp.so"
        proc = subprocess.run(["g++", *_FLAGS, "-I", str(out_dir), str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on pasta.cpp:\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.msm_native.argtypes = [ctypes.c_int, u64p, u64p, ctypes.c_uint64, u64p]
    lib.msm_native.restype = None
    return lib


def _from_u64(arr) -> int:
    return sum(int(x) << (64 * k) for k, x in enumerate(arr))


def pack_points_u64(points: list[tuple[int, int]]) -> np.ndarray:
    """Affine int pairs -> flat (n*8,) uint64 buffer for msm_native."""
    buf = b"".join(
        px.to_bytes(32, "little") + py.to_bytes(32, "little") for (px, py) in points
    )
    return np.frombuffer(buf, dtype=np.uint64).copy()


def pack_scalars_u64(scalars: list[int]) -> np.ndarray:
    """Canonical ints -> flat (n*4,) uint64 buffer."""
    buf = b"".join(int(s).to_bytes(32, "little") for s in scalars)
    return np.frombuffer(buf, dtype=np.uint64).copy()


def msm_native_packed(curve_name: str, pts_u64: np.ndarray, sc_u64: np.ndarray):
    """Pippenger MSM over pre-packed u64 buffers.  Returns the canonical
    Jacobian (x, y, z) of the sum (affine x = x / z^2, y = y / z^3), or
    None for the identity."""
    lib = load()
    n = sc_u64.shape[0] // 4
    if pts_u64.shape[0] < 8 * n:
        raise ValueError(f"{n} scalars need {8 * n} point words, got {pts_u64.shape[0]}")
    out = np.zeros(12, dtype=np.uint64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.msm_native(
        1 if curve_name == "vesta" else 0,
        pts_u64.ctypes.data_as(u64p),
        sc_u64.ctypes.data_as(u64p),
        n,
        out.ctypes.data_as(u64p),
    )
    x, y, z = _from_u64(out[0:4]), _from_u64(out[4:8]), _from_u64(out[8:12])
    if z == 0:
        return None
    return x, y, z


def msm_native(curve_name: str, points: list[tuple[int, int]], scalars: list[int]):
    """Pippenger MSM over exact ints; Jacobian (x, y, z) or None."""
    return msm_native_packed(curve_name, pack_points_u64(points), pack_scalars_u64(scalars))


def msm_native_affine(curve_name: str, points: list[tuple[int, int]], scalars: list[int]):
    """``msm_native`` as affine ints (x, y), or None for the identity."""
    out = msm_native(curve_name, points, scalars)
    if out is None:
        return None
    x, y, z = out
    mod = (FP if curve_name == "pallas" else FQ).modulus
    zi = pow(z, -1, mod)
    return x * zi * zi % mod, y * zi * zi % mod * zi % mod
