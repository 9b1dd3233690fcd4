"""The native C++ tier: the port's host-side oracle and a required part
of its host control plane.

``pasta.cpp`` is a byte-identical copy of ``vdf_tpu/native/pasta.cpp``
(the port cannot import ``vdf_tpu.native``: ``vdf_tpu`` pulls in jax).
It never runs on the card.  It serves two roles:

  * the oracle: tests and chip_smoke.py hold the CUDA commit against its
    CPU Pippenger, ``msm_native``;
  * the host tier of the two-curve IVC (nova/ivc.py): the Pippenger of the
    ``"native"`` engine's commits, and on either engine the witness
    emitters of the host control plane, ``poseidon_permute_native`` (the
    transcripts and the in-circuit sponge's S-box values) and
    ``ec_fold_witness_native`` (the in-circuit instance fold's point
    values), whose ``*_words`` forms hand the values over as the
    ``(k, 4)`` uint64 block the value-only witness keeps, and the
    instance fold ``Side.fold_instance`` (``fold_points_native_or_none``:
    a P + b Q, batched).  The host IPA folds its generators with
    ``fold_points_native`` (spartan/host.py); the bench's baseline is
    ``minroot_eval_native``.

Nothing falls back to Python: a failed build raises, and
``poseidon/int_poseidon.py::checked_native`` raises where the permutation
disagrees with the Python rounds.  The library builds at first use, never
at import, with g++ into
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
    lib.minroot_eval_native.argtypes = [ctypes.c_int, u64p, ctypes.c_uint64]
    lib.minroot_inverse_native.argtypes = [ctypes.c_int, u64p, ctypes.c_uint64]
    lib.fold_points_native.argtypes = [
        ctypes.c_int, u64p, u64p, u64p, u64p, ctypes.c_uint64, u64p, u64p,
    ]
    lib.poseidon_witness_native.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u64p, u64p, u64p, u64p,
    ]
    lib.ec_fold_witness_native.argtypes = [ctypes.c_int, u64p, u64p, u64p, ctypes.c_int, u64p]
    for fn in (lib.msm_native, lib.minroot_eval_native, lib.minroot_inverse_native,
               lib.fold_points_native, lib.poseidon_witness_native, lib.ec_fold_witness_native):
        fn.restype = None
    return lib


def _to_u64(v: int, n: int = 4) -> list[int]:
    return [(v >> (64 * k)) & ((1 << 64) - 1) for k in range(n)]


def _u64_buffer(values) -> np.ndarray:
    """Canonical ints -> flat (4 len(values),) uint64 buffer."""
    return np.frombuffer(b"".join(int(v).to_bytes(32, "little") for v in values),
                         dtype=np.uint64).copy()


def ints_of_u64(buf: np.ndarray) -> list[int]:
    """Canonical uint64 words, 4 a value (flat or ``(k, 4)``) -> k ints."""
    raw = buf.tobytes()
    return [int.from_bytes(raw[k : k + 32], "little") for k in range(0, len(raw), 32)]


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


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


def _minroot_native(fn_name: str, field_name: str, x: int, y: int, i: int, t: int):
    st = _u64_buffer((x, y, i))
    getattr(load(), fn_name)(1 if field_name == "Fq" else 0, _ptr(st), t)
    return tuple(ints_of_u64(st))


def minroot_eval_native(field_name: str, x: int, y: int, i: int, t: int):
    """t forward MinRoot rounds over exact ints (canonical in and out)."""
    return _minroot_native("minroot_eval_native", field_name, x, y, i, t)


def minroot_inverse_native(field_name: str, x: int, y: int, i: int, t: int):
    """t inverse MinRoot rounds over exact ints (canonical in and out)."""
    return _minroot_native("minroot_inverse_native", field_name, x, y, i, t)


@functools.lru_cache(maxsize=8)
def _poseidon_packed(field_name: str, width: int):
    from ..poseidon.params import FULL_ROUNDS, partial_rounds, round_constants

    rc, mds = round_constants(field_name, width)
    r_p = partial_rounds(width)
    half = FULL_ROUNDS // 2
    n_sbox = half * width + r_p + (FULL_ROUNDS - half) * width
    rc_buf = _u64_buffer([c for row in rc for c in row])
    mds_buf = _u64_buffer([c for row in mds for c in row])
    # the buffers stay referenced beside their pointers
    return rc_buf, mds_buf, _ptr(rc_buf), _ptr(mds_buf), half, r_p, FULL_ROUNDS, n_sbox


def _poseidon(field_name: str, state: list[int], tri: np.ndarray | None) -> list[int]:
    width = len(state)
    _, _, rc, mds, half, r_p, full, _ = _poseidon_packed(field_name, width)
    st = _u64_buffer(state)
    load().poseidon_witness_native(1 if field_name == "Fq" else 0, width, half, r_p, full,
                                   rc, mds, _ptr(st), _ptr(tri) if tri is not None else None)
    return ints_of_u64(st)


def poseidon_permute_native(field_name: str, state: list[int], emit_triples: bool = False):
    """One Poseidon permutation over canonical ints (the same values as
    poseidon/int_poseidon.py's Python rounds).  With ``emit_triples``, also
    every S-box's (x^2, x^4, x^5) in the in-circuit sponge's allocation
    order (nova/gadgets/sponge.py): the witness values of the augmented
    circuit's transcript gadgets."""
    if not emit_triples:
        return _poseidon(field_name, state, None)
    out, tri = poseidon_permute_native_words(field_name, state)
    return out, ints_of_u64(tri)


def poseidon_permute_native_words(field_name: str, state: list[int]):
    """``poseidon_permute_native(emit_triples=True)`` with the S-box values
    left as a ``(3 n_sbox, 4)`` uint64 array of canonical words: -> (the
    output state as ints, that array)."""
    n_sbox = _poseidon_packed(field_name, len(state))[-1]
    tri = np.zeros((3 * n_sbox, 4), dtype=np.uint64)
    return _poseidon(field_name, state, tri), tri


def ec_fold_witness_native(field_name: str, base_proj: tuple[int, int, int],
                           pt_proj: tuple[int, int, int], r_bits_msb: list[int]) -> list[int]:
    """Every witness value of one in-circuit scaled add (the instance fold of
    nova/gadgets/instance.py: base + r pt by MSB-first double-and-add on the
    complete projective formulas), in the gadget's allocation order: a flat
    list of n_bits 23 + 12 + 4 canonical ints, the last 4 being (inf, zinv,
    x, y) of the affine result."""
    return ints_of_u64(ec_fold_witness_native_words(field_name, base_proj, pt_proj, r_bits_msb))


def ec_fold_witness_native_words(field_name: str, base_proj: tuple[int, int, int],
                                 pt_proj: tuple[int, int, int], r_bits_msb) -> np.ndarray:
    """``ec_fold_witness_native`` as a ``(n_bits 23 + 16, 4)`` uint64 array
    of canonical words; ``r_bits_msb`` a list or an array of 0/1."""
    n_bits = len(r_bits_msb)
    out = np.zeros((n_bits * 23 + 12 + 4, 4), dtype=np.uint64)
    load().ec_fold_witness_native(1 if field_name == "Fq" else 0, _ptr(_u64_buffer(base_proj)),
                                  _ptr(_u64_buffer(pt_proj)),
                                  _ptr(np.ascontiguousarray(r_bits_msb, dtype=np.uint64)),
                                  n_bits, _ptr(out))
    return out


def fold_points_native_or_none(curve_name: str, pts_p: list[tuple[int, int]],
                               pts_q: list[tuple[int, int]], a: int,
                               b: int) -> list[tuple[int, int] | None]:
    """out[i] = a P[i] + b Q[i], batched (one inversion), affine canonical in
    and out; None where a result is the identity (the row pasta.cpp flags)."""
    n = len(pts_p)
    if len(pts_q) != n:
        raise ValueError(f"{n} points P and {len(pts_q)} points Q")
    out = np.zeros(n * 8, dtype=np.uint64)
    flags = np.zeros(n, dtype=np.uint64)
    load().fold_points_native(1 if curve_name == "vesta" else 0, _ptr(pack_points_u64(pts_p)),
                              _ptr(pack_points_u64(pts_q)), _ptr(_u64_buffer([a])),
                              _ptr(_u64_buffer([b])), n, _ptr(out), _ptr(flags))
    vals = ints_of_u64(out)
    return [None if flags[i] else (vals[2 * i], vals[2 * i + 1]) for i in range(n)]


def fold_points_native(curve_name: str, pts_p: list[tuple[int, int]],
                       pts_q: list[tuple[int, int]], a: int, b: int) -> list[tuple[int, int]]:
    """``fold_points_native_or_none`` where no result may be the identity
    (it has no affine form): raises if one is."""
    out = fold_points_native_or_none(curve_name, pts_p, pts_q, a, b)
    if any(v is None for v in out):
        raise ValueError("fold_points_native produced an identity point")
    return out
