"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

``load_kernels()`` compiles ``csrc/*.cu`` for ``sm_90a`` (one nvcc a
source, in parallel) and links them into one shared library with a
plain C interface, at first use, under
``vdf_tpu_torch/_build/<key>/`` (git-ignored), where ``<key>`` hashes the
sources, the generated constants header and the compiler flags, so an
edit rebuilds and an unchanged tree reuses the library.  The field and
curve constants reach the kernels through ``vdf_consts.h``, generated
from fields/params.py and curves/point.py, so Python and CUDA share one
source of truth.  ``LAUNCHERS`` lists every C launcher with its ctypes
argument types.

A missing ``nvcc`` or a failed compile raises ``KernelError`` carrying
the compiler's output; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

from .curves.point import B3
from .errors import KernelError
from .fields.params import FIELDS, NLIMBS, int_to_limbs

PKG_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
DEFAULT_CUDA_HOME = pathlib.Path("/usr/local/cuda")
FIELD_INDEX = {"Fp": 0, "Fq": 1}  # the kernels' field argument
CONSTS_HEADER = "vdf_consts.h"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in build.log
]
NVCC_LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]
NVCC_TIMEOUT_S = 600  # a compile still running then is killed and reported


def find_nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME]
    for home in homes:
        if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    raise KernelError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or in "
        f"{DEFAULT_CUDA_HOME}/bin: the CUDA kernels cannot be built"
    )


def _c_array(v: int) -> str:
    return "{" + ", ".join(f"0x{int(w):08x}u" for w in int_to_limbs(v)) + "}"


def constants_header() -> str:
    """vdf_consts.h: 3b = 15 as an integer, per-field limb tables (modulus,
    2p, Montgomery one, 3b in Montgomery form, R^2 mod p) and inv_alpha
    window digits, in FIELD_INDEX order.  The kernels read them as compile-time constants."""
    names = sorted(FIELD_INDEX, key=FIELD_INDEX.get)
    params = [FIELDS[name] for name in names]
    # csrc/field.cuh's reduction is written for moduli of the shape
    # 1 + c1 2^32 + c2 2^64 + c3 2^96 + 2^254, for which -1/p mod 2^32 = 2^32 - 1.
    for name, P in zip(names, params):
        limbs = [int(w) for w in int_to_limbs(P.modulus)]
        if not (limbs[0] == 1 and limbs[4:7] == [0, 0, 0] and limbs[7] == 1 << 30
                and P.pinv32 == 0xFFFFFFFF):
            raise KernelError(f"field {name}: csrc/field.cuh needs a modulus with limbs "
                              f"[1, c1, c2, c3, 0, 0, 0, 2^30]; got {[hex(w) for w in limbs]}")
    tables = {
        "VDF_P_INIT": [P.modulus for P in params],
        "VDF_TWO_P_INIT": [2 * P.modulus for P in params],
        "VDF_ONE_INIT": [P.mont_one for P in params],
        "VDF_B3_INIT": [P.to_mont(B3) for P in params],
        "VDF_R2_INIT": [P.r * P.r % P.modulus for P in params],
    }
    digits = ["{" + ", ".join(map(str, P.inv_alpha_digits)) + "}" for P in params]
    n_digits = {len(P.inv_alpha_digits) for P in params}
    assert len(n_digits) == 1 and NLIMBS == 8
    return "\n".join([
        "// Generated by vdf_tpu_torch/_build.py from fields/params.py.",
        "#pragma once",
        f"#define VDF_N_DIGITS {n_digits.pop()}",
        f"#define VDF_B3 {B3}u  // 3b, the curves' constant times three",
        *(f"#define {macro} {{" + ", ".join(map(_c_array, vals)) + "}"
          for macro, vals in tables.items()),
        "#define VDF_DIGITS_INIT {" + ", ".join(digits) + "}",
        "",
    ])


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def build_key() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(constants_header().encode())
    h.update(" ".join(NVCC_FLAGS + NVCC_LINK_FLAGS).encode())
    return h.hexdigest()[:16]


_P = ctypes.c_void_p  # a device pointer or a stream
_I = ctypes.c_int
_L = ctypes.c_int64
# Every C launcher: name -> argument types.  Each returns a cudaError_t.
LAUNCHERS = {
    "vdf_minroot_eval": [_I, _P, _P, _P, _P, _P, _P, _L, _L, _P],
    "vdf_minroot_inverse": [_I, _P, _P, _P, _P, _P, _P, _L, _L, _P],
    "vdf_canon_digits": [_I, _P, _P, _L, _L, _L, _I, _I, _P],
    "vdf_canon_mont": [_I, _P, _P, _L, _P],
    "vdf_shift_gens": [_I, _P, _P, _L, _I, _P],
    "vdf_scan": [_I, _P, _P, _P, _P, _P, _P, _L, _L, _L, _L, _I, _I, _P],
    "vdf_colscan": [_I, _P, _P, _P, _P, _P, _P, _L, _L, _I, _P],
    "vdf_bucket": [_I, _P, _P, _P, _P, _P, _L, _L, _I, _I, _P],
    "vdf_horner": [_I, _P, _P, _L, _P],
    # K10: field, op, a, b, c, out, n, broadcast bits; K11: field, x, offsets,
    # out, segments, segment length; K12: field, offsets, cols, vals, z, out, rows
    "vdf_field_ew": [_I, _I, _P, _P, _P, _P, _L, _I, _P],
    "vdf_field_segsum": [_I, _P, _P, _P, _L, _L, _P],
    "vdf_r1cs_matvec": [_I, _P, _P, _P, _P, _P, _L, _P],
}


class Kernels:
    """The loaded library, its launchers' signatures, and how it was made."""

    def __init__(self, lib_path: pathlib.Path, build_seconds: float, log: str):
        self.path = lib_path
        self.build_seconds = build_seconds  # 0.0 when the library was reused
        self.log = log
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in LAUNCHERS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.vdf_error_string.argtypes = [ctypes.c_int]
        lib.vdf_error_string.restype = ctypes.c_char_p
        self.lib = lib

    def error_string(self, err: int) -> str:
        return f"CUDA error {err}: {self.lib.vdf_error_string(err).decode()}"

    def launch(self, name: str, device, *args) -> int:
        """Call launcher ``name`` with ``args`` and the current stream of the
        CUDA ``device``; raise KernelError if CUDA refused the launch.
        Returns the stream's handle."""
        import torch

        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(self.lib, name)(*args, stream)
        if err:
            raise KernelError(f"{name} launch failed: {self.error_string(err)}")
        return stream


def _run_all(cmds: list[list[str]]) -> tuple[str, list[int]]:
    """Run the commands at once; their joined logs and exit codes.  A
    command still running at NVCC_TIMEOUT_S is killed (exit code -1)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    deadline = time.monotonic() + NVCC_TIMEOUT_S
    logs, codes = [], []
    for cmd, proc in zip(cmds, procs):
        try:
            out, _ = proc.communicate(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += f"\n(killed after {NVCC_TIMEOUT_S} s)"
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        codes.append(proc.returncode if proc.returncode is not None else -1)
    return "".join(logs), codes


def build(out_dir: pathlib.Path) -> tuple[pathlib.Path, float, str]:
    """Compile the sources into out_dir (reusing a finished library): one
    nvcc a source, all started together, then one link."""
    lib_path = out_dir / "libvdf_kernels.so"
    log_path = out_dir / "build.log"
    if lib_path.is_file():
        return lib_path, 0.0, log_path.read_text() if log_path.is_file() else ""
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / CONSTS_HEADER).write_text(constants_header())
    tag = f"{os.getpid()}.tmp"
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in _sources()]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-I", str(CSRC_DIR), "-I", str(out_dir),
                 "-o", str(obj), str(src)] for src, obj in zip(_sources(), objs)]
    tmp = out_dir / f"libvdf_kernels.{tag}.so"
    link = [nvcc, *NVCC_LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
    t0 = time.perf_counter()
    log, codes = _run_all(compiles)
    if not any(codes):
        link_log, codes = _run_all([link])
        log += link_log
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if any(codes):
        tmp.unlink(missing_ok=True)
        raise KernelError(f"nvcc failed (exit codes {codes}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    return lib_path, seconds, log


_LOAD_LOCK = threading.Lock()


@functools.cache
def _load() -> Kernels:
    return Kernels(*build(BUILD_DIR / build_key()))


def load_kernels() -> Kernels:
    """Build (first use) and load the kernel library.  The first call builds
    under a lock, so threads that launch at once (nova/pipeline.py) run
    nvcc once between them; ``load_kernels.cache_clear()`` forgets it."""
    with _LOAD_LOCK:
        return _load()


load_kernels.cache_clear = _load.cache_clear
