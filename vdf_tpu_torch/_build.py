"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

``load_kernels()`` compiles ``csrc/*.cu`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, under
``vdf_tpu_torch/_build/<key>/`` (git-ignored), where ``<key>`` hashes the
sources, the generated constants header and the compiler flags, so an
edit rebuilds and an unchanged tree reuses the library.  The field
constants reach the kernels through ``minroot_consts.h``, generated from
fields/params.py, so Python and CUDA share one source of truth.

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
import time

from .errors import KernelError
from .fields.params import FIELDS, NLIMBS, int_to_limbs

PKG_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
DEFAULT_CUDA_HOME = pathlib.Path("/usr/local/cuda")
FIELD_INDEX = {"Fp": 0, "Fq": 1}  # the kernels' field argument
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in build.log
]


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
    """minroot_consts.h: per-field constants and inv_alpha window digits,
    in FIELD_INDEX order."""
    consts, digits = [], []
    for name in sorted(FIELD_INDEX, key=FIELD_INDEX.get):
        P = FIELDS[name]
        consts.append(
            f"{{{_c_array(P.modulus)}, {_c_array(2 * P.modulus)}, "
            f"{_c_array(P.mont_one)}, 0x{P.pinv32:08x}u}}"
        )
        digits.append("{" + ", ".join(map(str, P.inv_alpha_digits)) + "}")
    n_digits = {len(FIELDS[n].inv_alpha_digits) for n in FIELD_INDEX}
    assert len(n_digits) == 1 and NLIMBS == 8
    return "\n".join([
        "// Generated by vdf_tpu_torch/_build.py from fields/params.py.",
        "#pragma once",
        f"#define VDF_N_DIGITS {n_digits.pop()}",
        "#define VDF_FIELD_CONSTS_INIT {" + ", ".join(consts) + "}",
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
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


class Kernels:
    """The loaded library, its launchers' signatures, and how it was made."""

    def __init__(self, lib_path: pathlib.Path, build_seconds: float, log: str):
        self.path = lib_path
        self.build_seconds = build_seconds  # 0.0 when the library was reused
        self.log = log
        lib = ctypes.CDLL(str(lib_path))
        vp = ctypes.c_void_p
        for fn in (lib.vdf_minroot_eval, lib.vdf_minroot_inverse):
            fn.argtypes = [ctypes.c_int, vp, vp, vp, vp, vp, vp,
                           ctypes.c_int64, ctypes.c_int64, vp]
            fn.restype = ctypes.c_int
        lib.vdf_error_string.argtypes = [ctypes.c_int]
        lib.vdf_error_string.restype = ctypes.c_char_p
        self.lib = lib

    def error_string(self, err: int) -> str:
        return f"CUDA error {err}: {self.lib.vdf_error_string(err).decode()}"


def build(out_dir: pathlib.Path) -> tuple[pathlib.Path, float, str]:
    """Compile the sources into out_dir (reusing a finished library)."""
    lib_path = out_dir / "libvdf_kernels.so"
    log_path = out_dir / "build.log"
    if lib_path.is_file():
        return lib_path, 0.0, log_path.read_text() if log_path.is_file() else ""
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "minroot_consts.h").write_text(constants_header())
    tmp = out_dir / f"libvdf_kernels.{os.getpid()}.tmp.so"
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-I", str(out_dir),
           "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    return lib_path, seconds, log


@functools.cache
def load_kernels() -> Kernels:
    """Build (first use) and load the kernel library."""
    return Kernels(*build(BUILD_DIR / build_key()))
