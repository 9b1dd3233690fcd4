"""The reference's own derivations (R1CS shapes, Pedersen generators), kept
in ``perfbench/_cache/`` inside the checkout once worked out.

Each file's name carries a hash of the frozen copy's sources and of what
was derived (t, curve, n, label), so a change to either derives anew.  The
program never reads or writes here; the first run of a checkout pays the
derivation (some 25 s for both shapes and both keys), later runs read it.
"""

from __future__ import annotations

import hashlib
import os
import pathlib

import numpy as np

from .frozen.r1cs.cs import R1CSShape

DIR = pathlib.Path(__file__).resolve().parents[1] / "_cache"
FROZEN = pathlib.Path(__file__).resolve().parent / "frozen"


def _key(*parts) -> str:
    h = hashlib.sha256()
    for path in sorted(FROZEN.rglob("*.py")):
        h.update(path.relative_to(FROZEN).as_posix().encode() + b"\0" + path.read_bytes())
    h.update(repr(parts).encode())
    return h.hexdigest()[:16]


def _ints_to_bytes(vals) -> np.ndarray:
    return np.frombuffer(b"".join(int(v).to_bytes(32, "little") for v in vals), dtype=np.uint8)


def _bytes_to_ints(arr: np.ndarray) -> list[int]:
    data = arr.tobytes()
    return [int.from_bytes(data[k: k + 32], "little") for k in range(0, len(data), 32)]


def _store(path: pathlib.Path, arrays: dict) -> None:
    DIR.mkdir(exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)  # a reader sees the whole file or none


def cached_points(name: str, parts: tuple, make) -> list:
    """``make()`` -> a list of affine int pairs, kept under ``name``."""
    path = DIR / f"{name}-{_key(*parts)}.npz"
    if path.is_file():
        flat = _bytes_to_ints(np.load(path)["xy"])
        return [(flat[k], flat[k + 1]) for k in range(0, len(flat), 2)]
    pts = make()
    _store(path, {"xy": _ints_to_bytes(c for pt in pts for c in pt)})
    return pts


def cached_shape(name: str, parts: tuple, make) -> R1CSShape:
    """``make()`` -> an R1CSShape, kept under ``name``."""
    path = DIR / f"{name}-{_key(*parts)}.npz"
    if path.is_file():
        z = np.load(path)
        meta = [int(v) for v in z["meta"]]
        coos = tuple((z[f"{m}_rows"], z[f"{m}_cols"], _bytes_to_ints(z[f"{m}_vals"]))
                     for m in "abc")
        return R1CSShape(*meta[:3], _bytes_to_ints(z["modulus"])[0], *coos)
    shape = make()
    arrays = {"meta": np.array([shape.num_cons, shape.num_aux, shape.num_inputs]),
              "modulus": _ints_to_bytes([shape.modulus])}
    for m, coo in zip("abc", (shape.a_coo, shape.b_coo, shape.c_coo)):
        arrays[f"{m}_rows"] = np.asarray(coo[0])
        arrays[f"{m}_cols"] = np.asarray(coo[1])
        arrays[f"{m}_vals"] = _ints_to_bytes(coo[2])
    _store(path, arrays)
    return shape
