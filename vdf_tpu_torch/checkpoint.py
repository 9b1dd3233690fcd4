"""Proof-carrying checkpoints: persist and resume an IVC chain.

Port of ``vdf_tpu.checkpoint``, with the same magics and the same byte
layout, so each package reads the other's files.  The reference's
``Evaluation::append`` (src/minroot.rs:428-438) is its implicit
checkpointing primitive, and nova-snark's ``RecursiveSNARK`` is resumable
by construction (prove_step takes the previous SNARK, src/nova/proof.rs:
316, 342-349).  This module makes both explicit files:

  * an IVC checkpoint IS a serialized ``IVCProof`` (the prover's whole
    state: running accumulators, dangling instance, step counter, z_i), so
    every checkpoint is verifiable before resuming, and a corrupted or
    tampered file fails closed in the codec or the verifier, never inside
    the prover;
  * a VDF checkpoint is the (state, t) pair behind ``Evaluation.append``.

A killed prover restarts with ``resume_ivc`` and produces proofs
byte-identical to an uninterrupted run.  Every write is atomic: a temp
file, then ``os.replace``.
"""

from __future__ import annotations

import os
import struct

from .device import resolve_device
from .errors import SerializationError
from .fields import get_field
from .minroot.vdf import State
from .nova.ivc import IVCParams, IVCProof, RecursiveIVC, ivc_verify
from .serialize import deserialize_ivc_proof, serialize_ivc_proof

_MAGIC_IVC = b"VDFTPU/CKPT/IVC1"
_MAGIC_VDF = b"VDFTPU/CKPT/VDF1"
_FIELD_IDS = {"Fq": 0, "Fp": 1}


def _write_atomic(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, path)


# ---------------------------------------------------------------------
# IVC prover checkpoints
# ---------------------------------------------------------------------


def save_ivc(path: str, pp: IVCParams, prover_or_proof) -> None:
    """Write a checkpoint of a prover (its ``proof()``) or of a proof."""
    proof = (prover_or_proof.proof() if isinstance(prover_or_proof, RecursiveIVC)
             else prover_or_proof)
    body = serialize_ivc_proof(pp, proof)
    _write_atomic(path, _MAGIC_IVC + struct.pack("<Q", len(body)) + body)


def load_ivc(path: str, pp: IVCParams) -> IVCProof:
    """Read and decode a checkpoint (fail-closed on any malformation).  On a
    device-engine ``pp`` the witness handles are put on ``pp``'s device."""
    with open(path, "rb") as fh:
        blob = fh.read()
    if blob[: len(_MAGIC_IVC)] != _MAGIC_IVC:
        raise SerializationError("not an IVC checkpoint file")
    if len(blob) < len(_MAGIC_IVC) + 8:
        raise SerializationError("truncated IVC checkpoint")
    (n,) = struct.unpack_from("<Q", blob, len(_MAGIC_IVC))
    body = blob[len(_MAGIC_IVC) + 8 :]
    if len(body) != n:
        raise SerializationError("truncated IVC checkpoint")
    return deserialize_ivc_proof(pp, body)


def resume_ivc(path: str, pp: IVCParams, verify: bool = True, debug: bool = False) -> RecursiveIVC:
    """Load a checkpoint and return a live prover continuing from it.

    ``verify=True`` (the default) runs the O(1) verifier on the checkpoint
    first, so a corrupted or forged file is rejected before any proving
    work builds on it."""
    proof = load_ivc(path, pp)
    if verify and not ivc_verify(pp, proof, proof.i, proof.z0, proof.z_i):
        raise SerializationError("checkpoint failed verification")
    return RecursiveIVC.resume(pp, proof, debug=debug)


# ---------------------------------------------------------------------
# plain-VDF (Evaluation.append) checkpoints
# ---------------------------------------------------------------------


def save_vdf(path: str, field_name: str, state: State, t: int) -> None:
    """Persist an Evaluation segment boundary: (state, total t so far).
    Layout: magic, t (u64), field id (u8), lanes (u64), then the lanes'
    x, y and i values, 32 little-endian bytes each."""
    f = get_field(field_name)
    xs, ys, is_ = (f.decode(a) for a in (state.x, state.y, state.i))
    if isinstance(xs, int):
        xs, ys, is_ = [xs], [ys], [is_]
    buf = [_MAGIC_VDF, struct.pack("<Q", t), struct.pack("<B", _FIELD_IDS[field_name]),
           struct.pack("<Q", len(xs))]
    for vs in (xs, ys, is_):
        buf.extend(int(v).to_bytes(32, "little") for v in vs)
    _write_atomic(path, b"".join(buf))


def load_vdf(path: str, device=None) -> tuple[str, State, int]:
    """-> (field_name, State of (lanes, 8) tensors on ``device``, t).
    ``device=None`` is the card (``KernelError`` where there is none)."""
    device = resolve_device(device)
    with open(path, "rb") as fh:
        blob = fh.read()
    if blob[: len(_MAGIC_VDF)] != _MAGIC_VDF:
        raise SerializationError("not a VDF checkpoint file")
    off = len(_MAGIC_VDF)
    if len(blob) < off + 17:
        raise SerializationError("truncated VDF checkpoint")
    (t,) = struct.unpack_from("<Q", blob, off)
    (fid,) = struct.unpack_from("<B", blob, off + 8)
    (lanes,) = struct.unpack_from("<Q", blob, off + 9)
    off += 17
    names = {v: k for k, v in _FIELD_IDS.items()}
    if fid not in names:
        raise SerializationError(f"unknown field id {fid}")
    field_name = names[fid]
    f = get_field(field_name)
    p = f.params.modulus
    if len(blob) != off + 3 * lanes * 32:
        raise SerializationError("truncated VDF checkpoint")

    def vec(k: int):
        base = off + k * lanes * 32
        vals = [int.from_bytes(blob[base + 32 * j : base + 32 * (j + 1)], "little")
                for j in range(lanes)]
        if any(v >= p for v in vals):
            raise SerializationError("non-canonical field element")
        return f.encode(vals, device)

    return field_name, State(vec(0), vec(1), vec(2)), t
