"""Canonical byte serialization of the two-curve IVC's proofs (port of
``vdf_tpu.serialize``: the same layout, so the same proof gives the same
bytes in either package).

The reference relies on pasta_curves' ``repr-c`` feature (Cargo.toml:17)
for a canonical little-endian element layout and keeps proofs in-process;
this framework ships proofs across processes and hosts:

  * field elements: 32-byte little-endian canonical ints (pasta_curves'
    ``Repr`` layout);
  * points: 1 tag byte (0 = identity, 1 = affine) + x + y;
  * vectors: u64-LE length prefix + elements;
  * every stream starts with an 8-byte magic, a format version and a kind
    byte.

Decoding fails closed with ``SerializationError``: a bad magic or kind, a
short stream, trailing bytes, a field element at or above its modulus, a
point off its curve, a vector of the wrong length.  Witness handles and
Spartan arguments decode to the engine's own form (Montgomery tensors on
the device engine's device, ints on the native engine).
"""

from __future__ import annotations

import struct

from .curves.int_ops import IntCurve
from .errors import SerializationError
from .nova.compressed import CompressedIVCProof
from .nova.ivc import CanonicalWitness, HostInstance, HostRelaxedInstance, IVCParams, IVCProof, Side
from .spartan.host import HostIPAProof, HostSpartanProof, spartan_from_device, spartan_to_device

MAGIC = b"VDFTPU01"
KIND_IVC = 1
KIND_COMPRESSED = 2
NUM_IO = 2  # both augmented circuits expose exactly two public inputs
MAX_ROUNDS = 64  # sumcheck and IPA rounds a stream may claim
MAX_DEGREE = 8  # values a sumcheck message may claim, less one


class _Writer:
    def __init__(self):
        self.parts: list[bytes] = [MAGIC]

    def u8(self, v: int):
        self.parts.append(struct.pack("<B", v))

    def u64(self, v: int):
        self.parts.append(struct.pack("<Q", v))

    def fe(self, v: int):
        if not 0 <= v < (1 << 256):
            raise SerializationError(f"element out of range: {v}")
        self.parts.append(int(v).to_bytes(32, "little"))

    def point(self, aff: tuple | None):
        if aff is None:
            self.u8(0)
        else:
            self.u8(1)
            self.fe(int(aff[0]))
            self.fe(int(aff[1]))

    def fe_vec(self, vs):
        self.u64(len(vs))
        for v in vs:
            self.fe(int(v))

    def bytes(self) -> bytes:
        return b"".join(self.parts)


class _Reader:
    def __init__(self, data: bytes, kind: int):
        self.data = data
        self.off = 0
        if self.take(len(MAGIC)) != MAGIC or self.u8() != kind:
            raise SerializationError("bad magic/kind")

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise SerializationError("truncated stream")
        out = self.data[self.off : self.off + n]
        self.off += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def count(self, limit: int, what: str) -> int:
        n = self.u64()
        if n > limit:
            raise SerializationError(f"{what}: {n} exceeds {limit}")
        return n

    def fe(self, modulus: int) -> int:
        v = int.from_bytes(self.take(32), "little")
        if v >= modulus:
            raise SerializationError("non-canonical field element")
        return v

    def point(self, curve: IntCurve) -> tuple | None:
        tag = self.u8()
        if tag == 0:
            return None
        if tag != 1:
            raise SerializationError(f"bad point tag {tag}")
        aff = (self.fe(curve.p), self.fe(curve.p))
        if not curve.on_curve((*aff, 1)):
            raise SerializationError(f"point off {curve.name}")
        return aff

    def fe_vec(self, modulus: int, want: int, what: str) -> list[int]:
        n = self.u64()
        if n != want:
            raise SerializationError(f"{what}: length {n}, expected {want}")
        return [self.fe(modulus) for _ in range(n)]

    def done(self):
        if self.off != len(self.data):
            raise SerializationError("trailing bytes")


# ---------------------------------------------------------------------
# instances and witness handles
# ---------------------------------------------------------------------


def _w_strict(w: _Writer, u: HostInstance):
    w.point(u.comm_w)
    w.fe_vec(u.X)


def _r_strict(r: _Reader, side: Side) -> HostInstance:
    return HostInstance(r.point(side.int_curve),
                        r.fe_vec(side.field.params.modulus, NUM_IO, "strict instance X"))


def _w_relaxed(w: _Writer, U: HostRelaxedInstance):
    w.point(U.comm_w)
    w.point(U.comm_e)
    w.fe_vec(U.X)
    w.fe(U.u)


def _r_relaxed(r: _Reader, side: Side) -> HostRelaxedInstance:
    q = side.field.params.modulus
    comm_w, comm_e = r.point(side.int_curve), r.point(side.int_curve)
    return HostRelaxedInstance(comm_w, comm_e, r.fe_vec(q, NUM_IO, "relaxed instance X"), r.fe(q))


def _witness_ints(side: Side, handle) -> list[int]:
    """A witness handle (a Montgomery tensor on the device engine, an int
    list on the native one) -> canonical ints."""
    if isinstance(handle, (list, tuple)):
        return [int(v) for v in handle]
    if isinstance(handle, CanonicalWitness):  # proof() lifts every handle it returns
        raise SerializationError("a deferred-commit witness has no proof form yet: call proof()")
    return side.field.decode(handle)


def _witness_handle(side: Side, ints: list[int]):
    """Canonical ints -> the engine's handle; on the device engine K3's
    domain mode lifts them into Montgomery form on the card."""
    if not side.use_device:
        return ints
    return side._lift(side.field.encode_canonical(ints, side.device))


# ---------------------------------------------------------------------
# IVCProof (RecursiveSNARK)
# ---------------------------------------------------------------------


def serialize_ivc_proof(pp: IVCParams, proof: IVCProof) -> bytes:
    w = _Writer()
    w.u8(KIND_IVC)
    w.u64(proof.i)
    w.fe_vec(proof.z0)
    w.fe_vec(proof.z_i)
    _w_relaxed(w, proof.r_U_primary)
    w.fe_vec(_witness_ints(pp.primary, proof.r_W_primary))
    w.fe_vec(_witness_ints(pp.primary, proof.r_E_primary))
    _w_relaxed(w, proof.r_U_secondary)
    w.fe_vec(_witness_ints(pp.secondary, proof.r_W_secondary))
    w.fe_vec(_witness_ints(pp.secondary, proof.r_E_secondary))
    _w_strict(w, proof.l_u_secondary)
    w.fe_vec(_witness_ints(pp.secondary, proof.l_w_secondary))
    return w.bytes()


def deserialize_ivc_proof(pp: IVCParams, data: bytes) -> IVCProof:
    r = _Reader(data, KIND_IVC)
    p_mod = pp.primary.field.params.modulus
    i = r.u64()
    z0 = r.fe_vec(p_mod, pp.primary.circuit.arity, "z0")
    z_i = r.fe_vec(p_mod, pp.primary.circuit.arity, "z_i")

    def wvec(side: Side, n: int, what: str):
        """A wrong-length witness would be gathered out of range downstream:
        it fails here instead."""
        return _witness_handle(side, r.fe_vec(side.field.params.modulus, n, what))

    prim, sec = pp.primary, pp.secondary
    U_p = _r_relaxed(r, prim)
    W_p = wvec(prim, prim.shape.num_aux, "primary W")
    E_p = wvec(prim, prim.shape.num_cons, "primary E")
    U_s = _r_relaxed(r, sec)
    W_s = wvec(sec, sec.shape.num_aux, "secondary W")
    E_s = wvec(sec, sec.shape.num_cons, "secondary E")
    l_u = _r_strict(r, sec)
    l_w = wvec(sec, sec.shape.num_aux, "secondary l_w")
    r.done()
    return IVCProof(i, z0, z_i, U_p, W_p, E_p, U_s, W_s, E_s, l_u, l_w)


# ---------------------------------------------------------------------
# Spartan arguments
# ---------------------------------------------------------------------


def _w_ipa(w: _Writer, ipa: HostIPAProof):
    w.u64(len(ipa.ls))
    for aff in (*ipa.ls, *ipa.rs):
        w.point(aff)
    w.fe(ipa.a_final)


def _r_ipa(r: _Reader, side: Side) -> HostIPAProof:
    n = r.count(MAX_ROUNDS, "IPA rounds")
    ls = tuple(r.point(side.int_curve) for _ in range(n))
    rs = tuple(r.point(side.int_curve) for _ in range(n))
    return HostIPAProof(ls, rs, r.fe(side.field.params.modulus))


def _w_spartan(w: _Writer, side: Side, sp):
    if not isinstance(sp, HostSpartanProof):
        sp = spartan_from_device(side, sp)
    for msgs in (sp.sc1_messages, sp.sc2_messages):
        w.u64(len(msgs))
        for evals in msgs:
            w.u64(len(evals))
            for e in evals:
                w.fe(e)
    for v in (sp.vA, sp.vB, sp.vC, sp.vE, sp.vW):
        w.fe(v)
    _w_ipa(w, sp.ipa_e)
    _w_ipa(w, sp.ipa_w)


def _r_spartan(r: _Reader, side: Side):
    q = side.field.params.modulus

    def msgs():
        rounds = r.count(MAX_ROUNDS, "sumcheck rounds")
        return tuple(tuple(r.fe(q) for _ in range(r.count(MAX_DEGREE, "sumcheck message")))
                     for _ in range(rounds))

    sc1, sc2 = msgs(), msgs()
    vA, vB, vC, vE, vW = (r.fe(q) for _ in range(5))
    hp = HostSpartanProof(sc1, vA, vB, vC, vE, sc2, vW, _r_ipa(r, side), _r_ipa(r, side))
    return spartan_to_device(side, hp) if side.use_device else hp


# ---------------------------------------------------------------------
# CompressedIVCProof
# ---------------------------------------------------------------------


def serialize_compressed(pp: IVCParams, proof: CompressedIVCProof) -> bytes:
    w = _Writer()
    w.u8(KIND_COMPRESSED)
    w.u64(proof.i)
    w.fe_vec(proof.z0)
    w.fe_vec(proof.z_i)
    _w_relaxed(w, proof.r_U_primary)
    _w_relaxed(w, proof.r_U_secondary)
    _w_strict(w, proof.l_u_secondary)
    w.point(proof.comm_t_final)
    _w_spartan(w, pp.primary, proof.spartan_primary)
    _w_spartan(w, pp.secondary, proof.spartan_secondary)
    return w.bytes()


def deserialize_compressed(pp: IVCParams, data: bytes) -> CompressedIVCProof:
    r = _Reader(data, KIND_COMPRESSED)
    p_mod = pp.primary.field.params.modulus
    i = r.u64()
    z0 = r.fe_vec(p_mod, pp.primary.circuit.arity, "z0")
    z_i = r.fe_vec(p_mod, pp.primary.circuit.arity, "z_i")
    U_p = _r_relaxed(r, pp.primary)
    U_s = _r_relaxed(r, pp.secondary)
    l_u = _r_strict(r, pp.secondary)
    comm_t = r.point(pp.secondary.int_curve)
    sp_p = _r_spartan(r, pp.primary)
    sp_s = _r_spartan(r, pp.secondary)
    r.done()
    return CompressedIVCProof(i, z0, z_i, U_p, U_s, l_u, comm_t, sp_p, sp_s)
