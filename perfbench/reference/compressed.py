"""A shipped compressed IVC proof judged on Python ints: its bytes read
here, then the verifier of Nova's CompressedSNARK with Spartan and an
inner-product argument (the port's ``spartan/host.py`` protocol, written
again on the reference's curve code).

``judge_blobs`` takes one blob of each of several chains and returns the
numbers compared, summed over the blobs, 0 for sound proofs:

  * ``bytes_wrong``   blobs that are not well-formed compressed proofs (bad
                      magic, lengths, a non-canonical element, a point off
                      its curve, trailing bytes);
  * ``claim_wrong``   blobs whose step count, z0 or z_N is not the chain's;
  * ``hash_wrong``    dangling instances whose inputs are not the running
                      instances' state hashes, or running u out of range;
  * ``spartan_wrong`` Spartan arguments that fail a sumcheck round or a
                      final claim, plus the curves on which the IPA openings
                      fail: every opening of one curve, over all the blobs,
                      is checked with one MSM (random weights from the
                      seed; a false opening passes with probability 1/q).
"""

from __future__ import annotations

import random
import struct

from . import curve as C
from . import ivc as ref_ivc
from .frozen.fields.params import P_FP, P_FQ
from .frozen.poseidon.int_poseidon import IntTranscript

MAGIC = b"VDFTPU01"
KIND_COMPRESSED = 2
MAX_ROUNDS = 64
MAX_DEGREE = 8
_M128 = (1 << 128) - 1


class Malformed(ValueError):
    pass


class Reader:
    def __init__(self, data: bytes):
        self.data, self.off = data, 0
        if self.take(8) != MAGIC or self.u8() != KIND_COMPRESSED:
            raise Malformed("magic or kind")

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise Malformed("truncated")
        self.off += n
        return self.data[self.off - n: self.off]

    def u8(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def count(self, limit: int) -> int:
        n = self.u64()
        if n > limit:
            raise Malformed("count")
        return n

    def fe(self, q: int) -> int:
        v = int.from_bytes(self.take(32), "little")
        if v >= q:
            raise Malformed("non-canonical element")
        return v

    def fe_vec(self, q: int, want: int) -> list[int]:
        if self.u64() != want:
            raise Malformed("vector length")
        return [self.fe(q) for _ in range(want)]

    def point(self, curve: str):
        tag = self.u8()
        if tag == 0:
            return None
        p = C.CURVES[curve][0]
        if tag != 1:
            raise Malformed("point tag")
        a = (self.fe(p), self.fe(p))
        if not C.on_curve(a, p):
            raise Malformed("point off its curve")
        return a


def _relaxed(r: Reader, q: int, curve: str) -> dict:
    cw, ce = r.point(curve), r.point(curve)
    return {"comm_w": cw, "comm_e": ce, "X": r.fe_vec(q, 2), "u": r.fe(q)}


def _ipa(r: Reader, q: int, curve: str) -> dict:
    n = r.count(MAX_ROUNDS)
    ls = [r.point(curve) for _ in range(n)]
    rs = [r.point(curve) for _ in range(n)]
    return {"ls": ls, "rs": rs, "a": r.fe(q)}


def _spartan(r: Reader, q: int, curve: str) -> dict:
    def msgs():
        return [[r.fe(q) for _ in range(r.count(MAX_DEGREE))] for _ in range(r.count(MAX_ROUNDS))]

    sc1, sc2 = msgs(), msgs()
    vA, vB, vC, vE, vW = (r.fe(q) for _ in range(5))
    return {"sc1": sc1, "sc2": sc2, "vA": vA, "vB": vB, "vC": vC, "vE": vE, "vW": vW,
            "ipa_e": _ipa(r, q, curve), "ipa_w": _ipa(r, q, curve)}


def parse(blob: bytes) -> dict:
    r = Reader(blob)
    out = {"i": r.u64(), "z0": r.fe_vec(P_FQ, 3), "z_i": r.fe_vec(P_FQ, 3),
           "U_p": _relaxed(r, P_FQ, "pallas"), "U_s": _relaxed(r, P_FP, "vesta")}
    out["l_u"] = {"comm_w": r.point("vesta"), "X": r.fe_vec(P_FP, 2)}
    out["comm_t"] = r.point("vesta")
    out["sp_p"] = _spartan(r, P_FQ, "pallas")
    out["sp_s"] = _spartan(r, P_FP, "vesta")
    if r.off != len(blob):
        raise Malformed("trailing bytes")
    return out


# -- Spartan's verifier on ints ------------------------------------------


def num_vars(n: int) -> int:
    return max(1, (n - 1).bit_length())


def absorb_point(tr: IntTranscript, a) -> None:
    if a is None:
        tr.absorb(0, 0, 0, 0, 1)
    else:
        x, y = int(a[0]), int(a[1])
        tr.absorb(x & _M128, x >> 128, y & _M128, y >> 128, 0)


def eval_univariate(q: int, evals, r: int) -> int:
    d = len(evals) - 1
    total = 0
    for k in range(d + 1):
        num = den = 1
        for j in range(d + 1):
            if j != k:
                num = num * (r - j) % q
                den = den * (k - j) % q
        total += evals[k] * num % q * pow(den, -1, q)
    return total % q


def sumcheck(q: int, tr: IntTranscript, messages, claim: int, degree: int):
    if any(len(m) != degree + 1 for m in messages):
        return [0] * len(messages), claim, False
    rs, cur, ok = [], claim % q, True
    for evals in messages:
        ok &= (evals[0] + evals[1]) % q == cur
        tr.absorb(*evals)
        r = tr.squeeze()
        rs.append(r)
        cur = eval_univariate(q, evals, r)
    return rs, cur, ok


def eq_table(q: int, rs) -> list[int]:
    table = [1]
    for r in reversed(rs):
        om = (1 - r) % q
        table = [v * om % q for v in table] + [v * r % q for v in table]
    return table


def eq_point(q: int, a, b) -> int:
    out = 1
    for x, y in zip(a, b):
        out = out * ((x * y + (1 - x) * (1 - y)) % q) % q
    return out


def gamma_eval(q: int, shape, eq_rx, eq_ry, gamma: int) -> int:
    total, g = 0, 1
    for rows, cols, vals in (shape.a_coo, shape.b_coo, shape.c_coo):
        part = 0
        for r_, c_, v in zip(rows.tolist(), cols.tolist(), vals):
            part += int(v) * eq_rx[r_] % q * eq_ry[c_]
        total += part % q * g
        g = g * gamma % q
    return total % q


def ipa_terms(curve: str, q: int, h, comm, b, value: int, proof: dict, tr: IntTranscript):
    """The opening's transcript and its final equation, as (ok, scalars s
    over the generators, coefficient of h, point P'):
    MSM(gens, a s) + a <s, b> h == P' must hold."""
    p = C.CURVES[curve][0]
    n = len(b)
    if n != 1 << len(proof["ls"]) or len(proof["rs"]) != len(proof["ls"]):
        return False, None, 0, C.INF
    xs = []
    for la, ra in zip(proof["ls"], proof["rs"]):
        absorb_point(tr, la)
        absorb_point(tr, ra)
        xs.append(tr.squeeze() & _M128)
    if any(x == 0 for x in xs):
        return False, None, 0, C.INF
    xinvs = [pow(x, -1, q) for x in xs]
    s = [1]
    for x, xi in zip(reversed(xs), reversed(xinvs)):
        s = [v * xi % q for v in s] + [v * x % q for v in s]
    b_final = sum(si * bi for si, bi in zip(s, b)) % q
    acc = C.add(C.from_affine(comm), C.mul(C.from_affine(h), value % q, p), p)
    for x, xi, la, ra in zip(xs, xinvs, proof["ls"], proof["rs"]):
        acc = C.add(acc, C.mul(C.from_affine(la), x * x % q, p), p)
        acc = C.add(acc, C.mul(C.from_affine(ra), xi * xi % q, p), p)
    a = proof["a"] % q
    return True, [a * v % q for v in s], a * b_final % q, acc


def spartan_terms(side: str, shape, digest: int, U: dict, sp: dict, rng: random.Random):
    """One side's Spartan argument up to its openings: None where a sumcheck
    round or a final claim fails, else the openings' equation as (scalars s
    over the generators, coefficient c of h, point P): MSM(gens, s) + c h
    must equal P."""
    field, q, curve = ref_ivc.SIDES[side]
    p = C.CURVES[curve][0]
    tr = IntTranscript(field)
    tr.absorb(digest)
    tr.flush()
    s1, s2 = num_vars(shape.num_cons), num_vars(shape.num_vars)
    absorb_point(tr, U["comm_w"])
    absorb_point(tr, U["comm_e"])
    tr.absorb(*U["X"], U["u"])
    if len(sp["sc1"]) != s1 or len(sp["sc2"]) != s2:
        return None
    tau = [tr.squeeze() for _ in range(s1)]
    rs_x, final1, ok = sumcheck(q, tr, sp["sc1"], 0, 3)
    u = U["u"] % q
    vA, vB, vC, vE = sp["vA"], sp["vB"], sp["vC"], sp["vE"]
    ok &= final1 == eq_point(q, tau, rs_x) * ((vA * vB - (u * vC + vE)) % q) % q
    tr.absorb(vA, vB, vC, vE)
    gamma = tr.squeeze()
    rs_y, final2, ok2 = sumcheck(q, tr, sp["sc2"], (vA + gamma * vB + gamma * gamma % q * vC) % q,
                                 2)
    ok &= ok2
    eq_rx, eq_ry = eq_table(q, rs_x), eq_table(q, rs_y)
    vW = sp["vW"]
    pub = u * eq_ry[shape.num_aux] % q
    for k in range(shape.num_inputs):
        pub = (pub + U["X"][k] % q * eq_ry[shape.num_aux + 1 + k]) % q
    ok &= final2 == gamma_eval(q, shape, eq_rx, eq_ry, gamma) * ((vW + pub) % q) % q
    tr.absorb(vW)
    n = ref_ivc.key_length(shape)
    _, h = ref_ivc.generators(curve, n)
    n_w = 1 << num_vars(shape.num_aux)
    ok_e, s_e, h_e, P_e = ipa_terms(curve, q, h, U["comm_e"], eq_rx, vE, sp["ipa_e"], tr)
    ok_w, s_w, h_w, P_w = ipa_terms(curve, q, h, U["comm_w"], eq_ry[:n_w], vW, sp["ipa_w"], tr)
    if not (ok and ok_e and ok_w):
        return None
    # both openings at once: MSM(gens, s_e + rho s_w) + (h_e + rho h_w) h == P_e + rho P_w
    rho = rng.randrange(1, q)
    scal = list(s_e) + [0] * (n - len(s_e))
    for k, v in enumerate(s_w):
        scal[k] = (scal[k] + rho * v) % q
    return scal, (h_e + rho * h_w) % q, C.add(P_e, C.mul(P_w, rho, p), p)


def openings_ok(side: str, n: int, terms, rng: random.Random) -> bool:
    """Every (s, c, P) of one side at once, with random weights w:
    MSM(gens, sum w s) + (sum w c) h == sum w P."""
    _, q, curve = ref_ivc.SIDES[side]
    p = C.CURVES[curve][0]
    gens, h = ref_ivc.generators(curve, n)
    scal, coef, rhs = [0] * n, 0, C.INF
    for s_k, c_k, P_k in terms:
        w = rng.randrange(1, q)
        for k, v in enumerate(s_k):
            scal[k] = (scal[k] + w * v) % q
        coef = (coef + w * c_k) % q
        rhs = C.add(rhs, C.mul(P_k, w, p), p)
    lhs = C.add(C.from_affine(C.msm(curve, gens, scal)), C.mul(C.from_affine(h), coef, p), p)
    return C.to_affine(lhs, p) == C.to_affine(rhs, p)


def judge_blobs(t: int, chains, seed: int) -> dict:
    """The numbers compared for shipped blobs, given one (z0, steps, blob)
    a chain (see the module's doc)."""
    sp_shape, ss_shape, d = ref_ivc.shapes(t)
    nums = {"bytes_wrong": 0, "claim_wrong": 0, "hash_wrong": 0, "spartan_wrong": 0}
    rng = random.Random(seed)
    terms = {"primary": [], "secondary": []}
    for z0, steps, blob in chains:
        try:
            pr = parse(blob)
        except Malformed:
            nums["bytes_wrong"] += 1
            nums["spartan_wrong"] += 2
            continue
        zn = ref_ivc.z_n(z0, steps, t)
        nums["claim_wrong"] += int(pr["i"] != steps or pr["z0"] != [int(v) for v in z0]
                                   or pr["z_i"] != zn)
        Up, Us, lu = pr["U_p"], pr["U_s"], pr["l_u"]
        nums["hash_wrong"] += \
            int(lu["X"][0] != ref_ivc.state_hash("Fq", d, steps, z0, zn, Us)) \
            + int(lu["X"][1] != ref_ivc.state_hash("Fp", d, steps, [0], [0], Up)) \
            + sum(not 0 <= U["u"] < (1 << ref_ivc.HASH_BITS) for U in (Up, Us))
        r = ref_ivc.fold_challenge("Fq", d, Us, lu, pr["comm_t"])
        Us_folded = ref_ivc.fold_instance("secondary", Us, lu, pr["comm_t"], r)
        for side, shape, U, sp in (("primary", sp_shape, Up, pr["sp_p"]),
                                   ("secondary", ss_shape, Us_folded, pr["sp_s"])):
            got = spartan_terms(side, shape, d, U, sp, rng)
            if got is None:
                nums["spartan_wrong"] += 1
            else:
                terms[side].append(got)
    for side, shape in (("primary", sp_shape), ("secondary", ss_shape)):
        if terms[side]:
            n = ref_ivc.key_length(shape)
            nums["spartan_wrong"] += int(not openings_ok(side, n, terms[side], rng))
    return nums
