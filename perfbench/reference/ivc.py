"""The two-curve Nova IVC judged on Python ints.

What the reference works out itself: both augmented R1CS shapes at t
(``frozen/nova/augmented.py``), the parameters' digest over them, the
Pedersen generators of each key (try-and-increment from the key's label),
the Poseidon transcripts (state hash, fold challenge), and z_N (MinRoot's
inverse rounds).  What it reads from the program is the proof, to judge it.

``judge_proof`` holds a final ``IVCProof`` (its instances as host ints, its
five witness vectors as canonical ints) to what the verifier of the Nova
paper checks, and returns the numbers compared, each of which is 0 for a
sound proof:

  * ``claim_wrong``   the proof's step count, z0 or z_N is not the chain's;
  * ``hash_wrong``    the dangling instance's two public inputs are not the
                      state hashes of the running instances;
  * ``rows_wrong``    rows of A z . B z = u C z + E that fail, over the two
                      running relaxed instances and the strict one (E = 0,
                      u = 1), plus any witness of the wrong length;
  * ``commit_wrong``  curves on which the instances' commitments are not the
                      commitments of the witnesses: for each curve, one
                      random linear combination (weights from the seed) of
                      all of its commitments against one MSM of the same
                      combination of the vectors, which a wrong commitment
                      passes with probability 1/q.
"""

from __future__ import annotations

import functools
import hashlib
import random

import numpy as np

from . import cache
from . import curve as C
from . import minroot
from .frozen.curves.point import hash_to_curve_ints
from .frozen.fields.params import P_FP, P_FQ
from .frozen.nova.augmented import CHALLENGE_BITS, HASH_BITS, make_circuits
from .frozen.poseidon.int_poseidon import IntTranscript

KEY_LABEL = b"vdf_tpu/ck"
# side -> (circuit field, its modulus, commitment curve)
SIDES = {"primary": ("Fq", P_FQ, "pallas"), "secondary": ("Fp", P_FP, "vesta")}


@functools.lru_cache(maxsize=2)
def shapes(t: int):
    """(primary shape, secondary shape, digest) at t, synthesized here."""
    primary, secondary = make_circuits(t)
    sp = cache.cached_shape("shape-primary", (t,), primary.shape)
    ss = cache.cached_shape("shape-secondary", (t,), secondary.shape)
    h = hashlib.sha256()
    for shape in (sp, ss):
        for coo in (shape.a_coo, shape.b_coo, shape.c_coo):
            h.update(np.asarray(coo[0]).tobytes())
            h.update(np.asarray(coo[1]).tobytes())
            for c in coo[2]:
                h.update(int(c).to_bytes(32, "little"))
        h.update(b"%d/%d/%d" % (shape.num_cons, shape.num_aux, shape.num_inputs))
    return sp, ss, int.from_bytes(h.digest(), "little") % (1 << HASH_BITS)


def key_length(shape) -> int:
    n = max(shape.num_aux, shape.num_cons)
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=4)
def generators(curve: str, n: int):
    """(n generators, the blinding generator h) of a key, affine ints."""
    pts = cache.cached_points(f"gens-{curve}", (n, KEY_LABEL),
                              lambda: hash_to_curve_ints(curve, n + 1, domain=KEY_LABEL))
    return tuple(pts[:n]), pts[n]


# -- transcripts (the encodings of the port's nova/ivc.py) --------------


def _limbs85(v: int) -> list[int]:
    return [(v >> (85 * k)) & ((1 << 85) - 1) for k in range(3)]


def _point_els(pt) -> list[int]:
    return [0, 0, 1] if pt is None else [int(pt[0]), int(pt[1]), 0]


def relaxed_els(U) -> list[int]:
    return (_point_els(U["comm_w"]) + _point_els(U["comm_e"]) + [U["u"]]
            + _limbs85(U["X"][0]) + _limbs85(U["X"][1]))


def state_hash(field: str, d: int, i: int, z0, zi, U) -> int:
    tr = IntTranscript(field)
    tr.absorb(d, i, *z0, *zi, *relaxed_els(U))
    return tr.squeeze() % (1 << HASH_BITS)


def fold_challenge(field: str, d: int, U, u, comm_t) -> int:
    tr = IntTranscript(field)
    tr.absorb(d, *relaxed_els(U), *_point_els(u["comm_w"]), u["X"][0], u["X"][1],
              *_point_els(comm_t))
    return tr.squeeze() % (1 << CHALLENGE_BITS)


def fold_instance(side: str, U, u, comm_t, r: int):
    """The instance half of a fold: commitments on the side's curve, X mod
    the side's field, u as an integer."""
    _, q, curve = SIDES[side]
    p = C.CURVES[curve][0]

    def scaled_add(base, pt):
        return C.to_affine(C.add(C.from_affine(base), C.mul(C.from_affine(pt), r, p), p), p)

    return {"comm_w": scaled_add(U["comm_w"], u["comm_w"]),
            "comm_e": scaled_add(U["comm_e"], comm_t),
            "X": [(U["X"][k] + r * u["X"][k]) % q for k in range(2)], "u": U["u"] + r}


# -- the relation -------------------------------------------------------


def rows_failing(shape, W, E, X, u, q: int) -> int:
    """Rows of A z . B z = u C z + E that fail, z = (W, u, X); a witness of
    the wrong length fails every row."""
    if len(W) != shape.num_aux or (E is not None and len(E) != shape.num_cons):
        return shape.num_cons
    z = list(W) + [u % q] + [x % q for x in X]
    prods = []
    for rows, cols, vals in (shape.a_coo, shape.b_coo, shape.c_coo):
        acc = [0] * shape.num_cons
        for r_, c_, v in zip(rows.tolist(), cols.tolist(), vals):
            acc[r_] += int(v) * z[c_]
        prods.append(acc)
    e = E if E is not None else [0] * shape.num_cons
    return sum((a * b - u * c - ei) % q != 0 for a, b, c, ei in zip(*prods, e))


def commits_failing(curve: str, pairs, n: int, rng: random.Random) -> int:
    """1 when sum_k rho_k C_k != MSM(gens, sum_k rho_k v_k) for the
    (commitment, vector) pairs of one curve, else 0."""
    p, q = C.CURVES[curve]
    gens, _ = generators(curve, n)
    combo = [0] * n
    lhs = C.INF
    for comm, vec in pairs:
        if len(vec) > n:
            return 1
        rho = rng.randrange(1, q)
        for k, v in enumerate(vec):
            combo[k] += rho * v
        lhs = C.add(lhs, C.mul(C.from_affine(comm), rho, p), p)
    return int(C.to_affine(lhs, p) != C.msm(curve, gens, [c % q for c in combo]))


def z_n(z0, steps: int, t: int):
    return list(minroot.back(tuple(z0), t * steps, P_FQ))


def judge_proof(t: int, z0, steps: int, proof: dict, seed: int) -> dict:
    """The numbers compared for a chain's final proof (see the module's doc).
    ``proof``: i, z0, z_i, r_U_primary, r_W_primary, r_E_primary,
    r_U_secondary, r_W_secondary, r_E_secondary, l_u_secondary,
    l_w_secondary; instances as dicts of comm_w, comm_e, X, u."""
    sp, ss, d = shapes(t)
    zn = z_n(z0, steps, t)
    claim = int(proof["i"] != steps or list(proof["z0"]) != list(z0)
                or [int(v) for v in proof["z_i"]] != zn)

    Up, Us, lu = proof["r_U_primary"], proof["r_U_secondary"], proof["l_u_secondary"]
    hashes = int(lu["X"][0] != state_hash("Fq", d, steps, z0, zn, Us)) \
        + int(lu["X"][1] != state_hash("Fp", d, steps, [0], [0], Up)) \
        + sum(not 0 <= U["u"] < (1 << HASH_BITS) for U in (Up, Us))

    rows = rows_failing(sp, proof["r_W_primary"], proof["r_E_primary"], Up["X"], Up["u"], P_FQ)
    rows += rows_failing(ss, proof["r_W_secondary"], proof["r_E_secondary"], Us["X"], Us["u"],
                         P_FP)
    rows += rows_failing(ss, proof["l_w_secondary"], None, lu["X"], 1, P_FP)

    rng = random.Random(seed)
    commits = commits_failing("pallas", [(Up["comm_w"], proof["r_W_primary"]),
                                         (Up["comm_e"], proof["r_E_primary"])], key_length(sp), rng)
    commits += commits_failing("vesta", [(Us["comm_w"], proof["r_W_secondary"]),
                                         (Us["comm_e"], proof["r_E_secondary"]),
                                         (lu["comm_w"], proof["l_w_secondary"])],
                               key_length(ss), rng)
    return {"claim_wrong": claim, "hash_wrong": hashes, "rows_wrong": rows,
            "commit_wrong": commits}
