"""The two-curve Nova IVC engine: O(1)-size running proof, O(1) verify.

Port of ``vdf_tpu.nova.ivc`` (reference capability: nova-snark's
PublicParams / RecursiveSNARK, src/nova/proof.rs:232-237, 301-358,
370-391).  The split:

  * **Control plane (host ints)**: instance folding, Fiat–Shamir
    transcripts and augmented-circuit witness synthesis are tiny, branchy
    and strictly sequential.  They run on Python ints
    (fields/int_field.py, curves/int_ops.py, poseidon/int_poseidon.py) and
    the native tier (the witness emitters; the instance fold's commitments,
    ``fold_points_native_or_none``), whose outputs the circuits re-derive
    bit for bit.
  * **Data plane**, one of two engines, named by the caller:
      - ``"device"`` (the default): the witness handles are ``(n, 8)``
        Montgomery tensors on the card; every commit is the fixed-base
        Pedersen commit (kernels K3-K7 against the key's pre-shifted table),
        the matvecs are K12 and the cross term and the folds a + r b are K10
        (fields/kernels.py).  A fold of a fresh
        strict instance is one fused pass (``Side._fold_strict``): K3's
        domain mode lifts the canonical witness, three matvecs, the cross
        term, one K = 2 commit of [w, T], one read of both points.
      - ``"native"``: the host plane, C++ Pippenger (native/pasta.cpp)
        plus exact int matvecs; witness handles are int lists.
    There is no automatic choice: with no card the device engine raises
    ``KernelError``, and only ``engine="native"`` or ``device="cpu"`` (the
    kernels' plain versions) runs without one.
  * **Tensor parallelism** (the JAX package's ``mesh=``): a device engine
    given a ``parallel.Mesh`` of more than one rank runs its matvecs as
    ``sharded_matvec`` and its commits as ``sharded_msm`` over the rank's
    block of the key's generators (the variable-base ``msm``, not the
    fixed-base table), every rank proving the same chain.  At one rank, or
    with no mesh, nothing changes.

Chain invariant (established by nova/augmented.py, checked here):

    l_u_secondary.X[0] == H_Fq(d, n, z0, zn, r_U_secondary)
    l_u_secondary.X[1] == H_Fp(d, n, [0], [0], r_U_primary)

so the verifier touches exactly three instances however long the chain:
the two running relaxed instances (one per curve) and the single dangling
strict secondary instance.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import threading

import numpy as np
import torch

from ..curves.int_ops import IntCurve, get_int_curve
from ..curves.kernels import canon_mont
from ..device import resolve_device
from ..errors import NovaError, SynthesisError
from ..fields import NLIMBS, Field, get_field
from ..fields.int_field import get_int_field
from ..native import (
    fold_points_native_or_none,
    msm_native_packed,
    pack_points_u64,
    pack_scalars_u64,
)
from ..poseidon.int_poseidon import IntTranscript, MemoTranscript
from ..r1cs.cs import R1CSShape
from ..utils.profiling import PhaseTimer
from .augmented import (
    AugmentedCircuit,
    AugmentedInputs,
    CHALLENGE_BITS,
    HASH_BITS,
    make_circuits,
)
from .pedersen import CommitmentKey, commitment_key, derive_generators
from .r1cs_device import DeviceShape

ENGINES = ("device", "native")

# How each commitment pair of every instance fold of the process was folded:
# in the batched native call or on IntCurve (an identity operand).  Never
# reset; folds on several threads (prove_interleaved) count under the lock.
INSTANCE_FOLDS = {"native": 0, "int": 0}
_FOLDS_LOCK = threading.Lock()

# ---------------------------------------------------------------------
# host-side instance types
# ---------------------------------------------------------------------


@dataclasses.dataclass
class HostInstance:
    """Strict (u=1, E=0) R1CS instance; X values are 250-bit hashes."""

    comm_w: tuple | None
    X: list[int]


@dataclasses.dataclass
class HostRelaxedInstance:
    comm_w: tuple | None
    comm_e: tuple | None
    X: list[int]  # full field range
    u: int  # integer < 2^250 (grows by one 128-bit challenge per fold)

    @classmethod
    def default(cls) -> "HostRelaxedInstance":
        return cls(None, None, [0, 0], 0)

    @classmethod
    def from_strict(cls, u: HostInstance) -> "HostRelaxedInstance":
        return cls(u.comm_w, None, list(u.X), 1)


@dataclasses.dataclass
class CanonicalWitness:
    """A fresh strict witness on the device whose commitment is deferred:
    ``(n, 8)`` CANONICAL integer limbs, not yet in Montgomery form.  Only an
    instance with ``comm_w=None`` carries one; the fused fold
    (``Side.fold_cached``) lifts and commits it, and ``RecursiveIVC.proof``
    does the same for the dangling secondary instance.  Every other device
    witness handle is a Montgomery tensor."""

    limbs: torch.Tensor


# -- canonical transcript encodings (circuit twins: gadgets/instance.py)


def _limbs85(v: int) -> list[int]:
    return [(v >> (85 * k)) & ((1 << 85) - 1) for k in range(3)]


def _point_els(pt: tuple | None) -> list[int]:
    return [0, 0, 1] if pt is None else [int(pt[0]), int(pt[1]), 0]


def _relaxed_els(U: HostRelaxedInstance) -> list[int]:
    return (
        _point_els(U.comm_w)
        + _point_els(U.comm_e)
        + [U.u]
        + _limbs85(U.X[0])
        + _limbs85(U.X[1])
    )


def _strict_els(u: HostInstance) -> list[int]:
    return _point_els(u.comm_w) + [u.X[0], u.X[1]]


def state_hash(
    field_name: str, d: int, i: int, z0: list[int], z_i: list[int], U: HostRelaxedInstance
) -> int:
    tr = IntTranscript(field_name)
    tr.absorb(d, i, *z0, *z_i, *_relaxed_els(U))
    return tr.squeeze() % (1 << HASH_BITS)


def fold_challenge(
    field_name: str,
    d: int,
    U: HostRelaxedInstance,
    u: HostInstance,
    comm_t: tuple | None,
) -> int:
    """The fold's challenge r.  Its transcript permutes through the memo
    (``MemoTranscript``): the augmented circuit that verifies this fold
    re-derives r from the same permutations and reads them from there."""
    tr = MemoTranscript(field_name)
    tr.absorb(d, *_relaxed_els(U), *_strict_els(u), *_point_els(comm_t))
    return tr.squeeze() % (1 << CHALLENGE_BITS)


def _canon_affine(pt: tuple[int, int], p: int) -> tuple[int, int]:
    """An affine pair reduced mod p, as ``IntCurve.from_affine`` takes it."""
    return (pt[0] % p, pt[1] % p)


def _commit_len(shape: R1CSShape) -> int:
    """The key length of a side: the power of two >= every vector it
    commits (W of num_aux, T and E of num_cons)."""
    n = max(shape.num_aux, shape.num_cons)
    return 1 << (n - 1).bit_length()


# ---------------------------------------------------------------------
# the "native" engine: native C++ MSM + exact int matvec
# ---------------------------------------------------------------------


class HostPlane:
    """Exact host-int data plane: Pippenger MSM in C++ (native/pasta.cpp)
    plus Python-int sparse matvecs.  Its generators are the device key's
    (``pedersen.derive_generators``, derived once a process for both).
    Witness handles are plain int lists."""

    def __init__(self, field_name: str, curve_name: str, shape: R1CSShape):
        self.f = get_int_field(field_name)
        self.curve_name = curve_name
        self.shape = shape
        self.coo = [
            (list(map(int, r)), list(map(int, c)), [int(v) for v in vals])
            for (r, c, vals) in (shape.a_coo, shape.b_coo, shape.c_coo)
        ]
        n = _commit_len(shape)
        self.gens = derive_generators(curve_name, n)[:n]
        self._gens_packed = None  # packed u64 buffer, built at first commit

    def _msm(self, sc_u64: np.ndarray) -> tuple | None:
        if self._gens_packed is None:
            self._gens_packed = pack_points_u64(self.gens)
        out = msm_native_packed(self.curve_name, self._gens_packed, sc_u64)
        if out is None:
            return None
        x, y, z = out  # Jacobian
        mod = get_int_curve(self.curve_name).p
        zi = pow(z, -1, mod)
        return (x * zi * zi % mod, y * zi * zi % mod * zi % mod)

    def commit(self, w: list[int]) -> tuple | None:
        return self._msm(pack_scalars_u64(w))

    def commit_words(self, words: np.ndarray) -> tuple | None:
        """``commit`` of a witness given as ``(n, 4)`` canonical uint64 words."""
        return self._msm(np.ascontiguousarray(words, dtype=np.uint64).reshape(-1))

    def _matvecs(self, z: list[int]) -> list[list[int]]:
        p = self.f.p
        outs = []
        for rows, cols, vals in self.coo:
            acc = [0] * self.shape.num_cons
            for r, c, v in zip(rows, cols, vals):
                acc[r] += v * z[c]
            outs.append([a % p for a in acc])
        return outs

    def z_vec(self, w: list[int], x: list[int], u: int) -> list[int]:
        return list(w) + [u] + list(x)

    def cross(self, w1, x1, u1, w2, x2):
        """T = Az1∘Bz2 + Az2∘Bz1 − u1·Cz2 − u2·Cz1, comm_T."""
        p = self.f.p
        az1, bz1, cz1 = self._matvecs(self.z_vec(w1, x1, u1))
        az2, bz2, cz2 = self._matvecs(self.z_vec(w2, x2, 1))
        t = [
            (a1 * b2 + a2 * b1 - u1 * c2 - c1) % p
            for a1, b1, c1, a2, b2, c2 in zip(az1, bz1, cz1, az2, bz2, cz2)
        ]
        return t, self.commit(t)

    def fold_w(self, W, E, w2, t, r: int):
        p = self.f.p
        W2 = [(a + r * b) % p for a, b in zip(W, w2)]
        E2 = [(a + r * b) % p for a, b in zip(E, t)]
        return W2, E2

    def default_w(self, n: int) -> list[int]:
        return [0] * n

    def sat(self, W, E, x, u, comm_w, comm_e) -> bool:
        if len(W) != self.shape.num_aux or len(E) != self.shape.num_cons:
            return False
        p = self.f.p
        az, bz, cz = self._matvecs(self.z_vec(W, x, u))
        for a, b, c, e in zip(az, bz, cz, E):
            if (a * b) % p != (u * c + e) % p:
                return False
        return self.commit(W) == comm_w and self.commit(E) == comm_e


# ---------------------------------------------------------------------
# one curve side: shapes + the device engine's fold
# ---------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class Side:
    """Everything attached to one circuit of the cycle."""

    circuit: AugmentedCircuit
    shape: R1CSShape
    field: Field  # field of the circuit (the commitment curve's scalar field)
    curve_name: str  # commitment curve (points live on the *other* base)
    tr_field: str  # transcript field for folding THIS side's instances
    # (= the other circuit's field, which re-derives the challenge)
    engine: str = "device"  # "device" | "native"
    device: torch.device | None = None  # the device engine's; None on "native"
    mesh: object = None  # parallel.Mesh over the "shard" axis: TP for MSM/matvec

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {self.engine!r}")

    @property
    def use_device(self) -> bool:
        return self.engine == "device"

    @property
    def _use_tp(self) -> bool:
        return self.use_device and self.mesh is not None and self.mesh.size > 1

    @functools.cached_property
    def host_plane(self) -> HostPlane:
        return HostPlane(self.field.params.name, self.curve_name, self.shape)

    @functools.cached_property
    def dev_shape(self) -> DeviceShape:
        return DeviceShape.build(self.field, self.shape, self.device)

    @functools.cached_property
    def int_curve(self) -> IntCurve:
        return get_int_curve(self.curve_name)

    @property
    def _commit_pad(self) -> int:
        """Common padded length of every commit on this side (witness,
        cross term, error): the key's length, so one pre-shifted table
        (K7) serves them all."""
        return _commit_len(self.shape)

    @functools.cached_property
    def ck(self) -> CommitmentKey:
        return commitment_key(self.curve_name, self._commit_pad, device=self.device)

    # -- host <-> device conversions -----------------------------------

    def _lift(self, canon: torch.Tensor) -> torch.Tensor:
        """Canonical integer limbs -> Montgomery form (K3's domain mode)."""
        return canon_mont(self.field.params.name, canon)

    def _padded(self, v: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(v, (0, 0, 0, self._commit_pad - v.shape[0]))

    def _x_u_enc(self, U) -> tuple[torch.Tensor, torch.Tensor]:
        """X (2, 8) and u (8,) of an instance, encoded in one transfer."""
        u = U.u if isinstance(U, HostRelaxedInstance) else 1
        v = self.field.encode([*U.X, u], self.device)
        return v[:-1], v[-1]

    def commit_witness(self, cs):
        """The witness of a synthesis (its WitnessCS) -> (witness handle,
        affine commitment).  The handle is a Montgomery tensor on the device
        engine, an int list on the native, whose Pippenger takes the
        canonical words as they are."""
        words = cs.aux_u64()
        if not self.use_device:
            return cs.aux, self.host_plane.commit_words(words)
        w = self._lift(self.field.encode_canonical_u64(words, self.device))
        return w, self.commit_w(w)

    def commit_w(self, w: torch.Tensor) -> tuple | None:
        """Pedersen commit of a Montgomery device handle -> affine ints."""
        return self.ck.curve.to_affine_ints(self._commit_one(w))[0]

    def _commit_one(self, w: torch.Tensor):
        """One commit -> a Point of (1, 8), not read."""
        pt = self._tp_commit(w) if self._use_tp else self.ck.commit(w)
        return type(pt)(*(v[None] for v in pt))

    def _tp_commit(self, w: torch.Tensor):
        """The commit under tensor parallelism: ``sharded_msm`` over the key's
        generators, a block a rank."""
        from ..parallel.mesh import sharded_msm

        return sharded_msm(self.ck.curve, self.ck.gens, self._padded(w), self.mesh)

    def _commit_pair(self, a: torch.Tensor, b: torch.Tensor):
        """Two commits -> a Point of (2, 8): one K = 2 fixed-base pass, or
        two sharded MSMs under tensor parallelism."""
        if not self._use_tp:
            return self.ck.commit_batch(torch.stack([self._padded(a), self._padded(b)]))
        pts = [self._tp_commit(v) for v in (a, b)]
        return type(pts[0])(*(torch.stack(c) for c in zip(*pts)))

    def _matvecs(self, z: torch.Tensor) -> tuple:
        """(Az, Bz, Cz), entry-sharded over the mesh under tensor parallelism."""
        mats = (self.dev_shape.a, self.dev_shape.b, self.dev_shape.c)
        if not self._use_tp:
            return tuple(m.matvec(self.field, z) for m in mats)
        from ..parallel.mesh import sharded_matvec

        return tuple(sharded_matvec(self.field, m, z, self.mesh) for m in mats)

    def zero_w(self):
        if not self.use_device:
            return self.host_plane.default_w(self.shape.num_aux)
        return torch.zeros((self.shape.num_aux, NLIMBS), dtype=torch.int32, device=self.device)

    def zero_e(self):
        if not self.use_device:
            return self.host_plane.default_w(self.shape.num_cons)
        return torch.zeros((self.shape.num_cons, NLIMBS), dtype=torch.int32, device=self.device)

    # -- the device engine's fold pieces ---------------------------------
    #
    # The prover caches (Az, Bz, Cz) of the running accumulator's z: they
    # are linear in the fold (A(z1 + r z2) = Az1 + r Az2), so they fold
    # alongside W and E and only the strict operand's three matvecs run a
    # fold (nova-snark recomputes all six, proof.rs:342-349).  No transcript
    # or proof value changes: T, comm_T and every folded value equal the
    # native engine's (tests/test_torch_ivc.py).

    def _products(self, w, x, u) -> tuple:
        """(Az, Bz, Cz) of z = (w, u, x): seeds the cache for a nontrivial
        accumulator (the base step's lifted primary instance, a resume)."""
        return self._matvecs(self.dev_shape.z_vector(self.field, w, x, u))

    def _zero_products(self) -> tuple:
        z = self.zero_e()
        return (z, z, z)

    def _cross(self, zp1, u1, w2, x2):
        """T = Az1∘Bz2 + Az2∘Bz1 − u1·Cz2 − Cz1 (u2 = 1: a strict operand)
        from the cached products of the running side; -> (T, zp2)."""
        f = self.field
        az1, bz1, cz1 = zp1
        zp2 = self._products(w2, x2, f.const_like(u1, 1))
        az2, bz2, cz2 = zp2
        m = f.mul(torch.stack([az1, az2, u1.expand_as(cz2)]), torch.stack([bz2, bz1, cz2]))
        t = f.sub(f.sub(f.add(m[0], m[1]), m[2]), cz1)
        return t, zp2

    def _span(self, timer, part: str):
        """The span of one part of a fold on this side, on ``timer``."""
        return timer.phase(f"fold.{part}/{self.curve_name}")

    def _fold_strict(self, zp1, u1, w2c: CanonicalWitness, x2):
        """The whole strict-side fold data plane: K3's domain mode lifts the
        fresh witness, its three matvecs, the cross term, ONE K = 2 commit
        of [w2, T] against the shared table, not yet read (the caller reads
        both points at once).  -> (w2 Montgomery, T, zp2, Point of (2, 8))."""
        w2 = self._lift(w2c.limbs)
        t, zp2 = self._cross(zp1, u1, w2, x2)
        return w2, t, zp2, self._commit_pair(w2, t)

    def _wfoldp(self, W1, E1, zp1, w2, t, zp2, r):
        """The six linear folds a + r b: W, E and the cached products, two
        fused folds (K10 on the card: one for W, one for the stacked rest)."""
        f = self.field
        W = f.fold(W1, r, w2)
        rest = f.fold(torch.stack([E1, *zp1]), r, torch.stack([t, *zp2]))
        return W, rest[0], tuple(rest[1:])

    def _sat(self, W, E, x, u, comm_w, comm_e) -> bool:
        """Relaxed satisfaction (one read) and both openings, W and E in one
        K = 2 commit (one read)."""
        if W.shape != (self.shape.num_aux, NLIMBS) or E.shape != (self.shape.num_cons, NLIMBS):
            return False
        if not self.dev_shape.check_relaxed(self.field, W, E, x, u, self._matvecs):
            return False
        return self.ck.curve.to_affine_ints(self._commit_pair(W, E)) == [comm_w, comm_e]

    def check_sat(self, U, W, E) -> bool:
        comm_e = U.comm_e if isinstance(U, HostRelaxedInstance) else None
        u_int = U.u if isinstance(U, HostRelaxedInstance) else 1
        if not self.use_device:
            if E is None:
                E = self.host_plane.default_w(self.shape.num_cons)
            return self.host_plane.sat(W, E, list(U.X), u_int, U.comm_w, comm_e)
        if not isinstance(W, torch.Tensor):
            raise NovaError(f"check_sat takes a Montgomery tensor witness, got {type(W).__name__}")
        x, u = self._x_u_enc(U)
        if E is None:
            E = self.zero_e()
        return self._sat(W, E, x, u, U.comm_w, comm_e)

    # -- the NIFS prover fold (host instances + device witnesses) -------

    def fold(self, d: int, U: HostRelaxedInstance, W, E, u: HostInstance, w2):
        """The native engine's fold, the reference-shaped one with six
        matvecs: returns (U', W', E', comm_T affine, r).  The device engine
        folds through ``fold_cached``."""
        if self.use_device:
            raise NovaError("Side.fold is the native engine's; the device engine folds "
                            "through fold_cached")
        t, comm_t = self.host_plane.cross(W, list(U.X), U.u, w2, list(u.X))
        r = fold_challenge(self.tr_field, d, U, u, comm_t)
        U_new = self.fold_instance(U, u, comm_t, r)
        W_new, E_new = self.host_plane.fold_w(W, E, w2, t, r)
        return U_new, W_new, E_new, comm_t, r

    def fold_cached(
        self,
        d: int,
        U: HostRelaxedInstance,
        W,
        E,
        u: HostInstance,
        w2,
        zprod,
        check_cache: bool = False,
        timer=None,
    ):
        """``fold`` with the running z-products cached across steps.
        ``zprod`` is the (Az, Bz, Cz) tuple of the running accumulator, or
        None to (re)seed it: zeros for the default accumulator, three
        matvecs otherwise.

        INVARIANT: a non-None ``zprod`` MUST be the products of exactly the
        (U, W) passed, the ``zprod'`` this method returned with that
        accumulator.  A stale cache yields a wrong T and an unverifiable
        proof; ``check_cache=True`` (the prover's debug mode) recomputes the
        products and raises NovaError instead.

        The strict witness's domain is its type: with ``u.comm_w is None``
        (deferred commit) ``w2`` must be a CanonicalWitness, which the fused
        pass lifts and commits, writing the commitment back to ``u``; a
        committed instance's ``w2`` must be a Montgomery tensor.  Anything
        else raises NovaError.

        On the device engine ``timer`` (None: no spans) gets a span
        ``fold.<part>/<curve>`` for each part of the fold: "commit" (the
        instances' X and u encoded, the lift, the matvecs, the cross term and
        the commit), "read" (the
        commitments read back as affine ints), "challenge", "instance" (the
        instance fold, ``fold_instance``) and "witness" (the linear folds).

        Returns (U', W', E', comm_T, r, zprod'); zprod' is None on the
        native engine, whose fold is the six-matvec one."""
        if not self.use_device:
            return (*self.fold(d, U, W, E, u, w2), None)
        deferred = u.comm_w is None
        if deferred != isinstance(w2, CanonicalWitness):
            raise NovaError(
                "fold_cached: an instance with comm_w=None takes a CanonicalWitness (its "
                f"commit is deferred), a committed one a Montgomery tensor; got comm_w="
                f"{'None' if deferred else 'set'} with a {type(w2).__name__}"
            )
        timer = timer or PhaseTimer(enabled=False)
        with self._span(timer, "commit"):
            x1, u1 = self._x_u_enc(U)
            x2, _ = self._x_u_enc(u)
            if zprod is None:
                if U.comm_w is None and U.u == 0 and not any(U.X):
                    zprod = self._zero_products()
                else:
                    zprod = self._products(W, x1, u1)
            elif check_cache:
                ref = self._products(W, x1, u1)
                if not all(torch.equal(a, b) for a, b in zip(zprod, ref)):
                    raise NovaError("fold_cached: stale z-product cache for (U, W)")
            if deferred:
                w2, t, zprod2, pts = self._fold_strict(zprod, u1, w2, x2)
            else:
                t, zprod2 = self._cross(zprod, u1, w2, x2)
                pts = self._commit_one(t)
        with self._span(timer, "read"):
            comms = self.ck.curve.to_affine_ints(pts)
        if deferred:
            u.comm_w, comm_t = comms
        else:
            comm_t = comms[0]
        with self._span(timer, "challenge"):
            r = fold_challenge(self.tr_field, d, U, u, comm_t)
        with self._span(timer, "instance"):
            U_new = self.fold_instance(U, u, comm_t, r)
        with self._span(timer, "witness"):
            W_new, E_new, zprod_new = self._wfoldp(
                W, E, zprod, w2, t, zprod2, self.field.encode(r, self.device)
            )
        return U_new, W_new, E_new, comm_t, r, zprod_new

    def fold_instance(
        self, U: HostRelaxedInstance, u: HostInstance, comm_t: tuple | None, r: int
    ) -> HostRelaxedInstance:
        """Instance-side fold (the part the augmented circuit re-derives).
        The commitments base + r pt: the pairs whose operands are both points
        in one batched native call (one inversion; a result at the identity
        comes back None), a pair with the identity (None) as an operand, as
        on the first folds of a default accumulator, on ``IntCurve``."""
        c = self.int_curve
        p = self.field.params.modulus
        pairs = ((U.comm_w, u.comm_w), (U.comm_e, comm_t))
        native = [k for k, pair in enumerate(pairs) if None not in pair]
        comms = [None, None]
        if native:
            folded = fold_points_native_or_none(
                self.curve_name, [_canon_affine(pairs[k][0], c.p) for k in native],
                [_canon_affine(pairs[k][1], c.p) for k in native], 1, r)
            for k, v in zip(native, folded):
                comms[k] = v
        for k, (base, pt) in enumerate(pairs):
            if k not in native:
                comms[k] = c.to_affine(c.add(c.from_affine(base), c.scalar_mul(c.from_affine(pt), r)))
        with _FOLDS_LOCK:
            INSTANCE_FOLDS["native"] += len(native)
            INSTANCE_FOLDS["int"] += len(pairs) - len(native)
        return HostRelaxedInstance(
            comms[0],
            comms[1],
            [(U.X[k] + r * u.X[k]) % p for k in range(2)],
            U.u + r,
        )


# ---------------------------------------------------------------------
# public params
# ---------------------------------------------------------------------


@dataclasses.dataclass
class IVCParams:
    """Both augmented shapes + commitment keys (reference public_params,
    proof.rs:232-237, which likewise synthesizes the two augmented circuits
    and their generators)."""

    t: int
    primary: Side
    secondary: Side
    digest: int


def _shapes_digest(*shapes: R1CSShape) -> int:
    h = hashlib.sha256()
    for shape in shapes:
        for coo in (shape.a_coo, shape.b_coo, shape.c_coo):
            h.update(np.asarray(coo[0]).tobytes())
            h.update(np.asarray(coo[1]).tobytes())
            for c in coo[2]:
                h.update(int(c).to_bytes(32, "little"))
        h.update(b"%d/%d/%d" % (shape.num_cons, shape.num_aux, shape.num_inputs))
    return int.from_bytes(h.digest(), "little") % (1 << HASH_BITS)


@functools.lru_cache(maxsize=4)
def _shapes(t: int):
    """Both augmented circuits, their shapes and the params digest (shared
    by every engine and device at this t)."""
    primary_c, secondary_c = make_circuits(t)
    shape_p = primary_c.shape()
    shape_s = secondary_c.shape()
    return primary_c, secondary_c, shape_p, shape_s, _shapes_digest(shape_p, shape_s)


@functools.lru_cache(maxsize=8)
def _public_params(t: int, engine: str, device: str | None, mesh) -> IVCParams:
    primary_c, secondary_c, shape_p, shape_s, digest = _shapes(t)
    dev = None if device is None else torch.device(device)
    primary = Side(primary_c, shape_p, get_field("Fq"), "pallas", "Fp", engine, dev, mesh)
    secondary = Side(secondary_c, shape_s, get_field("Fp"), "vesta", "Fq", engine, dev, mesh)
    return IVCParams(t, primary, secondary, digest)


def ivc_public_params(t: int, engine: str = "device", device=None, mesh=None) -> IVCParams:
    """Synthesize both augmented shapes once; derive the params digest.

    ``engine``: "device" (the default) runs the data plane on ``device``
    (None: the card, or ``KernelError`` where there is none; with a mesh,
    the mesh's device); "native" runs the host plane and ignores ``device``
    and ``mesh``.  ``mesh``: an optional ``parallel.Mesh`` over the "shard"
    axis; the device engine's MSMs and matvecs then run tensor-parallel
    across it when it has more than one rank.  Cached per (t, engine,
    device, mesh); a device engine's keys are ``commitment_key``'s, cached
    per device."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if engine != "device":
        return _public_params(t, engine, None, None)
    if mesh is not None:
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
        device = mesh.device
    return _public_params(t, engine, str(resolve_device(device)), mesh)


# ---------------------------------------------------------------------
# RecursiveSNARK
# ---------------------------------------------------------------------


@dataclasses.dataclass
class IVCProof:
    """The O(1)-size running proof: two relaxed accumulators + the one
    dangling strict secondary instance (matches nova-snark's RecursiveSNARK
    verifier inputs, proof.rs:370-387)."""

    i: int
    z0: list[int]
    z_i: list[int]
    r_U_primary: HostRelaxedInstance
    r_W_primary: object  # witness handle: Montgomery tensor (device) | int list (native)
    r_E_primary: object
    r_U_secondary: HostRelaxedInstance
    r_W_secondary: object
    r_E_secondary: object
    l_u_secondary: HostInstance
    l_w_secondary: object


def _timer(pp: IVCParams) -> PhaseTimer:
    """The prover's default timer: disabled, with the ``sync`` a recording
    timer built from it (``type(t)(t.sync)``) should use."""
    dev = pp.primary.device
    if pp.primary.use_device and dev.type == "cuda":
        return PhaseTimer(sync=lambda: torch.cuda.synchronize(dev), enabled=False)
    return PhaseTimer(enabled=False)


class RecursiveIVC:
    """Prover state machine: the constructor runs the base step,
    prove_step extends."""

    def __init__(self, pp: IVCParams, z0: list[int], debug: bool = False):
        self.pp = pp
        self.debug = debug
        self.timer = _timer(pp)  # the phases' spans: off until a caller swaps one in
        p = pp.primary.field.params.modulus
        self.z0 = [int(z) % p for z in z0]

        # base step: primary folds nothing; secondary lifts the first
        # primary instance into the running accumulator.
        d = pp.digest
        inp = AugmentedInputs(d, 0, self.z0, self.z0, HostRelaxedInstance.default(), None, None)
        # The base primary instance becomes the running accumulator and is
        # hashed into the secondary circuit's input, so its commit cannot
        # be deferred to a later fold.
        l_u_p, l_w_p, z1 = self._synth(pp.primary, inp, defer_commit=False)
        self.r_U_primary = HostRelaxedInstance.from_strict(l_u_p)
        self.r_W_primary = l_w_p
        self.r_E_primary = pp.primary.zero_e()

        inp_s = AugmentedInputs(d, 0, [0], [0], HostRelaxedInstance.default(), l_u_p, None)
        l_u_s, l_w_s, _ = self._synth(pp.secondary, inp_s)
        self.r_U_secondary = HostRelaxedInstance.default()
        self.r_W_secondary = pp.secondary.zero_w()
        self.r_E_secondary = pp.secondary.zero_e()
        self.l_u_secondary = l_u_s
        self.l_w_secondary = l_w_s
        self.i = 1
        self.z_i = z1
        # cached (Az, Bz, Cz) of each running accumulator (fold_cached);
        # None = seed on the first fold.
        self._zp_primary = None
        self._zp_secondary = None

    @classmethod
    def resume(cls, pp: IVCParams, proof: IVCProof, debug: bool = False) -> "RecursiveIVC":
        """Rehydrate a live prover from a proof: the IVCProof carries the
        prover's complete state (nova-snark's prove_step likewise resumes
        from Option<RecursiveSNARK>, proof.rs:316,342-349)."""
        self = cls.__new__(cls)
        self.pp = pp
        self.debug = debug
        self.timer = _timer(pp)
        self.z0 = list(proof.z0)
        self.i = proof.i
        self.z_i = list(proof.z_i)
        self.r_U_primary = proof.r_U_primary
        self.r_W_primary = proof.r_W_primary
        self.r_E_primary = proof.r_E_primary
        self.r_U_secondary = proof.r_U_secondary
        self.r_W_secondary = proof.r_W_secondary
        self.r_E_secondary = proof.r_E_secondary
        self.l_u_secondary = proof.l_u_secondary
        self.l_w_secondary = proof.l_w_secondary
        self._zp_primary = None  # reseeded by the next fold_cached
        self._zp_secondary = None
        return self

    def _synth(self, side: Side, inp: AugmentedInputs, defer_commit: bool = True):
        """Synthesize one augmented-circuit witness.  On the device engine
        the Pedersen commit is DEFERRED (comm_w=None, a CanonicalWitness
        handle): the next fold_cached lifts and commits it fused with the
        cross term, and proof() finalizes a still-dangling instance.  The
        native engine, and ``defer_commit=False`` callers that need the
        commitment at once (the base step's primary instance), commit here."""
        name = side.field.params.name
        with self.timer.phase(f"synthesize/{name}"):
            cs, z_next = side.circuit.witness(inp, check=self.debug, timer=self.timer)
        if self.debug and cs.failed:
            raise SynthesisError(f"unsatisfied: {cs.failed[:10]}")
        if cs.num_aux != side.shape.num_aux:
            raise SynthesisError(
                f"witness/shape mismatch: {cs.num_aux} vs {side.shape.num_aux}"
            )
        if defer_commit and side.use_device:
            # The canonical words as the synthesis left them, one copy to
            # the device; the fused fold lifts them there (K3's domain
            # mode) instead of ~15k host bigint mulmods.
            with self.timer.phase(f"synth.encode/{name}"):
                w = CanonicalWitness(side.field.encode_canonical_u64(cs.aux_u64(), side.device))
            return HostInstance(None, [int(v) for v in cs.inputs]), w, z_next
        with self.timer.phase(f"commit/{side.curve_name}"):
            w, comm = side.commit_witness(cs)
        return HostInstance(comm, [int(v) for v in cs.inputs]), w, z_next

    def prove_step(self) -> None:
        """One IVC step (reference prove_step loop, proof.rs:342-349)."""
        pp, d = self.pp, self.pp.digest

        # 1. fold the dangling secondary instance into its accumulator.
        U_sec_old = self.r_U_secondary
        with self.timer.phase("fold/secondary"):
            (
                self.r_U_secondary,
                self.r_W_secondary,
                self.r_E_secondary,
                comm_t_sec,
                _,
                self._zp_secondary,
            ) = pp.secondary.fold_cached(
                d,
                U_sec_old,
                self.r_W_secondary,
                self.r_E_secondary,
                self.l_u_secondary,
                self.l_w_secondary,
                self._zp_secondary,
                check_cache=self.debug,
                timer=self.timer,
            )

        # 2. primary circuit: verifies that fold, applies F.
        inp_p = AugmentedInputs(
            d, self.i, self.z0, self.z_i, U_sec_old, self.l_u_secondary, comm_t_sec
        )
        l_u_p, l_w_p, z_next = self._synth(pp.primary, inp_p)

        # 3. fold the fresh primary instance into its accumulator.
        U_prim_old = self.r_U_primary
        with self.timer.phase("fold/primary"):
            (
                self.r_U_primary,
                self.r_W_primary,
                self.r_E_primary,
                comm_t_prim,
                _,
                self._zp_primary,
            ) = pp.primary.fold_cached(
                d,
                U_prim_old,
                self.r_W_primary,
                self.r_E_primary,
                l_u_p,
                l_w_p,
                self._zp_primary,
                check_cache=self.debug,
                timer=self.timer,
            )

        # 4. secondary circuit: verifies THAT fold (trivial F).
        inp_s = AugmentedInputs(d, self.i, [0], [0], U_prim_old, l_u_p, comm_t_prim)
        l_u_s, l_w_s, _ = self._synth(pp.secondary, inp_s)
        self.l_u_secondary = l_u_s
        self.l_w_secondary = l_w_s

        self.i += 1
        self.z_i = z_next

    def proof(self) -> IVCProof:
        # Finalize the dangling secondary instance: _synth deferred its
        # witness commit (the NEXT fold would compute it fused); a proof
        # handed to the verifier needs it now, and its witness in the
        # accumulators' Montgomery domain.
        if self.l_u_secondary.comm_w is None:
            side = self.pp.secondary
            with self.timer.phase(f"commit/{side.curve_name}"):
                if isinstance(self.l_w_secondary, CanonicalWitness):
                    self.l_w_secondary = side._lift(self.l_w_secondary.limbs)
                self.l_u_secondary.comm_w = side.commit_w(self.l_w_secondary)
        return IVCProof(
            self.i,
            self.z0,
            self.z_i,
            self.r_U_primary,
            self.r_W_primary,
            self.r_E_primary,
            self.r_U_secondary,
            self.r_W_secondary,
            self.r_E_secondary,
            self.l_u_secondary,
            self.l_w_secondary,
        )


def ivc_verify(pp: IVCParams, proof: IVCProof, num_steps: int, z0: list[int],
               zn: list[int]) -> bool:
    """O(1) verification: three hash comparisons + three SAT checks,
    independent of num_steps (reference verify, proof.rs:370-387)."""
    if num_steps == 0 or proof.i != num_steps:
        return False
    p = pp.primary.field.params.modulus
    z0 = [int(v) % p for v in z0]
    zn = [int(v) % p for v in zn]
    if proof.z0 != z0 or [int(v) % p for v in proof.z_i] != zn:
        return False

    d = pp.digest
    h_p = state_hash("Fq", d, num_steps, z0, zn, proof.r_U_secondary)
    if proof.l_u_secondary.X[0] != h_p:
        return False
    h_s = state_hash("Fp", d, num_steps, [0], [0], proof.r_U_primary)
    if proof.l_u_secondary.X[1] != h_s:
        return False

    # range sanity on the running scalars (see the gadget docstrings).
    for U in (proof.r_U_primary, proof.r_U_secondary):
        if not (0 <= U.u < (1 << HASH_BITS)):
            return False

    if not pp.primary.check_sat(proof.r_U_primary, proof.r_W_primary, proof.r_E_primary):
        return False
    if not pp.secondary.check_sat(proof.r_U_secondary, proof.r_W_secondary,
                                  proof.r_E_secondary):
        return False
    return pp.secondary.check_sat(proof.l_u_secondary, proof.l_w_secondary, None)
