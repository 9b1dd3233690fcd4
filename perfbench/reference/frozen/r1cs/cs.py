"""R1CS constraint system construction (the framework's bellperson tier).

A copy of ``vdf_tpu.r1cs.cs`` (host-integer code; the port cannot import
that package, which pulls in jax).

Plays the role of bellperson's ``ConstraintSystem`` / ``LinearCombination``
(SURVEY.md §2 D6, used by the reference circuit at
src/nova/proof.rs:3-9,155-230), re-designed for a
host-synthesis / device-prove split:

  * Synthesis runs ONCE on the host in Python and produces static sparse
    A, B, C matrices (exact integer coefficients, COO).
  * Witness values are torch limb tensors; the same circuit code runs the
    value pass (r1cs/witness.py) eagerly on the values' device.
  * Variable layout follows Nova's convention directly:
    ``z = (W aux..., u, X inputs...)`` — column 0..n_aux-1 are witness,
    column n_aux is the relaxation scalar u (bellperson's ONE), then the
    public inputs.
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Callable, NamedTuple

import numpy as np


class Variable(NamedTuple):
    """Either an aux (witness) var or an input (public IO) var; ``ONE`` is
    input 0, matching bellperson's convention.  A NamedTuple so hashing
    (the hottest op in synthesis — every LC merge hashes every term) runs
    at C tuple speed."""

    kind: str  # "aux" | "input"
    index: int


ONE = Variable("input", 0)


class _NullLC:
    """Absorbing no-op linear combination, used when LCs are pure
    overhead: the value-only witness pass (check=False) never reads a
    constraint, so every LC op collapses to this singleton.  Enabled via
    ``lc_sink`` by the witness synthesizers (nova/augmented.py,
    nova/circuit.py); cut augmented witness synthesis ~2x on top of the
    sponge-local fast path in the JAX package."""

    __slots__ = ()
    terms: dict = {}

    def add(self, var, coeff: int = 1) -> "_NullLC":
        return self

    def __add__(self, other) -> "_NullLC":
        return self

    def __radd__(self, other) -> "_NullLC":
        return self

    def __sub__(self, other) -> "_NullLC":
        return self

    def __rsub__(self, other) -> "_NullLC":
        return self

    def scale(self, k: int) -> "_NullLC":
        return self


NULL_LC = _NullLC()

# Per-context flag, NOT a process global: prove_interleaved runs K
# witness syntheses on K threads, and a global would let one thread's
# lc_sink __exit__ re-enable LC building mid-synthesis in the others
# (losing the value-only fast path, and corrupting a concurrent
# check=True pass).  contextvars gives each thread (and task) its own
# value (advisor r4).
_LC_DISABLED = contextvars.ContextVar("vdf_tpu_torch_lc_disabled", default=False)


class _LCSink:
    def __init__(self, disabled: bool):
        self.disabled = disabled

    def __enter__(self):
        self._token = _LC_DISABLED.set(self.disabled)
        return self

    def __exit__(self, *a):
        _LC_DISABLED.reset(self._token)


def lc_sink(disabled: bool = True) -> "_LCSink":
    """Context manager: route every ``LinearCombination.of`` to NULL_LC
    (value-only witness synthesis; see _NullLC)."""
    return _LCSink(disabled)


class LinearCombination:
    """Sparse integer-coefficient combination of variables."""

    __slots__ = ("terms",)

    def __init__(self, terms: dict | None = None):
        self.terms: dict[Variable, int] = dict(terms or {})

    @classmethod
    def of(cls, var: Variable, coeff: int = 1):
        if _LC_DISABLED.get():
            return NULL_LC
        return cls({var: coeff})

    def add(self, var: Variable, coeff: int = 1) -> "LinearCombination":
        out = LinearCombination(self.terms)
        out.terms[var] = out.terms.get(var, 0) + coeff
        return out

    def __add__(self, other: "LinearCombination") -> "LinearCombination":
        out = LinearCombination(self.terms)
        for v, c in other.terms.items():
            out.terms[v] = out.terms.get(v, 0) + c
        return out

    def __sub__(self, other: "LinearCombination") -> "LinearCombination":
        out = LinearCombination(self.terms)
        for v, c in other.terms.items():
            out.terms[v] = out.terms.get(v, 0) - c
        return out

    def scale(self, k: int) -> "LinearCombination":
        return LinearCombination({v: c * k for v, c in self.terms.items()})


@dataclasses.dataclass
class R1CSShape:
    """Static sparse A, B, C (COO, exact int coeffs reduced mod p)."""

    num_cons: int
    num_aux: int  # |W|
    num_inputs: int  # |X| (excluding u)
    modulus: int
    a_coo: tuple[np.ndarray, np.ndarray, list]  # rows, cols, int coeffs
    b_coo: tuple[np.ndarray, np.ndarray, list]
    c_coo: tuple[np.ndarray, np.ndarray, list]

    @property
    def num_vars(self) -> int:
        """Total z length: W + u + X."""
        return self.num_aux + 1 + self.num_inputs

    def col_of(self, var: Variable) -> int:
        if var.kind == "aux":
            return var.index
        if var.index == 0:
            return self.num_aux  # u column
        return self.num_aux + var.index  # X starts right after u

    # -- host-side exact evaluation (testing / debugging) ---------------

    def eval_lc_matrix(self, coo, z: list[int]) -> list[int]:
        rows, cols, coeffs = coo
        out = [0] * self.num_cons
        for r, c, k in zip(rows, cols, coeffs):
            out[r] = (out[r] + k * z[c]) % self.modulus
        return out

    def is_satisfied(self, w: list[int], x: list[int], u: int = 1, e=None) -> bool:
        """Az o Bz == u*Cz + E over exact ints (relaxed form; E=0, u=1 for
        plain R1CS)."""
        z = list(w) + [u] + list(x)
        assert len(z) == self.num_vars
        az = self.eval_lc_matrix(self.a_coo, z)
        bz = self.eval_lc_matrix(self.b_coo, z)
        cz = self.eval_lc_matrix(self.c_coo, z)
        e = e or [0] * self.num_cons
        p = self.modulus
        return all(
            (az[i] * bz[i]) % p == (u * cz[i] + e[i]) % p for i in range(self.num_cons)
        )


class ShapeCS:
    """Synthesis pass: builds the R1CS shape (no values)."""

    def __init__(self, modulus: int):
        self.modulus = modulus
        self.num_aux = 0
        self.num_inputs = 1  # ONE
        self.constraints: list[tuple] = []  # (a_lc, b_lc, c_lc, name)
        self._ns: list[str] = []

    # namespacing (bellperson-style, for debuggability)
    class _Namespace:
        def __init__(self, cs, name):
            self.cs, self.name = cs, name

        def __enter__(self):
            self.cs._ns.append(self.name)
            return self.cs

        def __exit__(self, *a):
            self.cs._ns.pop()

    def namespace(self, name: str) -> "_Namespace":
        return self._Namespace(self, name)

    def _path(self, name: str) -> str:
        return "/".join(self._ns + [name])

    def alloc(self, name: str = "aux") -> Variable:
        v = Variable("aux", self.num_aux)
        self.num_aux += 1
        return v

    def alloc_input(self, name: str = "input") -> Variable:
        v = Variable("input", self.num_inputs)
        self.num_inputs += 1
        return v

    def enforce(
        self,
        a: LinearCombination,
        b: LinearCombination,
        c: LinearCombination,
        name: str = "",
    ) -> None:
        self.constraints.append((a, b, c, self._path(name)))

    def shape(self) -> R1CSShape:
        shape = R1CSShape(
            num_cons=len(self.constraints),
            num_aux=self.num_aux,
            num_inputs=self.num_inputs - 1,
            modulus=self.modulus,
            a_coo=None,
            b_coo=None,
            c_coo=None,
        )

        def build(which):
            rows, cols, coeffs = [], [], []
            for r, cons in enumerate(self.constraints):
                for var, k in cons[which].terms.items():
                    k = k % self.modulus
                    if k == 0:
                        continue
                    rows.append(r)
                    cols.append(shape.col_of(var))
                    coeffs.append(k)
            return (
                np.asarray(rows, dtype=np.int32),
                np.asarray(cols, dtype=np.int32),
                coeffs,
            )

        shape.a_coo = build(0)
        shape.b_coo = build(1)
        shape.c_coo = build(2)
        return shape
