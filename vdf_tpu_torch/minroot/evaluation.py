"""Vanilla (non-SNARK) VDF proof objects: eval, verify, append.

Mirrors reference ``Evaluation<V, G>`` (src/minroot.rs:376-439) and
``vdf_tpu.minroot.evaluation``: an evaluation claim ``{result, t}``
verified by running the fast inverse direction, and ``append``, which
chains proofs by verifying at the seam and summing ``t``.  Eval runs
K1 and verify runs K2 when the state lies on a CUDA device.
"""

from __future__ import annotations

import dataclasses

from ..fields import get_field
from .vdf import EvalMode, MinRootVDF, State


@dataclasses.dataclass
class Evaluation:
    """Claim: ``eval(original, t) == result`` for some original state."""

    result: State
    t: int
    field_name: str
    mode: str = EvalMode.LTR_SEQUENTIAL.value

    @classmethod
    def eval(cls, vdf: MinRootVDF, x: State, t: int) -> tuple[list, "Evaluation"]:
        """Run the slow direction; returns (z0, proof) like the reference
        (z0 = [result.x, result.y, result.i], src/minroot.rs:394-408)."""
        result = vdf.eval(x, t)
        z0 = [result.x, result.y, result.i]
        return z0, cls(result, t, vdf.field.params.name, vdf.mode.value)

    @classmethod
    def eval_with_mode(
        cls, mode: EvalMode, vdf: MinRootVDF, x: State, t: int
    ) -> "Evaluation":
        """Reference ``eval_with_mode`` (src/minroot.rs:410-418)."""
        return cls.eval(MinRootVDF(vdf.field, EvalMode(mode)), x, t)[1]

    def _vdf(self) -> MinRootVDF:
        return MinRootVDF(get_field(self.field_name), EvalMode(self.mode))

    def verify(self, original: State) -> bool:
        """Check result == eval(original, t) by inverting (fast direction)."""
        return bool(self._vdf().check(self.result, self.t, original).all())

    def append(self, other: "Evaluation") -> "Evaluation | None":
        """Chain: valid iff ``other`` extends this proof's result.
        Returns the combined proof or None (src/minroot.rs:428-438)."""
        if other.verify(self.result):
            return Evaluation(other.result, self.t + other.t, self.field_name, self.mode)
        return None
