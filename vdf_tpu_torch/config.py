"""Unified runtime configuration: ``ProverConfig``.

Port of ``vdf_tpu.config``.  The reference's only runtime configuration is
``EvalMode`` plus the numeric parameters t / num_steps threaded through
its APIs (src/minroot.rs:15-31, src/nova/proof.rs:232, 262-267).  This
framework has more axes (engine, lane counts, shard mesh, checkpointing);
``ProverConfig`` gathers them in one frozen dataclass with environment
overrides, and its methods turn a config into ready-to-use objects.

Environment overrides (read by ``ProverConfig.from_env``):

  VDF_TPU_EVAL_MODE   one of EvalMode's values
  VDF_TPU_T           iterations folded per IVC step
  VDF_TPU_LANES       DP lanes for batched evaluation
  VDF_TPU_ENGINE      device | native
  VDF_TPU_SHARDS      TP mesh size (1 = no tensor parallelism)
  VDF_TPU_CHECKPOINT  directory for proof-carrying checkpoints

``engine`` takes the port's names: ``"device"`` (the default: the card, or
``device`` when one is named) and ``"native"`` (the C++/int host plane).
There is no ``"auto"``: the port makes no automatic choice of engine
(nova/ivc.py).
"""

from __future__ import annotations

import dataclasses
import os

from .nova.ivc import ENGINES


@dataclasses.dataclass(frozen=True)
class ProverConfig:
    """Everything needed to stand up the prover stack."""

    eval_mode: str = "ltr_sequential"  # forward-step schedule (EvalMode)
    t: int = 32  # VDF iterations per IVC step (circuit size ~ 3t + overhead)
    lanes: int = 16384  # DP lanes for batched VDF evaluation
    engine: str = "device"  # data plane: "device" | "native"
    shards: int = 1  # TP mesh size for MSM/matvec sharding
    checkpoint_dir: str | None = None  # proof-carrying checkpoints (checkpoint.py)
    debug_synthesis: bool = False  # TestConstraintSystem-style witness checks
    device: str | None = None  # the device engine's device (None: the card)

    def __post_init__(self):
        from .minroot import EvalMode

        EvalMode(self.eval_mode)  # validate early
        if self.t < 1:
            raise ValueError("t must be >= 1")
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}: the port's engines are {ENGINES}")
        if self.shards < 1:
            raise ValueError("shards must be >= 1")

    @classmethod
    def from_env(cls, **overrides) -> "ProverConfig":
        env = os.environ
        kw = dict(
            eval_mode=env.get("VDF_TPU_EVAL_MODE", cls.eval_mode),
            t=int(env.get("VDF_TPU_T", cls.t)),
            lanes=int(env.get("VDF_TPU_LANES", cls.lanes)),
            engine=env.get("VDF_TPU_ENGINE", cls.engine),
            shards=int(env.get("VDF_TPU_SHARDS", cls.shards)),
            checkpoint_dir=env.get("VDF_TPU_CHECKPOINT", cls.checkpoint_dir),
        )
        kw.update(overrides)
        return cls(**kw)

    # -- materialization ------------------------------------------------

    def vdf(self):
        """The configured MinRoot VDF (lane batching is caller-shaped)."""
        from .minroot import EvalMode, pallas_vdf

        return pallas_vdf(EvalMode(self.eval_mode))

    def mesh(self):
        """The TP shard mesh, or None when shards == 1: a ``parallel.Mesh``
        over the first ``shards`` ranks of the initialized process group
        (``parallel.distributed.initialize``); raises if the group is
        smaller.  Every rank of the group calls it."""
        if self.shards == 1:
            return None
        from .parallel import SHARD_AXIS, make_mesh

        return make_mesh(self.shards, axis=SHARD_AXIS)

    def public_params(self):
        """IVC public params for this config (cached per (t, engine, device,
        mesh))."""
        from .nova.ivc import ivc_public_params

        return ivc_public_params(self.t, engine=self.engine, device=self.device,
                                 mesh=self.mesh())

    def prover(self, z0: list[int]):
        """A ready RecursiveIVC over this config's params."""
        from .nova.ivc import RecursiveIVC

        return RecursiveIVC(self.public_params(), z0, debug=self.debug_synthesis)
