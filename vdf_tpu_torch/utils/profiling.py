"""Per-phase wall-clock timing of the IVC prover (port of
``vdf_tpu.utils.profiling.PhaseTimer``).

A phase reads the host clock at its start and its end.  Given a ``sync``
callable (the device engine passes ``torch.cuda.synchronize``), it calls it
before both readings, so the kernels a phase queues count in that phase and
work queued before it does not.  The JAX package's named scopes and
profiler traces have no counterpart here.
"""

from __future__ import annotations

import collections
import contextlib
import time


class PhaseTimer:
    """Accumulates wall-clock seconds and calls per named phase."""

    def __init__(self, sync=None):
        self.sync = sync
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.sync is not None:
            self.sync()
        t0 = time.perf_counter()
        yield
        if self.sync is not None:
            self.sync()
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {"seconds": round(self.totals[name], 4), "calls": self.counts[name]}
            for name in sorted(self.totals)
        }
