"""Named spans of the prover's phases (port of
``vdf_tpu.utils.profiling.PhaseTimer``).

The program opens a span with ``timer.phase(name)`` on the timer its caller
gave it, or on one it made itself; a caller may put any object with the same
``phase``, ``sync``, ``totals`` and ``counts`` in its place.

A recording timer (``PhaseTimer(sync)``) records of each span its name, its
host start and end (the difference summed into ``totals[name]``, one more in
``counts[name]``) and its enclosing span, the span of this timer open around
it when it opened (``parents[name]``, None for an outermost one).  Given a
``sync`` callable (the device engine's is ``torch.cuda.synchronize``), it
calls it before both readings of the clock, so the kernels a span queues
count in that span and work queued before it does not.  While a
``torch.profiler`` profile is active, each span is also a
``record_function`` range of its name, so the trace shows it on the kernels'
clock, nested as the spans nest.

A disabled timer (``enabled=False``; the default of ``RecursiveIVC``,
``ivc_compress`` and ``spartan_prove``) is free: ``phase`` returns one shared
no-op context, reads no clock, never calls ``sync`` and records nothing.  It
keeps ``sync``, so ``type(t)(t.sync)`` builds a recording timer that
synchronises as the program would have.

Spans nest as the ``with`` blocks of one thread nest: a timer serves one
thread.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


class PhaseTimer:
    """Accumulates wall-clock seconds, calls and the enclosing span per named
    phase; with ``enabled=False``, nothing."""

    def __init__(self, sync=None, enabled: bool = True):
        self.sync = sync
        self.enabled = enabled
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)
        self.parents: dict[str, str | None] = {}
        self._open: list[str] = []

    def phase(self, name: str):
        return self._span(name) if self.enabled else _OFF

    @contextlib.contextmanager
    def _span(self, name: str):
        profiled = torch._C._autograd._profiler_enabled()
        with record_function(name) if profiled else _OFF:
            if self.sync is not None:
                self.sync()
            self.parents.setdefault(name, self._open[-1] if self._open else None)
            self._open.append(name)
            try:
                t0 = time.perf_counter()
                yield
                if self.sync is not None:
                    self.sync()
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1
            finally:
                self._open.pop()

    def under(self, parent: str | None = None) -> dict[str, float]:
        """Seconds of the spans opened directly inside ``parent`` (None: the
        outermost ones), by name."""
        return {n: self.totals[n] for n, p in self.parents.items() if p == parent}
