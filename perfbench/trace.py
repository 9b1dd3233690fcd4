"""The traced run: a ``torch.profiler`` trace of the window, reduced to the
device's busy time, the kernels' time by name and the idle gaps.

The harness opens ``perfbench.window`` around the timed loop and drivers
open spans of their own (``Spans``) around the calls they make; all are
``record_function`` ranges, so they land in the trace beside the kernels.
Device intervals are every CUDA activity (kernels, copies, sets) that the
profiler recorded, clipped to the window; the images of the host's ranges
on the device's timeline are left out.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time

WINDOW_SPAN = "perfbench.window"


class Spans:
    """A ``PhaseTimer`` look-alike (``phase(name)``, ``totals``, ``counts``,
    ``sync``) that also opens a profiler range of the same name.  Given to the
    program where it takes a timer, and used by drivers around their calls."""

    def __init__(self, sync=None, record: bool = False):
        self.sync = sync
        self.record = record
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        rf = contextlib.nullcontext()
        if self.record:
            from torch.profiler import record_function

            rf = record_function(name)
        with rf:
            if self.sync is not None:
                self.sync()
            t0 = time.perf_counter()
            yield
            if self.sync is not None:
                self.sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """A profiler's events reduced to what the metrics read."""

    def __init__(self, prof, span_names=()):
        from torch.autograd import DeviceType

        span_names = set(span_names)

        window = None
        self.device: list[tuple[int, int, str]] = []
        self.host: list[tuple[int, int, str]] = []
        for ev in prof.profiler.kineto_results.events():
            a = ev.start_ns()
            b = a + ev.duration_ns()
            name = ev.name()
            if ev.device_type() == DeviceType.CUDA:
                # a range's image on the device's timeline is no device work
                if name != WINDOW_SPAN and name not in span_names:
                    self.device.append((a, b, name))
            elif name == WINDOW_SPAN:
                window = (a, b)
            elif name in span_names:
                self.host.append((a, b, name))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} range")
        self.window = window
        w0, w1 = window
        self.device = [(max(a, w0), min(b, w1), n) for a, b, n in self.device if b > w0 and a < w1]
        self.busy = _union([(a, b) for a, b, _ in self.device])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-9

    def kernel_s(self, names) -> float:
        """Device seconds of the activities whose name contains one of
        ``names``, overlaps counted once."""
        sel = [(a, b) for a, b, n in self.device if any(k in n for k in names)]
        return sum(b - a for a, b in _union(sel)) * 1e-9

    def idle_pct(self) -> float | None:
        """The device's idle share of the window (%), None where it did nothing."""
        if self.window_s <= 0 or self.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def device_ops(self, top: int = 10) -> list[list]:
        by = collections.defaultdict(int)
        for a, b, n in self.device:
            by[n] += b - a
        return [[n, v * 1e-9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def _innermost(self):
        """Change points (time, name) of the innermost host range open; the
        ranges nest, as they are opened by one thread in ``with`` blocks."""
        pts, stack = [], []
        for s0, s1, n in sorted(self.host, key=lambda r: (r[0], -r[1])):
            while stack and stack[-1][1] <= s0:
                end = stack.pop()[1]
                pts.append((end, stack[-1][2] if stack else None))
            stack.append((s0, s1, n))
            pts.append((s0, n))
        while stack:
            end = stack.pop()[1]
            pts.append((end, stack[-1][2] if stack else None))
        return [t for t, _ in pts], [n for _, n in pts]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Idle device time in the window, by the innermost host range open
        at each gap's middle (``(no host range)`` where none is)."""
        w0, w1 = self.window
        edges = [w0] + [x for iv in self.busy for x in iv] + [w1]
        times, names = self._innermost()
        by = collections.defaultdict(int)
        for k in range(0, len(edges), 2):
            a, b = edges[k], edges[k + 1]
            if b <= a:
                continue
            j = bisect.bisect_right(times, (a + b) // 2) - 1
            by[(names[j] if j >= 0 else None) or "(no host range)"] += b - a
        return [[n, v * 1e-9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


@contextlib.contextmanager
def profiled(enabled: bool, span_names):
    """Yields a holder whose ``trace`` is set once the window closes: a
    ``Trace`` when ``enabled``, else None.  ``span_names()`` gives, after the
    window, the names of the host ranges to keep."""
    holder = type("Holder", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            yield holder
    holder.trace = Trace(prof, span_names())
