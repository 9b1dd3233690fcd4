"""The port's phase timer (vdf_tpu_torch.utils.profiling) and the kernel
wrappers' host-time counters, on the CPU.

  * A disabled timer (the prover's default) never calls ``sync``, reads no
    clock and keeps nothing; ``type(t)(t.sync)`` records, with the same sync.
  * A recording timer counts nested phases and records each one's
    enclosing span; under a CPU ``torch.profiler`` profile its phases are
    ranges of the trace, nested as they were opened.
  * ``HOST_S`` of fields/kernels.py and curves/kernels.py, keyed like
    ``LAUNCHES``, grows with each wrapper call and ``reset_launches``
    clears it.
"""

from __future__ import annotations

import types

import torch
from torch.profiler import ProfilerActivity, profile

from vdf_tpu_torch.curves import kernels as CK
from vdf_tpu_torch.fields import get_field
from vdf_tpu_torch.fields import kernels as FK
from vdf_tpu_torch.nova.ivc import _timer
from vdf_tpu_torch.utils.profiling import PhaseTimer

torch.set_num_threads(1)  # many small tensor ops; see tests/test_torch_commit.py


class Syncs:
    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1


def test_disabled_timer_calls_no_sync_and_keeps_nothing():
    sync = Syncs()
    off = PhaseTimer(sync, enabled=False)
    ctx = off.phase("fold/primary")
    with ctx, off.phase("fold.commit/pallas"):
        with off.phase("fold.read/pallas"):
            pass
    assert off.phase("synthesize/Fq") is ctx  # one shared no-op context
    assert sync.n == 0 and not off.totals and not off.counts and not off.parents
    on = type(off)(off.sync)  # what bench.py and chip_smoke.py swap in
    assert on.enabled and on.sync is sync
    with on.phase("fold/primary"):
        pass
    assert sync.n == 2 and on.counts["fold/primary"] == 1


def test_the_provers_default_timer_is_off_with_the_cards_sync(monkeypatch):
    """A device engine on a card: its default timer keeps the card's sync for
    a recording timer to use, and calls it for no phase of its own."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: calls.append(dev))
    card = torch.device("cuda", 0)
    pp = types.SimpleNamespace(primary=types.SimpleNamespace(use_device=True, device=card))
    t = _timer(pp)
    assert not t.enabled
    for name in ("fold/secondary", "synthesize/Fq", "fold/primary", "synthesize/Fp"):
        with t.phase(name):
            pass
    assert calls == []
    t.sync()
    assert calls == [card]
    native = types.SimpleNamespace(primary=types.SimpleNamespace(use_device=False, device=None))
    assert not _timer(native).enabled and _timer(native).sync is None


def test_recording_timer_counts_nested_phases():
    sync = Syncs()
    t = PhaseTimer(sync)
    for _ in range(3):
        with t.phase("fold/primary"):
            with t.phase("fold.commit/pallas"):
                pass
            with t.phase("fold.read/pallas"):
                pass
    with t.phase("synthesize/Fq"):
        pass
    assert dict(t.counts) == {"fold/primary": 3, "fold.commit/pallas": 3, "fold.read/pallas": 3,
                              "synthesize/Fq": 1}
    assert sync.n == 2 * 10
    assert t.parents == {"fold/primary": None, "fold.commit/pallas": "fold/primary",
                         "fold.read/pallas": "fold/primary", "synthesize/Fq": None}
    assert set(t.under()) == {"fold/primary", "synthesize/Fq"}
    assert set(t.under("fold/primary")) == {"fold.commit/pallas", "fold.read/pallas"}
    assert t.totals["fold/primary"] >= t.totals["fold.commit/pallas"] + t.totals["fold.read/pallas"]
    try:  # a phase that raises is not recorded and leaves the nesting sound
        with t.phase("fold/secondary"):
            raise ValueError
    except ValueError:
        pass
    assert "fold/secondary" not in t.counts
    with t.phase("synthesize/Fp"):
        pass
    assert t.parents["synthesize/Fp"] is None


def test_recording_phases_are_profiler_ranges():
    t = PhaseTimer()
    off = PhaseTimer(enabled=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.phase("perf.outer"):
            with t.phase("perf.inner"):
                torch.ones(4).sum()
        with off.phase("perf.off"):
            pass
    with t.phase("perf.after"):  # no profile is active: no range, still recorded
        pass
    events = {e.name: e for e in prof.events()}
    assert "perf.outer" in events and "perf.inner" in events
    assert "perf.off" not in events and "perf.after" not in events
    outer, inner = events["perf.outer"], events["perf.inner"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert t.counts["perf.after"] == 1


def test_reset_launches_clears_host_seconds():
    f = get_field("Fq")
    a = f.encode([3, 5, 7], "cpu")
    f.add(a, a)
    CK.canon_mont("Fq", a)
    assert set(FK.HOST_S) == set(FK.LAUNCHES) and set(CK.HOST_S) == set(CK.LAUNCHES)
    assert FK.HOST_S["field_ew"] > 0 and CK.HOST_S["canon_mont"] > 0
    FK.reset_launches()
    CK.reset_launches()
    assert not any(FK.HOST_S.values()) and not any(CK.HOST_S.values())
