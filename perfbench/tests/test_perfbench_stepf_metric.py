"""The reader of the step circuit's spans (``ivc.synth_stepf_ms``) on
hand-made observations: it sums the ``synth.stepf/*`` spans and no other,
over the steps, and gives None where the program opens no such span."""

from __future__ import annotations

import pytest

from perfbench import spec

SPANS = {"synthesize/Fq": 0.040, "synthesize/Fp": 0.030, "fold/primary": 0.010,
         "fold/secondary": 0.008, "synth.alloc/Fq": 0.001, "synth.h_in/Fq": 0.002,
         "synth.fold/Fq": 0.010, "synth.base/Fq": 0.001, "synth.stepf/Fq": 0.020,
         "synth.h_out/Fq": 0.002, "synth.alloc/Fp": 0.001, "synth.fold/Fp": 0.012,
         "synth.stepf/Fp": 0.0005, "synth.h_out/Fp": 0.006}
STEPF = ("synth.stepf/Fq", "synth.stepf/Fp")


def _obs(steps: int, spans: dict) -> dict:
    return {"ivc": {"steps": steps, "window_s": 30.0, "spans": dict(spans)}}


@pytest.mark.parametrize("steps", [1, 2, 700])
def test_stepf_reader_sums_its_spans(steps):
    read = spec.metric_reader("ivc.synth_stepf_ms")
    want = 1e3 * sum(SPANS[k] for k in STEPF) / steps
    assert read(_obs(steps, SPANS)) == pytest.approx(want)


def test_stepf_reader_counts_one_side_alone():
    """A run whose secondary opens no step span reads the primary's alone."""
    read = spec.metric_reader("ivc.synth_stepf_ms")
    spans = {k: v for k, v in SPANS.items() if k != "synth.stepf/Fp"}
    assert read(_obs(4, spans)) == pytest.approx(1e3 * SPANS["synth.stepf/Fq"] / 4)


def test_stepf_reader_is_none_without_its_spans():
    read = spec.metric_reader("ivc.synth_stepf_ms")
    old = {k: v for k, v in SPANS.items() if k not in STEPF}
    assert read(_obs(4, old)) is None  # a program that opens no step span
    assert read(_obs(0, SPANS)) is None
    assert read({}) is None
