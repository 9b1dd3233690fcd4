"""The reader of the witness's block counter (``ivc.synth_block_share``) on
hand-made counts: the blocks' share of every element counted, and None where
the program has no such counter, as before it had one, or the run has no
chain."""

from __future__ import annotations

import pytest

from perfbench import spec

OBS = {"ivc": {"steps": 4, "window_s": 30.0, "spans": {}}}


def test_block_share_reads_the_counter(monkeypatch):
    from vdf_tpu_torch.r1cs import witness

    read = spec.metric_reader("ivc.synth_block_share")
    monkeypatch.setattr(witness, "ELEMENTS", {"block": 29_000, "single": 1_000})
    assert read(OBS) == pytest.approx(29_000 / 30_000)
    assert read({}) is None
    monkeypatch.setattr(witness, "ELEMENTS", {"block": 0, "single": 0})
    assert read(OBS) is None


def test_block_share_is_none_without_the_counter(monkeypatch):
    from vdf_tpu_torch.r1cs import witness

    read = spec.metric_reader("ivc.synth_block_share")
    if hasattr(witness, "ELEMENTS"):
        monkeypatch.delattr(witness, "ELEMENTS")  # the program before the counter
    assert read(OBS) is None
