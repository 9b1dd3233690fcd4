"""The reader of the permutation memo's counter (``ivc.perm_reuse_share``)
on hand-made counts: the share of the in-circuit sponge's permutations
served from the memo, and None where the program has no such counter, as
before it had one, or the run has no chain."""

from __future__ import annotations

import pytest

from perfbench import spec

OBS = {"ivc": {"steps": 4, "window_s": 30.0, "spans": {}}}


def test_perm_reuse_share_reads_the_counter(monkeypatch):
    from vdf_tpu_torch.poseidon import int_poseidon

    read = spec.metric_reader("ivc.perm_reuse_share")
    monkeypatch.setattr(int_poseidon, "PERMS", {"reused": 23, "computed": 11})
    assert read(OBS) == pytest.approx(23 / 34)
    monkeypatch.setattr(int_poseidon, "PERMS", {"reused": 0, "computed": 0})
    assert read(OBS) is None


def test_perm_reuse_share_is_none_outside_a_chain(monkeypatch):
    from vdf_tpu_torch.poseidon import int_poseidon

    read = spec.metric_reader("ivc.perm_reuse_share")
    monkeypatch.setattr(int_poseidon, "PERMS", {"reused": 10, "computed": 0})
    assert read({}) is None
    assert read({"ivc": None}) is None


def test_perm_reuse_share_is_none_without_the_counter(monkeypatch):
    from vdf_tpu_torch.poseidon import int_poseidon

    read = spec.metric_reader("ivc.perm_reuse_share")
    if hasattr(int_poseidon, "PERMS"):
        monkeypatch.delattr(int_poseidon, "PERMS")  # the program before the counter
    assert read(OBS) is None
