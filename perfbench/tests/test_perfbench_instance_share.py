"""The reader of the instance fold's counter (``ivc.instance_native_share``)
on hand-made counts: the native call's share of every commitment pair
counted, and None where the program has no such counter, as before it had
one, or the run has no chain."""

from __future__ import annotations

import pytest

from perfbench import spec

OBS = {"ivc": {"steps": 4, "window_s": 30.0, "spans": {}}}


def test_instance_share_reads_the_counter(monkeypatch):
    from vdf_tpu_torch.nova import ivc

    read = spec.metric_reader("ivc.instance_native_share")
    monkeypatch.setattr(ivc, "INSTANCE_FOLDS", {"native": 3_996, "int": 4})
    assert read(OBS) == pytest.approx(3_996 / 4_000)
    monkeypatch.setattr(ivc, "INSTANCE_FOLDS", {"native": 0, "int": 0})
    assert read(OBS) is None


def test_instance_share_is_none_outside_a_chain(monkeypatch):
    from vdf_tpu_torch.nova import ivc

    read = spec.metric_reader("ivc.instance_native_share")
    monkeypatch.setattr(ivc, "INSTANCE_FOLDS", {"native": 10, "int": 0})
    assert read({}) is None
    assert read({"ivc": None}) is None


def test_instance_share_is_none_without_the_counter(monkeypatch):
    from vdf_tpu_torch.nova import ivc

    read = spec.metric_reader("ivc.instance_native_share")
    if hasattr(ivc, "INSTANCE_FOLDS"):
        monkeypatch.delattr(ivc, "INSTANCE_FOLDS")  # the program before the counter
    assert read(OBS) is None
