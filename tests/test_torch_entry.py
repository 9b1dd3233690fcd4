"""The port's dry-run entry (vdf_tpu_torch.entry) against the repo root's
``__graft_entry__.py`` and host ints, on the CPU.

``entry(device="cpu")``'s example args and one call of its fn equal the
JAX package's ``__graft_entry__.entry()`` on the same 128 lanes, compared
as canonical ints through ``interop`` (exact).  ``dryrun_multichip(2,
device="cpu")`` runs two gloo processes through every section at small
sizes (a 16-point key on ``InverseMinRootCircuit(2)`` for the fold, a
16-point sweep timed once), each section checked against host ints inside
the ranks; the tests below read its facts.  Most of its ~3 min is the
plain K6 of the six ``msm``s rank 0 runs.  The launcher's refusals: no
card, n < 1, and a rank made to fail.
"""

import subprocess

import numpy as np
import pytest
import torch

import __graft_entry__
from vdf_tpu_torch import interop
from vdf_tpu_torch.entry import (
    TP_PATH,
    DryRunError,
    dryrun_multichip,
    entry,
    minroot_oracle,
    sweep_inputs,
)
from vdf_tpu_torch.errors import KernelError
from vdf_tpu_torch.fields import get_field

torch.set_num_threads(1)

SMALL = {"fold_iters": 2, "sweep_points": 16, "sweep_reps": 1}


def test_entry_equals_the_jax_entry():
    fn, args = entry(device="cpu")
    jfn, jargs = __graft_entry__.entry()
    f = get_field("Fq")
    assert all(a.device.type == "cpu" and a.shape == (128, 8) for a in args)
    assert [f.decode(a) for a in args] == \
        [interop.jax_limbs_to_ints("Fq", np.asarray(a)) for a in jargs]
    got = [f.decode(a) for a in fn(*args)]
    want = [interop.jax_limbs_to_ints("Fq", np.asarray(a)) for a in jfn(*jargs)]
    assert got == want
    p, e = f.params.modulus, f.params.inv_alpha
    assert list(zip(*got)) == [minroot_oracle(p, e, (x, 0, 0), 1) for x in range(1, 129)]


@pytest.fixture(scope="module")
def dryrun():
    return dryrun_multichip(2, device="cpu", **SMALL)


def test_dryrun_dp(dryrun):
    assert dryrun["dp"] == {"lanes": 8, "t": 2, "valid": 8}
    assert dryrun["backend"] == "gloo" and dryrun["devices"] == ["cpu", "cpu"]


def test_dryrun_matvec(dryrun):
    mv = dryrun["matvec"]
    assert mv["iters"] == 2 and mv["entries"] > 0 and mv["rows"] > 0


def test_dryrun_tp_fold(dryrun):
    for rank in dryrun["ranks"]:
        fold = rank["sections"]["tp_fold"]
        assert (fold["shape"], fold["key"], fold["path"]) == ("bare t=2", 16, TP_PATH)


def test_dryrun_sweep(dryrun):
    rows = dryrun["sweep"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert rows[0]["t1_over_tN"] == 1.0 and rows[1]["t1_over_tN"] > 0
    assert all(r["points"] == 16 and r["wall_ms_median"] > 0 for r in rows)
    # rank 1 is outside the one-rank sub-mesh: it ran only at N = 2
    assert [r["devices"] for r in dryrun["ranks"][1]["sections"]["sweep"]] == [2]
    assert "no cross-device scaling" in dryrun["scaling"]


def test_dryrun_ranks_report_the_plain_versions(dryrun):
    # CPU ranks run the plain versions: no kernel counter moves.
    for rank in dryrun["ranks"]:
        assert set(rank["launches"]) == {"dp", "matvec", "tp_fold", "sweep"}
        assert not any(n for counts in rank["launches"].values() for n in counts.values())


def test_sweep_inputs_are_the_references():
    aff, sc = sweep_inputs(130)
    assert aff[0] == aff[64] == aff[128] and aff[1] != aff[0]
    assert sc[:2] == [1, 0x9E3779B97F4A7C15 + 1]


def test_dryrun_without_a_card_raises_before_it_spawns(monkeypatch):
    def no_spawn(*args, **kwargs):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(subprocess, "Popen", no_spawn)
    assert not torch.cuda.is_available()
    with pytest.raises(KernelError):
        dryrun_multichip(2)


@pytest.mark.parametrize("n", [0, -1])
def test_dryrun_refuses_fewer_than_one_device(n):
    with pytest.raises(ValueError):
        dryrun_multichip(n, device="cpu")


def test_a_failing_rank_raises_with_its_tail_and_leaves_no_process(monkeypatch):
    started = []
    popen = subprocess.Popen

    def spy(*args, **kwargs):
        started.append(popen(*args, **kwargs))
        return started[-1]

    monkeypatch.setattr(subprocess, "Popen", spy)
    with pytest.raises(DryRunError, match="rank 1 exited") as err:
        dryrun_multichip(2, device="cpu", tamper_rank=1, timeout=300, **SMALL)
    assert "rank 1's lanes of sharded_eval differ" in str(err.value)
    assert len(started) == 2 and all(p.poll() is not None for p in started)
