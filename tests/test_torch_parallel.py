"""The port's multi-process entry (vdf_tpu_torch.parallel) on the CPU: two
gloo ranks, mirroring tests/test_multihost.py.

Two OS processes (tests/_torch_parallel_worker.py) join one process group
through a ``file://`` store and run every sharded function against host
ints, mostly through the dry run's sections (vdf_tpu_torch/entry.py):
``sharded_eval``/``sharded_check`` (K1/K2's plain versions on each rank's
lanes, one all_reduce), ``sharded_matvec`` (one all_gather),
``sharded_msm`` at 63 points (padded; the port's ``msm`` on each rank's
block, one all_gather), and tensor-parallel IVC folds on a 16-point key
against the native fold (the dry run's, twice, and a deferred-commit one
with its check_sat).  Each check below reads one line of both ranks'
output.  Most of the ~3 min is the plain K6 of the seven MSMs a rank runs
(~25 s each on one core).
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "_torch_parallel_worker.py")
NPROC = 2


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    store = tmp_path_factory.mktemp("pg") / "store"
    env_base = {k: v for k, v in os.environ.items() if not k.startswith("VDF_")}
    procs = []
    for pid in range(NPROC):
        env = dict(env_base, VDF_COORD=f"file://{store}", VDF_NPROC=str(NPROC), VDF_PID=str(pid),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, _WORKER], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=900)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-25:])
        assert p.returncode == 0, f"rank {pid} failed:\n{tail}"
    return outs


@pytest.mark.parametrize("check", ["mesh", "eval", "check", "matvec", "msm", "tp_fold",
                                   "tp_params"])
def test_two_rank_gloo(outputs, check):
    for pid, out in enumerate(outputs):
        assert any(line.startswith(f"ok {check}") for line in out.splitlines()), \
            f"rank {pid} printed no 'ok {check}':\n{out[-2000:]}"


def test_both_ranks_finish(outputs):
    assert all("PARALLEL_OK" in out for out in outputs)
