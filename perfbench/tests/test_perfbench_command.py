"""The command as ``BENCHMARK.json`` names it: it refuses to run without a card
and prints no result; on a card (``gpu`` tests) a short run of a cell
prints one whole result line."""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def command(cwd, *args, timeout=600):
    return subprocess.run([sys.executable, "-m", "perfbench", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def _has_card() -> bool:
    import torch

    return torch.cuda.is_available()


def test_no_card_no_result():
    if _has_card():
        pytest.skip("this machine has a card")
    out = command(ROOT, "--workload", "minroot.lane1", "--seed", str(2**33 + 1), "--seconds",
                  "1", "--trace", "0")
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory with BENCHMARK.json and perfbench/ only, the program absent."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command(tmp_path, "--workload", "minroot.lane1", "--seed", "5", "--seconds", "1",
                  "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""


def test_unknown_cell_is_refused():
    out = command(ROOT, "--workload", "nosuch.cell", "--seed", "1", "--seconds", "1",
                  "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.gpu
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_short_run_on_the_card(trace):
    if not _has_card():
        pytest.skip("no CUDA card")
    out = command(ROOT, "--workload", "minroot.lane1", "--seed", str(2**31 + 99), "--seconds",
                  "2", "--trace", trace)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
