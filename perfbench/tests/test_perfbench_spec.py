"""BENCHMARK.json and the files it names: every piece is found by name, a
new cell or metric is picked up from files alone, and every name, unit and
limit is one the benchmark's contract allows."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from perfbench import spec

BENCH = spec.benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"] == ["python3", "-m", "perfbench"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_exist(cell):
    entry = spec.find_cell(BENCH, cell)
    wl = spec.workload(cell)
    assert (wl["config"], wl["traffic"]) == (entry["config"], entry["traffic"])
    spec.config(wl["config"])
    spec.driver(wl["driver"])
    for m in spec.cell_metrics(BENCH, entry, "per_layer"):
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_enough(cell):
    entry = spec.find_cell(BENCH, cell)
    e2e = {m["name"] for m in spec.cell_metrics(BENCH, entry, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.cell_metrics(BENCH, entry, "per_layer")
    assert entry["chips"] == 1 and ONE_LINE.match(entry["why"])


def test_names_units_and_entries():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (spec.ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
        assert ONE_LINE.match(c["source"]) and ONE_LINE.match(c["why"])
        assert all(spec.NAME_RE.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert spec.NAME_RE.match(w["traffic"]) and w["config"] in names
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            extra = {"bound"} if kind == "end_to_end" else {"layer", "moves"}
            assert set(m) - {"workloads"} == {"name", "unit", "better", "source"} | extra
            assert spec.UNIT_RE.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert set(m.get("workloads", CELLS)) <= set(CELLS)
            names.append(m["name"])
    names += CELLS
    assert all(spec.NAME_RE.match(n) for n in names)
    assert len(names) == len(set(names))


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and ONE_LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_new_cell_and_metric_from_files_alone(tmp_path, monkeypatch):
    """A copy of the benchmark gains a cell and a per-layer metric by new
    files and new entries only; the harness finds both."""
    pkg = tmp_path / "perfbench"
    shutil.copytree(spec.PKG, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(spec.BENCHMARK.read_text())
    bench["workloads"].append({"name": "minroot.lanes64", "config": "minroot_fq",
                               "traffic": "lanes64", "chips": 1, "why": "64 lanes"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "minroot.lane1" in m.get("workloads", ()):
            m["workloads"].append("minroot.lanes64")
    bench["per_layer"].append({"name": "minroot.segments", "unit": "segments",
                               "better": "higher", "source": "program_counter",
                               "layer": "kernel K1", "moves": "vdf_iters_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (pkg / "workloads" / "minroot.lanes64.json").write_text(json.dumps(
        {"config": "minroot_fq", "traffic": "lanes64", "driver": "minroot",
         "params": {"lanes": 64}}))
    (pkg / "metrics" / "minroot.segments.py").write_text(
        "def read(obs):\n    return obs['minroot']['segments']\n")
    monkeypatch.setattr(spec, "PKG", pkg)
    monkeypatch.setattr(spec, "BENCHMARK", tmp_path / "BENCHMARK.json")

    b = spec.benchmark()
    cell = spec.find_cell(b, "minroot.lanes64")
    assert spec.workload("minroot.lanes64")["params"] == {"lanes": 64}
    layer = {m["name"] for m in spec.cell_metrics(b, cell, "per_layer")}
    assert {"minroot.segments", "minroot.round_us", "idle_pct.vdf"} <= layer
    # the metric without ``workloads`` is in every cell reporting what it moves
    other = {m["name"] for m in spec.cell_metrics(b, spec.find_cell(b, "minroot.lane1"),
                                                   "per_layer")}
    assert "minroot.segments" in other
    chain = {m["name"] for m in spec.cell_metrics(b, spec.find_cell(b, "ivc_t100.chain"),
                                                   "per_layer")}
    assert "minroot.segments" not in chain
    assert spec.metric_reader("minroot.segments")({"minroot": {"segments": 7}}) == 7


def test_a_new_driver_and_its_control_from_files_alone(tmp_path, monkeypatch):
    """A new traffic kind is one new driver file: its cell finds it, and so
    does the control, with no edit to control.py."""
    from perfbench import control, drivers

    ddir, wdir = tmp_path / "drivers", tmp_path / "workloads"
    ddir.mkdir()
    wdir.mkdir()
    (ddir / "pb_echo.py").write_text(
        "import contextlib\n\n\n@contextlib.contextmanager\ndef control():\n    yield 'echo'\n")
    (wdir / "minroot.echo.json").write_text(json.dumps(
        {"config": "minroot_fq", "traffic": "echo", "driver": "pb_echo", "params": {}}))
    pkg = spec.PKG
    monkeypatch.setattr(drivers, "__path__", [*drivers.__path__, str(ddir)])
    monkeypatch.setattr(spec, "PKG", tmp_path)
    with control.control_for("minroot.echo")() as got:
        assert got == "echo"
    # every existing traffic kind has one
    monkeypatch.setattr(spec, "PKG", pkg)
    for cell in CELLS:
        assert callable(control.control_for(cell))


def test_malformed_names_are_refused():
    for bad in ("../x", "a b", "a/b", "", "x" * 65):
        with pytest.raises(spec.SpecError):
            spec.workload(bad)

