"""The benchmark's files, found by name.

``BENCHMARK.json`` (the root of the checkout) lists the cells and the
metrics; everything that belongs to one configuration, cell, traffic kind
or per-layer metric sits in a file of its own under ``perfbench/``:

    configs/<config>.json      one configuration (a deployment)
    workloads/<cell>.json      one cell: its configuration, driver, traffic
    drivers/<driver>.py        one traffic kind: set-up, warm-up, window, outputs, check
    metrics/<metric>.py        one per-layer metric's reader: read(obs) -> number | None

A later change adds a configuration, a cell or a metric as new files and
entries; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import re

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent
BENCHMARK = ROOT / "BENCHMARK.json"
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class SpecError(ValueError):
    """A benchmark file is missing or malformed."""


def _json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise SpecError(f"{path} does not exist")
    with open(path) as fh:
        return json.load(fh)


def _checked(name: str, what: str) -> str:
    if not NAME_RE.match(name):
        raise SpecError(f"{what} name {name!r} is not a valid name")
    return name


def benchmark() -> dict:
    return _json(BENCHMARK)


def workload(name: str) -> dict:
    return _json(PKG / "workloads" / f"{_checked(name, 'workload')}.json")


def config(name: str) -> dict:
    return _json(PKG / "configs" / f"{_checked(name, 'config')}.json")


def _module(path: pathlib.Path, modname: str):
    if not path.is_file():
        raise SpecError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    """drivers/<name>.py as a module (set-up, warm-up, window, outputs, check)."""
    if not (PKG / "drivers" / f"{_checked(name, 'driver')}.py").is_file():
        raise SpecError(f"perfbench/drivers/{name}.py does not exist")
    return importlib.import_module(f"perfbench.drivers.{name}")


def metric_reader(name: str):
    """metrics/<name>.py's ``read``."""
    mod = _module(PKG / "metrics" / f"{_checked(name, 'metric')}.py",
                  "perfbench.metrics." + name.replace(".", "_"))
    return mod.read


def cell_metrics(bench: dict, cell: dict, kind: str) -> list[dict]:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) a cell reports:
    those that list it under ``workloads``; a metric without the key is in
    every cell that reports the end-to-end metric it moves (an end-to-end
    metric without it, in every cell)."""
    name = cell["name"]
    e2e = {m["name"] for m in cell_metrics(bench, cell, "end_to_end")} if kind == "per_layer" \
        else None
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SpecError(f"no cell {name!r} in BENCHMARK.json")
