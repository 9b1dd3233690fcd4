"""What the benchmark may import: nothing of JAX or the JAX package
anywhere under perfbench/, and nothing of the program in the reference.
Top-level module names are compared whole: ``vdf_tpu_torch`` is not
``vdf_tpu``."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "vdf_tpu"}
SOURCES = sorted(p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_scan_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import vdf_tpu_torch.nova\nfrom jax.numpy import ones\nfrom . import x\n")
    assert top_level_imports(f) == {"vdf_tpu_torch", "jax"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", [p for p in SOURCES if "reference" in p.parts],
                         ids=lambda p: str(p.relative_to(PKG)))
def test_reference_takes_nothing_of_the_program(path):
    assert not top_level_imports(path) & (JAX | {"vdf_tpu_torch", "torch"})


def test_reference_loads_nothing_of_the_program():
    """Importing every reference module and deriving a small key loads no
    module of the program, torch or JAX."""
    code = ("import sys, pkgutil, importlib, perfbench.reference as r\n"
            "for m in pkgutil.walk_packages(r.__path__, 'perfbench.reference.'):\n"
            "    importlib.import_module(m.name)\n"
            "from perfbench.reference import ivc\n"
            "ivc.generators('pallas', 4)\n"
            "bad = {n.split('.')[0] for n in sys.modules} & "
            "{'torch', 'jax', 'jaxlib', 'flax', 'vdf_tpu', 'vdf_tpu_torch'}\n"
            "print(sorted(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
