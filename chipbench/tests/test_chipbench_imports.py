"""Import guard of the benchmark harness: nothing under ``chipbench/``
imports JAX or the JAX package ``repro``, and the yardstick (the
reference, the generator, the peaks, the operation counts, the trace
reader and the metric readers) imports nothing of the program
``repro_torch``.  Top-level module names are compared whole:
``repro_torch`` starts with ``repro`` and is the program."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: files that drive the program; every other file is the yardstick
PROGRAM_USERS = {"run.py", "calibrate.py", "kinds/gnn_train.py",
           "tests/test_chipbench_harness.py",
           "tests/test_chipbench_faults.py"}
SOURCES = sorted(p.relative_to(BENCH).as_posix()
                 for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_every_source_is_scanned():
    assert "reference.py" in SOURCES and "run.py" in SOURCES
    assert PROGRAM_USERS <= set(SOURCES)


@pytest.mark.parametrize("rel", SOURCES)
def test_no_jax_and_no_jax_package(rel):
    assert not imported_tops(BENCH / rel) & FORBIDDEN


@pytest.mark.parametrize("rel", [s for s in SOURCES if s not in PROGRAM_USERS])
def test_yardstick_imports_nothing_of_the_program(rel):
    assert "repro_torch" not in imported_tops(BENCH / rel)


def test_the_guard_sees_an_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy\nfrom repro.core import x\n"
                     "import repro_torch\nimportlib.import_module('flax')\n")
    assert imported_tops(probe) & FORBIDDEN == {"jax", "repro", "flax"}
