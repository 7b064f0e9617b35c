"""What the harness and the references import (CPU).

The harness and everything it runs import no module whose top-level name
is ``jax``, ``jaxlib``, ``flax`` or ``spicey_tpu`` (the top-level name
compared whole: ``spicey_tpu_torch`` is the program). The references
import nothing of the program or of the harness's own core."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "spicey_tpu"}


def imported_tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py")
                 if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(p for p in BENCH_DIR.rglob("*.py")
                                        if p.parent.name == "reference"),
                         ids=lambda p: p.name)
def test_references_import_only_numpy_torch_and_the_standard_library(path):
    tops = imported_tops(path)
    assert tops <= {"__future__", "importlib", "math", "re", "sys",
                    "dataclasses", "pathlib", "numpy", "torch"}, tops


def test_a_run_loads_no_forbidden_module_and_the_references_no_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.core import manifest\n"
        "for c in manifest.benchmark()['configs']:\n"
        "    manifest.module('reference', c['name'])\n"
        "assert not any(m.split('.')[0] == 'spicey_tpu_torch'"
        " for m in sys.modules), 'a reference loaded the program'\n"
        "from portbench import run\n"
        "rc = run.main(['--workload', 'boost-yield-f32-fused', '--seed',"
        " '4000000001', '--seconds', '0.01', '--trace', '0'],"
        " device='cpu', variants=16)\n"
        "assert rc == 0, rc\n"
        "bad = {m.split('.')[0] for m in sys.modules} & %r\n"
        "assert not bad, bad\n" % (str(ROOT), FORBIDDEN))
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]


def test_the_harness_alone_refuses_to_run(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/ (no
    program), a run exits nonzero and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "boost-yield-f32-fused", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert done.returncode != 0
    assert "{" not in done.stdout
