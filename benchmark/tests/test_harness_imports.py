"""Nothing the benchmark loads is JAX, Flax or the JAX package (top-level
names compared whole), and the reference loads nothing of the program."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

from benchmark import harness
from benchmark.tests.tiny import ROOT

BENCH = ROOT / "benchmark"


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    # the benchmark's own sources: not its caches and scratch (dot folders)
    for path in BENCH.rglob("*.py"):
        if not any(part.startswith(".") for part in path.relative_to(BENCH).parts):
            assert not _imports(path) & set(harness.FORBIDDEN), path


def test_reference_and_counts_import_nothing_of_the_program():
    for sub in ("reference", "counts", "generators"):
        for path in (BENCH / sub).rglob("*.py"):
            assert "tod_tpu_torch" not in _imports(path), path


def test_the_check_of_loaded_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tod_tpu_torch_like", sys)
    assert "tod_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tod_tpu.x", sys)
    assert "tod_tpu" in harness.forbidden_modules()


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.tests.tiny import tiny_copy, run_tiny\n"
        "import pathlib\n"
        f"root = tiny_copy(pathlib.Path({str(tmp_path)!r}))\n"
        "import benchmark.reference.model, benchmark.reference.train\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'tod_tpu_torch']\n"
        "run_tiny(root, 'tiny.train', seconds=1.0)\n"
        "from benchmark import harness\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"OMP_NUM_THREADS": "1", "PATH": "/usr/bin:/bin",
                                           "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_refuses_a_machine_without_a_card():
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "mnv2_train.b16",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
