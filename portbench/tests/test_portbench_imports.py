"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import bench

HERE = Path(bench.__file__).resolve().parent


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert not names & {"tinypathtracer_tpu_torch", "tinypathtracer_tpu",
                        "jax", "jaxlib"}, names
    assert names <= {"__future__", "dataclasses", "numpy", "torch"}, names


def test_no_source_imports_jax():
    for path in HERE.rglob("*.py"):
        assert not imported(path) & {"jax", "jaxlib", "flax",
                                     "tinypathtracer_tpu"}, path


def test_rehearsal_loads_no_jax():
    code = (
        "import json, sys\n"
        "from portbench.tests import _tiny\n"
        "from portbench import bench\n"
        "out = _tiny.execute()\n"
        "_tiny.execute(trace=1)\n"
        "print(json.dumps([out['correct'], bench.forbidden_modules(),\n"
        "                  'tinypathtracer_tpu_torch' in sys.modules]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=bench.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    correct, found, port = json.loads(res.stdout.strip().splitlines()[-1])
    assert correct and port and found == []


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    monkeypatch.setitem(sys.modules, "tinypathtracer_tpu_torch.x", sys)
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert bench.forbidden_modules() == ["jax.numpy"]


def test_no_card_no_result(tmp_path):
    """Where torch sees no card the command exits non-zero and prints no
    result line."""
    res = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "cornell-frame",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=bench.ROOT,
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "needs 1 CUDA card" in res.stderr
