"""Nothing under bench/ imports JAX or the JAX package, nothing touches
the JAX package's benchmarks/ folder, and the yardstick imports nothing
of the program."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: the yardstick: what the program may never move
YARDSTICK = ["harness/reference.py", "harness/check.py",
             "harness/control.py", "harness/phantom.py",
             "harness/traffic.py", "harness/peaks.py", "harness/trace.py",
             "harness/spec.py"]


def _sources():
    return sorted(Path(BENCH).rglob("*.py"))


def _imports(path):
    """Top-level names of every module a file imports."""
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_top_level_names_are_compared_whole():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.core".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not (_imports(path) & FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in _sources()
                                  if p != Path(__file__).resolve()],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_names_the_jax_benchmarks_folder(path):
    # this file names the folder to look for it, and is left out
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            v = node.value
            assert "benchmarks/" not in v and v != "benchmarks"


@pytest.mark.parametrize("rel", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(rel):
    assert "repro_torch" not in _imports(Path(BENCH) / rel)


def test_a_run_leaves_no_jax_in_the_process(tmp_path):
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{str(Path(ROOT) / 'src')!r}, {str(BENCH)!r}]\n"
        "from harness import drive, spec\n"
        "from conftest import tiny\n"
        f"sys.path.insert(0, {str(Path(BENCH) / 'tests')!r})\n"
        "import run\n"
        "cell = tiny(spec.load_cell('hist-volume'))\n"
        "drive.run(cell, 1, 0.1, False, torch.device('cpu'), "
        "time.perf_counter())\n"
        "print(run.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       cwd=str(Path(BENCH) / "tests"))
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"
