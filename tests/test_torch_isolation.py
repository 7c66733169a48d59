"""The PyTorch port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and its entry points
never land on the CPU unless asked to."""
import ast
import pathlib

import pytest
import torch

from repro_torch.core import solver as TS
from repro_torch.serving import FCMServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_port():
    names = {p.name for p in PORT_FILES}
    assert {"fcm_engine.py", "solver.py", "ops.py", "chip_smoke.py"} <= names
    assert not _forbidden("repro_torch.core")
    assert _forbidden("repro.core.solver") and _forbidden("jax.numpy")


@pytest.mark.parametrize("make", [
    lambda: FCMServeEngine(),
    lambda: TS.histogram_problem(torch.zeros(16)),
    lambda: TS.FCMProblem(features=torch.zeros(8)),
], ids=["engine", "histogram_problem", "FCMProblem"])
def test_entry_points_raise_without_a_card(monkeypatch, make):
    """Asked for no device on a machine without CUDA, an entry point
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_explicit_cpu_device_runs():
    eng = FCMServeEngine(device="cpu")
    assert eng.device.type == "cpu"
    p = TS.histogram_problem(torch.zeros(16), device="cpu")
    assert p.features.device.type == "cpu"
