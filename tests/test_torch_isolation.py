"""The PyTorch port stands alone: no file of ``src/repro_torch``, not
``chip_smoke.py``, ``kernel_ab.py``, ``prefix_probe.py`` nor an
``examples/torch_*.py`` imports JAX or the JAX package, and its entry
points never land on the CPU unless asked to."""
import ast
import pathlib

import pytest
import torch

from repro_torch import configs as TC
from repro_torch.core import solver as TS
from repro_torch.launch import dryrun as TDR
from repro_torch.launch import mesh as TM
from repro_torch.launch import serve as TSV
from repro_torch.launch import train as TTR
from repro_torch.models import lm as TLM
from repro_torch.serving import FCMServeEngine
from repro_torch.training import checkpoint as TCK  # noqa: F401
from repro_torch.training import train_loop as TT

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "examples").glob("torch_*.py"))
              + [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py",
                 ROOT / "prefix_probe.py"])


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
    assert {"fcm_engine.py", "solver.py", "ops.py", "chip_smoke.py",
            "ssm.py", "train_loop.py", "selective_scan.py", "distributed.py",
            "batched.py", "ref.py", "serve.py", "checkpoint.py",
            "engine.py", "deepseek_v2_236b.py", "rwkv6_1b6.py",
            "whisper_tiny.py", "llama32_vision_90b.py", "pipeline.py",
            "grad_compress.py", "sharding.py", "elastic.py",
            "train.py", "hw.py", "roofline.py", "op_cost.py", "mesh.py",
            "dryrun.py", "kernel_ab.py", "prefix_probe.py",
            "torch_quickstart.py",
            "torch_segment_noisy.py", "torch_segment_volume.py",
            "torch_segment_color.py", "torch_serve_segmentation.py"} <= names
    assert not _forbidden("repro_torch.core")
    assert _forbidden("repro.core.solver") and _forbidden("jax.numpy")


@pytest.mark.parametrize("make", [
    lambda: FCMServeEngine(),
    lambda: TS.histogram_problem(torch.zeros(16)),
    lambda: TS.FCMProblem(features=torch.zeros(8)),
    lambda: TLM.init_params(0, TC.get_config("jamba-v0.1-52b").reduced()),
    lambda: TT.init_state(0, TC.get_config("jamba-v0.1-52b").reduced()),
    lambda: TLM.init_cache(TC.get_config("llama3.2-1b").reduced(), 1, 8),
    lambda: TSV.main(["--arch", "llama3.2-1b", "--reduced"]),
    lambda: TTR.main(["--arch", "llama3.2-1b", "--reduced", "--steps", "1"]),
    lambda: TTR.build(TC.get_config("llama3.2-1b").reduced(),
                      TT.TrainConfig()),
    lambda: TM.make_production_mesh(),
    lambda: TDR.run_cell("fcm-brainweb", TDR.FCM_SHAPE, False),
], ids=["engine", "histogram_problem", "FCMProblem", "lm.init_params",
        "train_loop.init_state", "lm.init_cache", "launch.serve.main",
        "launch.train.main", "launch.train.build",
        "launch.mesh.make_production_mesh", "launch.dryrun.run_cell"])
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
