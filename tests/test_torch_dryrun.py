"""The port's dry-run planner (``repro_torch.launch.dryrun``, its
production meshes and its op counter) against the JAX package's on the
CPU. The JAX side runs once, in a subprocess under 4 fake devices
(``tests/_torch_dryrun_runner.py``): the dry-run's cell list, its
``memory_analysis()`` argument bytes for reduced llama3.2-1b train and
decode on a (2, 2) mesh, the HLO walker's dot flops of a one-device
train step, and its wire for the sharded FCM fits."""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs as TC
from repro_torch.analysis import op_cost, roofline
from repro_torch.core import distributed as TD
from repro_torch.core.fcm import FCMConfig
from repro_torch.launch import dryrun as TDR
from repro_torch.launch import mesh as TM
from repro_torch.models import sharding as sh

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")
# the runner's shapes
TRAIN = TC.ShapeConfig("t", "train", 64, 8)
DECODE = TC.ShapeConfig("d", "decode", 96, 4)
DENSE = TC.ShapeConfig("dense", "train", 1024, 2)
N_PIXELS = 4096


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "jax.json"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_dryrun_runner.py"),
         str(out)], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out) as f:
        return json.load(f)


def _cpu_mesh(shape, axes):
    return TD.make_mesh(shape, axes, devices=["cpu"] * (
        shape[0] * shape[1]))


def test_cells_equal_the_jax_dry_runs(jax_side):
    got = [[a, s.name] for a, s in TDR.cells("all", "all")]
    assert got == jax_side["cells"]
    assert ["fcm-brainweb", "fcm_1g"] in got


@pytest.mark.parametrize("shape", [TRAIN, DECODE], ids=["train", "decode"])
def test_argument_bytes_within_one_percent_of_jax(jax_side, shape):
    cfg = TC.get_config("llama3.2-1b").reduced()
    ctx = sh.make_parallelism(_cpu_mesh((2, 2), ("data", "model")))
    with FakeTensorMode(), sh.parallelism(ctx):
        _, args, _ = TDR.cost_lm(cfg, shape, ctx, CPU)
    want = jax_side["args"][shape.kind]
    assert args == pytest.approx(want, rel=0.01)


def test_dense_dot_flops_within_two_percent_of_the_walker(jax_side):
    cfg = TC.get_config("llama3.2-1b").reduced()
    with FakeTensorMode():
        counter, _, _ = TDR.cost_lm(cfg, DENSE, sh.Parallelism(), CPU)
    assert counter.costs.dot_flops == pytest.approx(
        jax_side["dense"]["dot_flops"], rel=0.02)
    assert counter.costs.flops == pytest.approx(
        jax_side["dense"]["flops"], rel=0.02)


def _fit_wire(histogram):
    mesh = _cpu_mesh((2, 2), ("data", "model"))
    x = torch.arange(N_PIXELS, dtype=torch.float32) % 251
    w = torch.ones(N_PIXELS)
    fit = (TD.build_sharded_histogram_fit(mesh, FCMConfig()) if histogram
           else TD.build_sharded_fit(mesh, FCMConfig(),
                                     loop=TD.one_iteration))
    _, c = op_cost.count(fit, x, w)
    return c.costs


def test_histogram_fit_wire_equals_the_walkers(jax_side):
    """One 256-float all-reduce: the walker's per-participant wire times
    the 4 participants."""
    costs = _fit_wire(histogram=True)
    assert costs.wire == jax_side["wire"]["histogram"] * 4
    assert costs.wire == 4 * roofline.collective_wire("all-reduce", 1024, 4)
    assert costs.n_coll_ops == jax_side["wire"]["histogram_ops"] == 1


def test_pixel_fit_wire_at_one_iteration_equals_the_walkers(jax_side):
    """The range's pmin / pmax and one iteration's psums of 2c floats."""
    costs = _fit_wire(histogram=False)
    assert costs.wire == jax_side["wire"]["pixel"] * 4


def test_one_iteration_is_one_step_of_the_fit():
    mesh = _cpu_mesh((2, 1), ("data", "model"))
    x = (torch.arange(1000, dtype=torch.float32) * 7) % 255
    xp, w = TD.pad_to_devices(x, mesh.size, device="cpu")
    v, labels, delta, it = TD.build_sharded_fit(
        mesh, FCMConfig(), loop=TD.one_iteration)(xp, w)
    full = TD.build_sharded_fit(mesh, FCMConfig(max_iters=1))(xp, w)
    assert it == full[3] == 1
    assert torch.equal(v, full[0]) and torch.equal(labels, full[1])


def test_production_meshes():
    single = TM.make_production_mesh(device="cpu")
    assert single.shape == (16, 16) and single.axis_names == ("data",
                                                              "model")
    multi = TM.make_production_mesh(multi_pod=True, device="cpu")
    assert multi.shape == (2, 16, 16)
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.size == 512 and set(multi.devices) == {CPU}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TM.make_production_mesh()


def test_fcm_cell_on_a_production_mesh():
    rec = TDR.run_cell("fcm-brainweb", TDR.FCM_SHAPE, False, device="cpu",
                       verbose=False)
    assert rec["n_devices"] == 256 and rec["shape"] == "fcm_1g"
    assert rec["mem_args_gb"] == pytest.approx(2 * 2 ** 30 * 4 / 256
                                               / 2 ** 30)
    # pmin, pmax and the psums of num and den over 256 participants
    per = (2 * roofline.collective_wire("all-reduce", 4, 256)
           + 2 * roofline.collective_wire("all-reduce", 16, 256))
    assert rec["wire_bytes"] == pytest.approx(256 * per)
    assert rec["flops_per_dev"] > 0 and rec["fits_hbm"]


def test_cli_on_a_reduced_config(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    argv = ["--arch", "llama3.2-1b,jamba-v0.1-52b",
            "--shape", "train_4k,decode_32k,long_500k", "--mesh", "both",
            "--device", "cpu", "--reduced", "--out", str(out)]
    assert TDR.main(argv) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert {(r["arch"], r["shape"], r["mesh"]) for r in rows} == {
        (a, s, m) for a, s in (("llama3.2-1b", "train_4k"),
                               ("llama3.2-1b", "decode_32k"),
                               ("jamba-v0.1-52b", "train_4k"),
                               ("jamba-v0.1-52b", "decode_32k"),
                               ("jamba-v0.1-52b", "long_500k"))
        for m in ("16x16", "2x16x16")}
    from repro.analysis.roofline import RooflineReport
    keys = set(RooflineReport.__dataclass_fields__) | {
        "lower_s", "compile_s", "hlo_bytes"}
    for r in rows:
        assert keys <= set(r), keys - set(r)
        assert r["scope"] == TDR.SCOPE and r["device"] == "cpu"
        assert r["bottleneck"] in ("compute", "memory", "collective")
        assert r["flops_per_dev"] > 0 and r["mem_args_gb"] > 0
    jamba = [r for r in rows if r["arch"] == "jamba-v0.1-52b"
             and r["shape"] == "train_4k"]
    assert all(r["wire_bytes"] > 0 for r in jamba)      # expert dispatch
    # a second run skips what the file holds
    capsys.readouterr()
    assert TDR.main(argv) == 0
    assert capsys.readouterr().out.count("[skip]") == len(rows)
    assert TDR.main(argv[:-2] + ["--list"]) == 0
