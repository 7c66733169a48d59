"""A configuration, a traffic mix and a per-layer metric added as files
and entries only are found by name."""
import json
import shutil
import time

import torch

from harness import drive, spec
from conftest import BENCH, TINY


def test_dummy_cell_is_found_by_name(tmp_path):
    bench = tmp_path / "bench"
    for d in ("configs", "traffic", "limits", "layer_metrics", "counts"):
        (bench / d).mkdir(parents=True)
    cfg = json.loads((BENCH / "configs" / "brainweb-fcm.json").read_text())
    cfg.update(name="dummy-cfg", volume=dict(cfg["volume"], **TINY))
    (bench / "configs" / "dummy-cfg.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "dummy-mix.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "payload": "slices",
         "head_scales": [1.0], "realisations": 1, "depths": [4],
         "warmup": 1, "label_sample": 1}))
    for cell in ("dummy-cell", "other"):
        shutil.copy(BENCH / "limits" / "hist-volume.json",
                    bench / "limits" / f"{cell}.json")
    (bench / "layer_metrics" / "dummy.metric-1.py").write_text(
        "def read(ctx):\n    return 40.0 + ctx.requests / ctx.requests + 1\n")
    (bench / "layer_metrics" / "silent.py").write_text(
        "def read(ctx):\n    return None\n")
    spec_doc = {
        "configs": [{"name": "dummy-cfg", "file": "bench/configs/dummy-cfg.json"}],
        "workloads": [{"name": "dummy-cell", "config": "dummy-cfg",
                       "traffic": "dummy-mix", "chips": 1},
                      {"name": "other", "config": "dummy-cfg",
                       "traffic": "dummy-mix", "chips": 1}],
        "end_to_end": [{"name": "setup_s", "unit": "s"},
                       {"name": "voxels_per_s", "unit": "Mvox/s",
                        "workloads": ["other"]}],
        "per_layer": [{"name": "dummy.metric-1", "unit": "x",
                       "moves": "setup_s", "workloads": ["dummy-cell"]},
                      {"name": "silent", "unit": "x", "moves": "setup_s"},
                      {"name": "elsewhere", "unit": "x",
                       "moves": "voxels_per_s"}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec_doc))

    cell = spec.load_cell("dummy-cell", root=tmp_path, bench=bench)
    assert cell.config["name"] == "dummy-cfg"
    assert cell.traffic["depths"] == [4]
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["dummy.metric-1",
                                                   "silent"]
    out, values = drive.run(cell, 9, 0.1, True, torch.device("cpu"),
                            time.perf_counter())
    assert out["metrics"] == {"dummy.metric-1": {"value": 42.0,
                                                 "unit": "x"}}
    out, _ = drive.run(cell, 9, 0.1, False, torch.device("cpu"),
                       time.perf_counter())
    assert set(out["metrics"]) == {"setup_s"}
    other = spec.load_cell("other", root=tmp_path, bench=bench)
    assert [m["name"] for m in other.per_layer] == ["silent", "elsewhere"]
