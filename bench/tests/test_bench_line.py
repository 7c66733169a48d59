"""A run's last line is the benchmark's result object, and the command
refuses to run without a card."""
import json
import math
import os
import subprocess
import sys
import time

import pytest
import torch

from harness import drive
from conftest import BENCH, ROOT

#: each cell's end-to-end metrics: the rate stands end to end where its
#: runs are steady, and per layer in hist-volume
E2E = {"hist-volume": {"request_p95_ms": "ms", "setup_s": "s"},
       "fcms-slices": {"voxels_per_s": "Mvox/s", "request_p95_ms": "ms",
                       "setup_s": "s"}}


def _line(cell, trace, seed=2**31 + 5):
    out, values = drive.run(cell, seed, 0.2, trace, torch.device("cpu"),
                            time.perf_counter())
    return json.loads(json.dumps(drive.finish(out, values, cell.limits),
                                 allow_nan=False))


@pytest.mark.parametrize("name", ["hist-volume", "fcms-slices"])
def test_untraced_line_holds_the_end_to_end_metrics(tiny_cell, name):
    line = _line(tiny_cell(name), False)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert {k: v["unit"] for k, v in line["metrics"].items()} == E2E[name]
    assert all(v["value"] > 0 and math.isfinite(v["value"])
               for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == {"missing", "center_gap", "iters_share",
                                   "stop_gap", "label_gap"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_traced_line_holds_per_layer_metrics_and_breakdown(tiny_cell):
    line = _line(tiny_cell("fcms-slices"), True)
    # the CPU has no device trace: the readers of device metrics find
    # nothing and their metrics are left out, never 0
    assert set(line["metrics"]) == {"ingest_ms", "gather_ms", "launch_ms",
                                    "scatter_ms", "iters_per_lane"}
    assert line["metrics"]["iters_per_lane"]["unit"] == "iters"
    assert set(line["device"]) >= {"busy_s", "window_s"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    assert list(line)[-1] == "checks"


def test_traced_hist_line_holds_the_rate_per_layer(tiny_cell):
    line = _line(tiny_cell("hist-volume"), True)
    assert set(line["metrics"]) == {"voxels_per_s.hist", "ingest_ms",
                                    "gather_ms", "launch_ms", "scatter_ms",
                                    "iters_per_lane"}
    rate = line["metrics"]["voxels_per_s.hist"]
    assert rate["unit"] == "Mvox/s"
    assert rate["value"] > 0 and math.isfinite(rate["value"])
    assert line["correct"] is True


def test_command_without_a_card_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "hist-volume", "--seed", "3",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
