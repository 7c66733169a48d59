"""Every cell through the command on the card, short: the result line is
well formed and ``correct`` is true. Skips without a card."""
import json
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["hist-volume", "fcms-slices"])
def test_cell_runs_correct_on_the_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        name, "--seed", "2147483777", "--seconds", "2",
                        "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=1500)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0
