"""The benchmark's CPU tests: ``python -m pytest bench/tests``.

They import the harness as ``harness`` (bench/ on the path) and the
program from src/, and run cells at a tiny size on the CPU; a test that
needs the card is marked ``cuda`` and skips here."""
import copy
import sys
from pathlib import Path

import pytest
import torch

# two threads a test process: under pytest-xdist every worker's full pool
# of threads would share the cores, and the tests slow by orders
torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the geometry the CPU tests shrink every cell to
TINY = {"depth": 6, "height": 40, "width": 36}

def tiny(cell):
    """``cell`` at TINY's geometry, its bank, depths and sample kept
    small."""
    cell.config = copy.deepcopy(cell.config)
    cell.config["volume"].update(TINY)
    cell.traffic = dict(cell.traffic, head_scales=[0.9, 1.0],
                        realisations=2, depths=[6, 5, 3], warmup=3,
                        label_sample=2)
    return cell


@pytest.fixture
def tiny_cell():
    from harness import spec

    def make(name):
        return tiny(spec.load_cell(name))
    return make
