"""Finds a cell's pieces by name.

``BENCHMARK.json`` names every cell, configuration and metric. Each
piece that belongs to one of them is a file of its own under ``bench/``,
found here from its name alone, so a later cell, configuration, traffic
mix or per-layer metric is added as files and entries, never by editing
shared code:

* ``configs/<config>.json``: the deployment (engine settings, geometry,
  noise, precision, its source and cuts);
* ``traffic/<mix>.json``: the parameters the one generator reads;
* ``limits/<cell>.json``: the limit of each number the check compares;
* ``layer_metrics/<metric>.py``: a reader with ``read(ctx)``;
* ``counts/<kernel>.py``: a kernel's operation and byte counts.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

#: bench/, the root of the benchmark's own files
BENCH = Path(__file__).resolve().parent.parent
#: the checkout's root, where BENCHMARK.json lies
ROOT = BENCH.parent


def _read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """Import one file of the benchmark by its path (a metric's or a
    kernel's name may hold characters a module name may not)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + name.replace("-", "_").replace(".", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, resolved."""
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    bench: Path

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.bench / "layer_metrics" / f"{metric}.py",
                           metric)


def _applies(metric: Dict[str, Any], cell: str,
             reported: Optional[set] = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # without the key a per-layer metric goes wherever the end-to-end
    # metric it moves is reported
    return reported is None or metric.get("moves") in reported


def load_cell(name: str, root: Path = ROOT, bench: Path = BENCH) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its
    configuration, traffic and limits read from their files under
    ``bench``. Raises ``KeyError`` for an unknown cell."""
    spec = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = _read_json(root / cfg_entry["file"])
    traffic = _read_json(bench / "traffic" / f"{w['traffic']}.json")
    limits = _read_json(bench / "limits" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer, bench=bench)


def counts(kernel: str, bench: Path = BENCH) -> ModuleType:
    """The count functions of one kernel (``counts/<kernel>.py``)."""
    return load_module(bench / "counts" / f"{kernel}.py", kernel)
