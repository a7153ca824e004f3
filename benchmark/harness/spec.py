"""What a run reads: BENCHMARK.json and the files it names by name.

A cell `<cell>` is `workloads/<cell>.json` ({"config": ..., "driver": ...,
"params": {...}}), its configuration `configs/<config>.json`, its driver
`drivers/<driver>.py` and each metric `metrics/<metric>.py`, all under the
benchmark's folder. A new cell, configuration, traffic mix or metric is a
new file and an entry in BENCHMARK.json; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import List, Optional

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    end_to_end: bool
    workloads: Optional[List[str]]

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    workload: dict  # the cell's traffic file
    config: dict  # its configuration file
    metrics: List[Metric]  # the metrics it reports, end to end first
    bench: Path = BENCH  # the benchmark's folder its files come from


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file of the benchmark's, by path (metric files have
    dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def cell(name: str, root: Path = ROOT, bench: Path = BENCH) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    workload = load_json(bench / "workloads" / f"{name}.json")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = load_json(root / cfg_entry["file"])
    metrics = [Metric(m["name"], m["unit"], True, m.get("workloads")) for m in spec["end_to_end"]]
    metrics += [Metric(m["name"], m["unit"], False, m.get("workloads")) for m in spec["per_layer"]]
    return Cell(name, entry["chips"], workload, config, [m for m in metrics if m.applies(name)], bench)


def reader(metric: str, bench: Path = BENCH):
    """The `read(run)` function of metrics/<metric>.py."""
    return load_module(bench / "metrics" / f"{metric}.py", f"benchmark_metric_{metric}").read


def driver(name: str, bench: Path = BENCH):
    return load_module(bench / "drivers" / f"{name}.py", f"benchmark_driver_{name}")
