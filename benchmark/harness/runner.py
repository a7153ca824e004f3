"""One run of one cell: set-up, the measured window, the metrics, the check.

A driver (drivers/<name>.py) is a class `Driver(cell, seed, device)` with
  * `spans`: the prefixes of the span names it opens around its calls;
  * `setup()`: build the program, make weights and inputs from the seed,
    warm up every shape the cell's traffic will use;
  * `step()`: one unit of work (a request, a batch, a micro-step), run to
    completion on the host; returns its record (`start` and `end` on
    `time.perf_counter()`, and what the metrics read);
  * `release()`: drop the program's state;
  * `check(records)`: compare what the timed path produced with the plain
    reference; returns [{"name", "value", "limit"}].
The window is a closed loop: units start until `seconds` have elapsed, the
last one runs to completion, and the window ends with it.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import subprocess
import time
from typing import List, Optional

import torch

from benchmark.harness import spec
from benchmark.harness.trace import TraceData, Tracer


@dataclasses.dataclass
class Run:
    """What a metric's `read(run)` sees."""

    cell: spec.Cell
    records: List[dict]  # one per unit of work in the window
    window_s: float  # the window, host clock
    setup_s: float
    trace: Optional[TraceData]  # the traced slice (--trace 1)
    power_limit_w: Optional[float]

    @property
    def traced(self) -> List[dict]:
        """The records of the units that ran inside the traced slice."""
        return [r for r in self.records if r.get("traced")]

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def params(self) -> dict:
        return self.cell.workload["params"]

    @property
    def audio_config(self) -> dict:
        """The codec's and vocoder's configuration: the cell's own, or the
        one its traffic renders through (params "render": a name or the
        configuration itself)."""
        if "vocoder" in self.config:
            return self.config
        render = self.params["render"]
        return render if isinstance(render, dict) else spec.load_json(self.cell.bench / "configs" / f"{render}.json")

    @property
    def idle_percent(self) -> Optional[float]:
        """The share of the traced slice in which no operation (kernel,
        memcpy, memset) ran on the device."""
        if self.trace is None or self.trace.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s() / self.trace.window_s)

    @property
    def itemsize(self) -> int:
        """Bytes per element of the dtype the cell serves in (its traffic's
        "dtype", else its configuration's)."""
        return {"float32": 4, "bfloat16": 2}[self.params.get("dtype", self.config["dtype"])]


def power_limit_w() -> Optional[float]:
    """The card's power limit (nvidia-smi), or None where it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def window(drv, seconds: float, tracer: Optional[Tracer], trace_units: Optional[int],
           trace_after: int = 0) -> List[dict]:
    """The closed loop; with a tracer, `trace_units` units (all where None)
    run traced, after the first `trace_after` (the window then lasts until
    one has). The driver sees the tracer as `drv.tracer`."""
    records: List[dict] = []
    drv.tracer = tracer
    start = time.perf_counter()
    while time.perf_counter() - start < seconds or (tracer is not None and len(records) <= trace_after):
        i = len(records)
        traced = tracer is not None and i >= trace_after and (not trace_units or i < trace_after + trace_units)
        if traced and i == trace_after:
            tracer.start()
        rec = drv.step()
        if traced:
            rec["traced"] = True
            if trace_units and i + 1 == trace_after + trace_units:
                tracer.stop()
        records.append(rec)
    if tracer is not None:
        tracer.stop()
    drv.tracer = None
    for rec in records:
        rec["t0"] = start
    return records


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device, t0: float) -> dict:
    """Set-up, window, metrics, check; returns the pieces of the result line."""
    drv = spec.driver(cell.workload["driver"], cell.bench).Driver(cell, seed, device)
    cuda = device.type == "cuda"
    drv.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    tracer = Tracer(tuple(drv.spans), cuda) if trace else None
    records = window(drv, seconds, tracer, cell.workload.get("trace_units"), cell.workload.get("trace_after", 0))
    window_s = records[-1]["end"] - records[-1]["t0"]
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = Run(cell, records, window_s, setup_s, tracer.data if tracer else None, power_limit_w() if cuda else None)
    metrics = {}
    for m in cell.metrics:
        if m.end_to_end == trace:
            continue
        value = spec.reader(m.name, cell.bench)(run)
        if value is not None:
            if not math.isfinite(value):
                raise RuntimeError(f"metric {m.name} read {value}")
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    drv.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = drv.check(records)
    return {"run": run, "metrics": metrics, "memory_peak": memory_peak, "checks": checks}


def correct(checks: List[dict]) -> bool:
    return bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks)

