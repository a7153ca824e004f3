"""Each driver end to end on the CPU at a tiny size: set-up, a one-second
window, the metrics, the check against the plain reference, and a
contract-shaped result line; and a cell added as files alone."""

import json
import shutil
import time

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import runner, spec
from benchmark.tests.conftest import tiny_cell, tiny_codec_config

CELLS = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]
SEED = 2**31 + 1234567  # the driver's seeds are large


def contract_shaped(result: dict, cell: spec.Cell, trace: bool) -> None:
    assert list(result)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in result
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    declared = {m.name: m.unit for m in cell.metrics if m.end_to_end != trace}
    for name, m in result["metrics"].items():
        assert declared[name] == m["unit"] and isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == set(declared)
    json.loads(json.dumps(result))


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_cpu(name, trace):
    cell = tiny_cell(name)
    out = runner.run_cell(cell, SEED, 1.0, trace, torch.device("cpu"), time.perf_counter())
    result = bench_run.result_line(cell, out, "cpu")
    contract_shaped(result, cell, trace)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(cell.workload["params"]["limits"])


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A new configuration, traffic mix and per-layer metric as new files and
    BENCHMARK.json entries: the harness runs the new cell unchanged."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = root / "benchmark"
    (bench / "configs" / "dmel-tiny.json").write_text(json.dumps(tiny_codec_config()))
    wl = tiny_cell("codec.single.f32").workload
    (bench / "workloads" / "codec.tiny.f32.json").write_text(json.dumps(dict(wl, config="dmel-tiny")))
    (bench / "metrics" / "requests_per_s.py").write_text(
        '"""requests_per_s: requests over the window\'s seconds."""\n\n\ndef read(run):\n'
        '    return len(run.records) / run.window_s\n')
    spec_json = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    spec_json["configs"].append({"name": "dmel-tiny", "source": "https://example.org/dmel-tiny",
                                 "file": "benchmark/configs/dmel-tiny.json", "reduced": [], "why": "a test"})
    spec_json["workloads"].append({"name": "codec.tiny.f32", "config": "dmel-tiny", "traffic": "tiny", "chips": 1,
                                   "why": "a test"})
    spec_json["per_layer"].append({"name": "requests_per_s", "unit": "1/s", "better": "higher",
                                   "source": "host_clock", "layer": "request entry", "moves": "audio_s_per_s",
                                   "workloads": ["codec.tiny.f32"]})
    for m in spec_json["end_to_end"]:
        if m["name"] == "audio_s_per_s":
            m["workloads"].append("codec.tiny.f32")
    (root / "BENCHMARK.json").write_text(json.dumps(spec_json))
    cell = spec.cell("codec.tiny.f32", root=root, bench=bench)
    assert cell.bench == bench and cell.config["codec"]["n_mels"] == 20
    for trace in (False, True):
        out = runner.run_cell(cell, SEED, 0.5, trace, torch.device("cpu"), time.perf_counter())
        result = bench_run.result_line(cell, out, "cpu")
        contract_shaped(result, cell, trace)
        assert result["correct"]
    assert result["metrics"]["requests_per_s"]["value"] > 0
