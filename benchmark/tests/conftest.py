"""Tiny cells for the CPU tests: the cells' own traffic files and
configurations, cut to a size a CPU runs in seconds."""

import copy
import json
from pathlib import Path

import pytest
import torch

from benchmark.harness import spec

BENCH = Path(__file__).resolve().parent.parent


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; run on the card by `python3 -m pytest benchmark/tests -m card`")


def _load(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def tiny_codec_config() -> dict:
    cfg = _load("configs", "dmel-bigvgan-v2-24k")
    cfg["codec"].update(n_mels=20, dmel_groups=2, encoder_residual_channels=8, encoder_layers=2, decoder_layers=2)
    cfg["vocoder"].update(num_mels=20, upsample_rates=[4, 4, 4, 4], upsample_kernel_sizes=[8, 8, 8, 8],
                          upsample_initial_channel=512)
    return cfg


def tiny_lm_config() -> dict:
    cfg = _load("configs", "slowfast-qwen2-0.5b")
    cfg["slow"].update(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4, num_kv_heads=2)
    cfg["fast"].update(hidden_size=16, intermediate_size=32, num_layers=2, num_heads=2, num_kv_heads=1)
    return cfg


def tiny_cell(name: str) -> spec.Cell:
    """The cell `name` as BENCHMARK.json declares it, at a tiny size."""
    full = spec.cell(name)
    wl = copy.deepcopy(full.workload)
    p = wl["params"]
    if wl["driver"] == "codec_requests":
        cfg = tiny_codec_config()
        p.update(seconds_min=0.5, seconds_max=1.0, seconds_step=0.5, cycle=3, check_requests=2)
        wl["trace_units"] = 2
    elif wl["driver"] == "lm_train":
        cfg = tiny_lm_config()
        p.update(seq=96, text_min=4, text_max=12, pad_max=8, pool=4)
        wl["trace_units"] = 2
    else:
        cfg = tiny_lm_config()
        render = tiny_codec_config()
        render["codec"].update(dmel_groups=10, encoder_residual_channels=4)
        p.update(batch=4, render=render)
        p["inference"].update(max_new_tokens=8, max_seq_len=96)
    return spec.Cell(name, full.chips, wl, cfg, full.metrics)


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
