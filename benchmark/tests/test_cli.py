"""The command's refusals: no result, and a non-zero exit, without a GPU
and in a directory that holds only BENCHMARK.json and the benchmark."""

import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.harness import spec

ARGS = ["-m", "benchmark.run", "--workload", "codec.single.f32", "--seed", str(2**31 + 9), "--seconds", "1",
        "--trace", "0"]


def test_without_a_gpu_there_is_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    done = subprocess.run([sys.executable, *ARGS], cwd=spec.ROOT, capture_output=True, text=True, timeout=120)
    assert done.returncode != 0 and done.stdout.strip() == ""


def test_outside_a_checkout_there_is_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    done = subprocess.run([sys.executable, *ARGS], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert done.returncode != 0 and done.stdout.strip() == ""


def test_forbidden_modules_are_found_by_whole_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "dmel_codec_tpu_torch_extra", object())
    assert "dmel_codec_tpu" not in run.forbidden_modules() or "dmel_codec_tpu" in sys.modules
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert "jaxlib" in run.forbidden_modules()
