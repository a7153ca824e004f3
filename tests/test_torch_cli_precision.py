"""The port's entry points pin float32: each CLI `main` turns TF32 off for
cuBLAS matmuls and cuDNN convs before it builds a model, whatever the
process allowed before (PyTorch's default lets cuDNN convs run in TF32),
as the JAX package computes float32 in full float32.

Each case runs one `main(... --device cpu)` at the small sizes of the
CLIs' own tests in a fresh process that first turns both TF32 flags on:
the flags are process-wide and the suite runs several tests per worker.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from dmel_codec_tpu_torch.cli.common import build_lm_config
from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
from dmel_codec_tpu_torch.models.lm import ChatMusicLM
from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
from tests.test_torch_lm import FAST_KW, SLOW_KW
from tests.test_torch_support import CODEC_KW, VOCODER_KW
from tests.test_torch_train_codec import _write_corpus, _yaml

ROOT = Path(__file__).resolve().parents[1]

# turn TF32 on, run the CLI's main, print what the process allows afterwards
RUNNER = """
import json, sys
import torch
torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = True
torch.backends.cuda.matmul.allow_tf32 = True
assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
import importlib
from dmel_codec_tpu_torch.utils.precision import tf32_flags
importlib.import_module("dmel_codec_tpu_torch.cli." + sys.argv[1]).main(sys.argv[2:])
print(json.dumps(tf32_flags()))
"""


def _stream_codec(tmp_path: Path) -> list:
    t = np.arange(24000) / 24000
    wavfile.write(tmp_path / "in.wav", 24000, (0.4 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32))
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump({
        "model": dict(n_mels=20, dmel_groups=2, encoder_residual_channels=6, encoder_layers=3, decoder_layers=3),
        "vocoder": dict(num_mels=20, upsample_initial_channel=64),
    }))
    return ["--in", str(tmp_path / "in.wav"), "--tokens-out", str(tmp_path / "tok.npy"), "--out",
            str(tmp_path / "out.wav"), "--config", str(tmp_path / "cfg.yaml"), "--device", "cpu",
            "--chunk-frames", "64", "--halo-frames", "32"]


def _train_codec(tmp_path: Path) -> list:
    return ["--config", _yaml(tmp_path, _write_corpus(tmp_path), 2), "--device", "cpu"]


def _lm_files(tmp_path: Path) -> dict:
    """A codec checkpoint of 10 codebooks (what the LM speaks), a vocoder
    and the small LM's sections."""
    codec_kw = dict(CODEC_KW, dmel_groups=10)
    torch.manual_seed(0)
    CheckpointManager(str(tmp_path / "codec")).save(0, {"gen_params": DMelCodec(DMelCodecConfig(**codec_kw)).state_dict()})
    torch.save({"generator": BigVGAN(BigVGANConfig(**VOCODER_KW)).state_dict()}, tmp_path / "vocoder.pt")
    return {"codec_ckpt_dir": str(tmp_path / "codec"), "slow_lm": SLOW_KW, "fast_lm": FAST_KW, "codec_kw": codec_kw}


def _train_lm(tmp_path: Path) -> list:
    files = _lm_files(tmp_path)
    corpus = _write_corpus(tmp_path)
    cfg = {
        "codec_ckpt_dir": files["codec_ckpt_dir"], "codec_model": files["codec_kw"],
        "slow_lm": files["slow_lm"], "fast_lm": files["fast_lm"],
        "train": {"accumulate_grad": 1, "num_warmup_steps": 1},
        "fit": {"max_steps": 1, "val_interval": 100, "log_every": 1, "ckpt_dir": str(tmp_path / "lm_ckpt"),
                "log_dir": str(tmp_path / "lm_logs"), "use_mesh": False, "seed": 4},
        "data": {"train_manifest": str(corpus), "max_duration": 2.0},
    }
    (tmp_path / "lm.yaml").write_text(yaml.safe_dump(cfg))
    return ["--config", str(tmp_path / "lm.yaml"), "--device", "cpu"]


def _infer_lm(tmp_path: Path) -> list:
    files = _lm_files(tmp_path)
    torch.manual_seed(1)
    lm = ChatMusicLM(build_lm_config({"slow_lm": SLOW_KW, "fast_lm": FAST_KW}))
    CheckpointManager(str(tmp_path / "lm_ckpt")).save(0, {"params": lm.state_dict(), "step": 0})
    cfg = {
        "lm_ckpt_dir": str(tmp_path / "lm_ckpt"), "codec_ckpt_dir": files["codec_ckpt_dir"],
        "vocoder_ckpt": str(tmp_path / "vocoder.pt"), "model": files["codec_kw"],
        "vocoder": {k: list(v) if isinstance(v, tuple) else v for k, v in VOCODER_KW.items()},
        "slow_lm": files["slow_lm"], "fast_lm": files["fast_lm"],
        "inference": {"max_new_tokens": 2, "max_seq_len": 64, "top_k": 1},
    }
    (tmp_path / "infer.yaml").write_text(yaml.safe_dump(cfg))
    return ["--config", str(tmp_path / "infer.yaml"), "--prompt", "hi", "--out", str(tmp_path / "out.wav"),
            "--device", "cpu"]


def _evaluate(tmp_path: Path) -> list:
    from tests.test_torch_eval import VOCODER_KW as EVAL_VOCODER_KW, _speechlike

    wavfile.write(tmp_path / "clip.wav", 24000, _speechlike(0.5, 150.0, 0))
    (tmp_path / "test.jsonl").write_text(json.dumps({"id": "c", "audio_path": str(tmp_path / "clip.wav"),
                                                     "duration": 0.5, "text": ""}) + "\n")
    torch.manual_seed(0)
    CheckpointManager(str(tmp_path / "codec")).save(0, {"gen_params": DMelCodec(DMelCodecConfig(**CODEC_KW)).state_dict()})
    torch.save(BigVGAN(BigVGANConfig(**EVAL_VOCODER_KW)).state_dict(), tmp_path / "vocoder.pt")
    (tmp_path / "eval.yaml").write_text(yaml.safe_dump({
        "codec_ckpt_dir": str(tmp_path / "codec"), "vocoder_ckpt": str(tmp_path / "vocoder.pt"),
        "test_manifest": str(tmp_path / "test.jsonl"), "compute_pesq": False, "model": CODEC_KW,
        "vocoder": {k: list(v) if isinstance(v, tuple) else v for k, v in EVAL_VOCODER_KW.items()},
    }))
    return ["--config", str(tmp_path / "eval.yaml"), "--device", "cpu"]


CLIS = {"evaluate": _evaluate, "infer_lm": _infer_lm, "stream_codec": _stream_codec, "train_codec": _train_codec,
        "train_lm": _train_lm}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_cli_main_turns_tf32_off(cli, tmp_path):
    argv = CLIS[cli](tmp_path)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, "-c", RUNNER, cli, *argv], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    flags = json.loads(proc.stdout.strip().splitlines()[-1])
    assert flags["cuda.matmul.allow_tf32"] is False and flags["cudnn.allow_tf32"] is False, flags
    assert flags.get("cudnn.conv.fp32_precision", "ieee") != "tf32", flags
