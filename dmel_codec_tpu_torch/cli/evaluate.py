"""Codec evaluation entry point (port of `dmel_codec_tpu/cli/evaluate.py`).

    python -m dmel_codec_tpu_torch.cli.evaluate --config configs/eval.yaml

Reads the YAML keys of `configs/eval.yaml`: `codec_ckpt_dir` (a codec
checkpoint directory, cli/common.py), `vocoder_ckpt` (a BigVGAN generator
state_dict; without it the metrics are taken in the mel domain),
`test_manifest`, `max_duration`, `whisper_path` (a local HF Whisper
directory enables ASR-WER), `compute_pesq`, `compute_spk_sim`; optional
sections `model:` (DMelCodecConfig) and `vocoder:` (BigVGANConfig) size the
models. Prints the JSON of the metrics' means. Runs on `--device` (default
cuda).
"""

from __future__ import annotations

import argparse
import itertools
import json

from dmel_codec_tpu_torch.cli.common import load_codec_adapter
from dmel_codec_tpu_torch.data.loader import DataLoader
from dmel_codec_tpu_torch.data.manifest import load_manifest
from dmel_codec_tpu_torch.eval.evaluation import Evaluation
from dmel_codec_tpu_torch.eval.external import WhisperASR
from dmel_codec_tpu_torch.models.bigvgan import BigVGANConfig
from dmel_codec_tpu_torch.models.codec import DMelCodecConfig
from dmel_codec_tpu_torch.utils.config import dataclass_from_dict, load_yaml
from dmel_codec_tpu_torch.utils.precision import strict_float32


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate codec reconstruction")
    parser.add_argument("--config", required=True)
    parser.add_argument("--max-batches", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = parser.parse_args(argv)
    strict_float32()  # no TF32: the JAX package's float32 contract (utils/precision.py)

    cfg = load_yaml(args.config)
    vocoder_cfg = cfg.get("vocoder")
    codec = load_codec_adapter(
        cfg["codec_ckpt_dir"],
        codec_cfg=dataclass_from_dict(DMelCodecConfig, cfg.get("model")),
        vocoder_ckpt=cfg.get("vocoder_ckpt"),
        vocoder_cfg=dataclass_from_dict(BigVGANConfig, vocoder_cfg) if vocoder_cfg else None,
        device=args.device,
    )

    cuts = load_manifest(cfg["test_manifest"])
    loader = DataLoader(
        cuts, sample_rate=codec.sample_rate, max_duration=cfg.get("max_duration", 30.0), shuffle=False
    )
    batches = iter(loader)
    if args.max_batches:
        batches = itertools.islice(batches, args.max_batches)

    asr = WhisperASR(cfg["whisper_path"], device=args.device) if cfg.get("whisper_path") else None

    result = Evaluation(
        codec,
        asr=asr,
        compute_pesq=cfg.get("compute_pesq", False),
        compute_spk_sim=cfg.get("compute_spk_sim", False),
        device=args.device,
    ).run(batches)
    print(json.dumps(result.means, indent=2))


if __name__ == "__main__":
    main()
