"""Prompted LM inference -> waveform (port of `dmel_codec_tpu/cli/infer_lm.py`).

Supports all three prompt grids: text-only, audio-only, and mixed
text+audio (the audio prompt is tokenized through the codec).

    python -m dmel_codec_tpu_torch.cli.infer_lm --config configs/lm_infer.yaml \
        --prompt "hello there" [--prompt-audio clip.wav] --out out.wav

`lm_ckpt_dir` is a `train_lm` checkpoint directory (the newest step's
`params` are read), `codec_ckpt_dir` a codec checkpoint directory
(`gen_params`), `vocoder_ckpt` a BigVGAN generator state_dict
(cli/common.py). Optional
YAML sections `model:` (DMelCodecConfig), `vocoder:` (BigVGANConfig) and
`slow_lm:` / `fast_lm:` size the models; without them they are the
flagship ones (`configs/lm_infer_moonlight.yaml`: a DeepSeek-V3 slow
decoder at Moonlight-16B-A3B's sizes). Runs on `--device` (default cuda).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from scipy.io import wavfile

from dmel_codec_tpu_torch.cli.common import (
    build_lm_config,
    load_codec_adapter,
    load_lm,
    load_lm_params,
)
from dmel_codec_tpu_torch.data.audio import load_audio
from dmel_codec_tpu_torch.lm.generate import InferenceConfig, SlowFastGenerator
from dmel_codec_tpu_torch.lm.inputs import TokenGridBuilder
from dmel_codec_tpu_torch.lm.tokenizer import load_text_tokenizer
from dmel_codec_tpu_torch.models.bigvgan import BigVGANConfig
from dmel_codec_tpu_torch.models.codec import DMelCodecConfig
from dmel_codec_tpu_torch.utils.config import dataclass_from_dict, load_yaml
from dmel_codec_tpu_torch.utils.logging import RankedLogger
from dmel_codec_tpu_torch.utils.precision import strict_float32

log = RankedLogger(__name__)


def main(argv=None):
    parser = argparse.ArgumentParser(description="LM text-prompt inference")
    parser.add_argument("--config", required=True)
    parser.add_argument("--prompt", default=None)
    parser.add_argument(
        "--prompt-audio",
        default=None,
        help="WAV file to tokenize through the codec as an audio prompt "
        "(alone or combined with --prompt)",
    )
    parser.add_argument("--out", default="generated.wav")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = parser.parse_args(argv)
    strict_float32()  # no TF32: the JAX package's float32 contract (utils/precision.py)
    device = torch.device(args.device)

    cfg = load_yaml(args.config)
    prompt_audio = args.prompt_audio or cfg.get("prompt_audio")
    prompt = args.prompt or cfg.get("prompt")
    if prompt is None and prompt_audio is None:
        prompt = "who are you?"

    lm_cfg = build_lm_config(cfg)
    model = load_lm(lm_cfg, load_lm_params(cfg["lm_ckpt_dir"]), device)

    vocoder_cfg = cfg.get("vocoder")
    codec = load_codec_adapter(
        cfg["codec_ckpt_dir"],
        codec_cfg=dataclass_from_dict(DMelCodecConfig, cfg.get("model")),
        vocoder_ckpt=cfg.get("vocoder_ckpt"),
        vocoder_cfg=dataclass_from_dict(BigVGANConfig, vocoder_cfg) if vocoder_cfg else None,
        device=device,
    )
    tokenizer = load_text_tokenizer(cfg.get("text_tokenizer_path"))
    gridder = TokenGridBuilder(
        config=lm_cfg,
        max_length=cfg.get("max_length", 4096),
        silence_length=cfg.get("silence_length", 3),
        audio_silence_id=tuple(
            cfg.get("audio_silence_id", (0, 0, 29, 174, 0, 6, 0, 146, 146, 6))
        ),
    )
    icfg = dataclass_from_dict(InferenceConfig, cfg.get("inference"))

    audio_prompt_ids = None
    if prompt_audio is not None:
        wav_prompt = load_audio(prompt_audio, target_sr=codec.sample_rate)
        indices, idx_lengths = codec.encode(wav_prompt[None, :])
        # [1, C, L] -> [L, C] raw codec ids (the grid applies the id shift)
        audio_prompt_ids = np.asarray(indices)[0, :, : int(idx_lengths[0])].T
        log.info(
            f"audio prompt: {len(wav_prompt) / codec.sample_rate:.2f} s -> "
            f"{audio_prompt_ids.shape[0]} frames"
        )

    text_ids = tokenizer.encode(prompt) if prompt is not None else None
    text_t, audio_t = gridder.build_infer_grid(text_ids=text_ids, audio_ids=audio_prompt_ids)
    gen = SlowFastGenerator(model, icfg)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    audio_ids, _ = gen.generate(text_t, audio_t, generator)
    if audio_ids.shape[0] <= 1:
        log.info("model generated no audio frames")
        return

    raw = gen.deshift(audio_ids[:-1])  # drop the <EOM> frame
    raw = np.clip(raw, 0, lm_cfg.audio_codebook_size - 1)
    indices = raw.T[None, :, :]  # [1, C, T]
    wav, _ = codec.decode(indices)
    if wav.size:
        wavfile.write(args.out, codec.sample_rate, np.asarray(wav[0], np.float32))
        log.info(f"wrote {args.out} ({wav.shape[-1] / codec.sample_rate:.2f} s)")
    else:
        log.info("no vocoder configured — decode produced mel only")


if __name__ == "__main__":
    main()
