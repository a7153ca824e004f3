"""Shared CLI helpers: checkpoint -> model / adapter loading.

Checkpoints here are state_dicts written by `torch.save`: `model.pt` under
a checkpoint directory for the LM and the codec, one file for the BigVGAN
generator (bare, or under a "generator" key as the original release has
it). A model runs in the dtype its checkpoint was saved in.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from dmel_codec_tpu_torch.eval.codecs import DMelCodecAdapter
from dmel_codec_tpu_torch.models.bigvgan import BigVGANConfig, load_torch_checkpoint
from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
from dmel_codec_tpu_torch.models.lm import SlowFastLMConfig

CHECKPOINT_FILE = "model.pt"


def load_state_dict(ckpt_dir: str, what: str) -> dict:
    path = os.path.join(ckpt_dir, CHECKPOINT_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {what} checkpoint under {ckpt_dir}")
    return torch.load(path, map_location="cpu", weights_only=True)


def float_dtype(sd: dict) -> torch.dtype:
    return next(v.dtype for v in sd.values() if v.is_floating_point())


def load_module(module: torch.nn.Module, sd: dict, device) -> torch.nn.Module:
    """`module` filled from `sd`, in the state_dict's floating dtype, on `device`."""
    module.to(float_dtype(sd)).load_state_dict(sd)
    return module.to(device).eval()


def load_codec_adapter(
    ckpt_dir: str,
    codec_cfg: Optional[DMelCodecConfig] = None,
    vocoder_ckpt: Optional[str] = None,
    vocoder_cfg: Optional[BigVGANConfig] = None,
    device="cuda",
) -> DMelCodecAdapter:
    sd = load_state_dict(ckpt_dir, "codec")
    codec_cfg = codec_cfg or DMelCodecConfig()
    if float_dtype(sd) == torch.bfloat16:
        codec_cfg = dataclasses.replace(codec_cfg, compute_dtype="bfloat16")
    codec = load_module(DMelCodec(codec_cfg), sd, device)
    vocoder = None
    if vocoder_ckpt:
        if not os.path.isfile(vocoder_ckpt):
            raise FileNotFoundError(f"no vocoder checkpoint at {vocoder_ckpt}")
        vocoder = load_torch_checkpoint(vocoder_ckpt, vocoder_cfg or BigVGANConfig()).to(device)
    return DMelCodecAdapter(codec, vocoder)


def build_lm_config(cfg: dict) -> SlowFastLMConfig:
    """SlowFastLMConfig from a CLI YAML: optional `slow_lm:` / `fast_lm:`
    sections override the flagship TransformerConfigs (testing, smaller
    deployments); text/audio loss weights come from the top level."""
    kwargs = dict(
        text_weight=cfg.get("text_weight", 0.01),
        audio_weight=cfg.get("audio_weight", 1.0),
    )
    base = SlowFastLMConfig()
    if cfg.get("slow_lm"):
        kwargs["slow"] = dataclasses.replace(
            base.slow, **dataclass_from_dict_overrides(cfg["slow_lm"])
        )
    if cfg.get("fast_lm"):
        kwargs["fast"] = dataclasses.replace(
            base.fast, **dataclass_from_dict_overrides(cfg["fast_lm"])
        )
    return SlowFastLMConfig(**kwargs)


def dataclass_from_dict_overrides(d: dict) -> dict:
    """Tuple-ize list values for frozen dataclass replacement."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
