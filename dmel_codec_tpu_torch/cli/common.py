"""Shared CLI helpers: checkpoint -> model / adapter loading.

LM and codec checkpoints are `train/checkpoint.py` directories
(`step_<N>/<field>.pt`): serving reads the newest step's `params` (LM; what
`train_lm` writes) or `gen_params` (codec), a state_dict of the module, and
never the optimizer state beside it. The BigVGAN generator is one
`torch.save` file (bare, or under a "generator" key as the original release
has it). A model runs in the dtype its checkpoint was saved in.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import torch

from dmel_codec_tpu_torch.eval.codecs import DMelCodecAdapter
from dmel_codec_tpu_torch.models.bigvgan import BigVGANConfig, load_torch_checkpoint
from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
from dmel_codec_tpu_torch.models.lm import ChatMusicLM, SlowFastLMConfig
from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
from dmel_codec_tpu_torch.utils.logging import RankedLogger

log = RankedLogger(__name__)


def restore_fields(ckpt_dir: str, fields: Sequence[str], what: str) -> dict:
    """The named train-state fields of the newest checkpoint under
    `ckpt_dir` (the module's `load_state_dict` checks them afterwards)."""
    restored = None
    if os.path.isdir(ckpt_dir):
        restored = CheckpointManager(ckpt_dir).restore_latest_fields(None, fields)
    if restored is None:
        raise FileNotFoundError(f"no {what} checkpoint under {ckpt_dir}")
    return restored


def load_lm_params(ckpt_dir: str) -> dict:
    """The LM's state_dict from the newest `train_lm` checkpoint."""
    restored = restore_fields(ckpt_dir, ("params", "step"), "LM")
    log.info(f"LM checkpoint: step {restored['step']} under {ckpt_dir}")
    return restored["params"]


def float_dtype(sd: dict) -> torch.dtype:
    return next(v.dtype for v in sd.values() if v.is_floating_point())


def load_module(module: torch.nn.Module, sd: dict, device) -> torch.nn.Module:
    """`module` filled from `sd`, in the state_dict's floating dtype, on `device`."""
    module.to(float_dtype(sd)).load_state_dict(sd)
    return module.to(device).eval()


def load_lm(config: SlowFastLMConfig, sd: dict, device) -> ChatMusicLM:
    """A ChatMusicLM of `config` holding the state_dict's tensors (in their
    dtype), on `device`. Built on the meta device and given the tensors
    themselves: no float32 model is made on the host first, which for a
    16 B decoder would take 64 GB."""
    with torch.device("meta"):
        model = ChatMusicLM(config)
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device).eval()


def load_codec_adapter(
    ckpt_dir: str,
    codec_cfg: Optional[DMelCodecConfig] = None,
    vocoder_ckpt: Optional[str] = None,
    vocoder_cfg: Optional[BigVGANConfig] = None,
    device="cuda",
) -> DMelCodecAdapter:
    codec_cfg = codec_cfg or DMelCodecConfig()
    sd = restore_fields(ckpt_dir, ("gen_params",), "codec")["gen_params"]
    if float_dtype(sd) == torch.bfloat16:
        codec_cfg = dataclasses.replace(codec_cfg, compute_dtype="bfloat16")
    codec = load_module(DMelCodec(codec_cfg), sd, device)
    vocoder = None
    if vocoder_ckpt:
        if not os.path.isfile(vocoder_ckpt):
            raise FileNotFoundError(f"no vocoder checkpoint at {vocoder_ckpt}")
        vocoder = load_torch_checkpoint(vocoder_ckpt, vocoder_cfg or BigVGANConfig()).to(device)
    return DMelCodecAdapter(codec, vocoder)


# SlowFastLMConfig's text special ids, which a YAML may set at its top level
SPECIAL_IDS = ("bos_token_id", "eos_token_id", "start_of_human_id", "end_of_human_id", "start_of_robot_id",
               "end_of_robot_id", "start_of_music_id", "end_of_music_id", "text_pad_id")


def build_lm_config(cfg: dict) -> SlowFastLMConfig:
    """SlowFastLMConfig from a CLI YAML: optional `slow_lm:` / `fast_lm:`
    sections override the flagship TransformerConfigs (testing, smaller
    deployments; `kind: deepseek_v3` with its latent-attention and expert
    keys makes a DeepSeek-V3 decoder, configs/lm_infer_moonlight.yaml);
    text/audio loss weights come from the top level, and so may the text
    special ids (SPECIAL_IDS; a vocabulary that does not hold the
    flagship's, configs/lm_infer_nemotron_h.yaml). A key that is no
    TransformerConfig field raises TypeError."""
    kwargs = dict(
        text_weight=cfg.get("text_weight", 0.01),
        audio_weight=cfg.get("audio_weight", 1.0),
        **{k: cfg[k] for k in SPECIAL_IDS if k in cfg},
    )
    base = SlowFastLMConfig()
    for section, field in (("slow_lm", "slow"), ("fast_lm", "fast")):
        if cfg.get(section):
            overrides = dataclass_from_dict_overrides(without_jax_only(cfg[section]))
            kwargs[field] = dataclasses.replace(getattr(base, field), **overrides)
    return SlowFastLMConfig(**kwargs)


# Keys of the JAX package's YAMLs that name XLA constructs with no
# counterpart here: `scan_layers` (one compiled layer body) in `slow_lm:` /
# `fast_lm:`. (`fit.use_mesh` is `FitConfig.use_mesh`: data parallelism
# under a process group.)
JAX_ONLY_KEYS = ("scan_layers",)


def without_jax_only(section: Optional[dict]) -> dict:
    """A YAML section without the JAX-only keys, so that the same file
    drives both packages."""
    return {k: v for k, v in (section or {}).items() if k not in JAX_ONLY_KEYS}


def dataclass_from_dict_overrides(d: dict) -> dict:
    """Tuple-ize list values for frozen dataclass replacement."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
