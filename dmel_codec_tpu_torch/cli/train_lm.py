"""Slow-fast LM training entry point (port of `dmel_codec_tpu/cli/train_lm.py`;
reads the same YAML).

    python -m dmel_codec_tpu_torch.cli.train_lm --config configs/lm.yaml

Needs a codec checkpoint directory (`codec_ckpt_dir`, cli/common.py) to
tokenize audio; optionally a HF Qwen2-0.5B safetensors file for foundation
weights and a HF tokenizer path (byte-tokenizer fallback otherwise).
Checkpoints go to `fit.ckpt_dir` as `step_<N>/{step,params,opt_state}.pt`
(train/checkpoint.py); a run resumes from the newest one, and
`cli.infer_lm` serves from it. Runs on `--device` (default cuda).

`--distributed` (or `distributed: {enabled: true}`) trains data-parallel,
one process per device, as `cli/train_codec.py` describes: each rank
tokenizes its shard of the manifest, and with `fit.use_mesh` (the default)
each micro-step is the micro-step on the union of the ranks' batches.
"""

from __future__ import annotations

import argparse
import dataclasses

from dmel_codec_tpu_torch.cli.common import build_lm_config, load_codec_adapter, without_jax_only
from dmel_codec_tpu_torch.data.loader import DataLoader
from dmel_codec_tpu_torch.data.manifest import load_manifest
from dmel_codec_tpu_torch.lm.data import lm_batch_from_audio
from dmel_codec_tpu_torch.lm.inputs import TokenGridBuilder
from dmel_codec_tpu_torch.lm.tokenizer import load_text_tokenizer
from dmel_codec_tpu_torch.models.codec import DMelCodecConfig
from dmel_codec_tpu_torch.models.lm import load_qwen2_foundation
from dmel_codec_tpu_torch.parallel.multihost import DistributedConfig, distributed, host_shard
from dmel_codec_tpu_torch.train.lm_loop import LMFitLoop
from dmel_codec_tpu_torch.train.lm_trainer import LMTrainConfig, LMTrainer
from dmel_codec_tpu_torch.train.loop import FitConfig
from dmel_codec_tpu_torch.train.lora import LoRAConfig, lora_param_count
from dmel_codec_tpu_torch.utils.config import dataclass_from_dict, load_yaml, print_config_tree
from dmel_codec_tpu_torch.utils.logging import RankedLogger
from dmel_codec_tpu_torch.utils.precision import strict_float32

log = RankedLogger(__name__)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train the slow-fast LM")
    parser.add_argument("--config", required=True)
    parser.add_argument(
        "--distributed",
        action="store_true",
        help="data-parallel over torch.distributed, one process per device; the rendezvous comes from the "
        "config's `distributed:` section or torchrun's environment",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = parser.parse_args(argv)
    strict_float32()  # no TF32: the JAX package's float32 contract (utils/precision.py)

    cfg = load_yaml(args.config)
    log.info("config:\n" + print_config_tree(cfg))

    dist_cfg = dataclass_from_dict(DistributedConfig, cfg.get("distributed"))
    if args.distributed:
        dist_cfg = dataclasses.replace(dist_cfg, enabled=True)
    with distributed(dist_cfg, args.device) as device:
        train(cfg, device)


def train(cfg: dict, device) -> None:
    lm_cfg = build_lm_config(cfg)
    train_cfg = dataclass_from_dict(LMTrainConfig, cfg.get("train"))
    fit_cfg = dataclass_from_dict(FitConfig, without_jax_only(cfg.get("fit")))
    data = cfg.get("data", {})

    codec = load_codec_adapter(
        cfg["codec_ckpt_dir"],
        codec_cfg=dataclass_from_dict(DMelCodecConfig, cfg.get("codec_model")),
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

    train_cuts = load_manifest(data["train_manifest"])
    shard, n_shards = host_shard()

    def train_batches(epoch):
        # one device per process: a rank's batch needs no padding to a multiple
        loader = DataLoader(
            train_cuts,
            max_duration=data.get("max_duration", 80.0),
            seed=data.get("seed", 0),
            num_shards=n_shards,
            shard_index=shard,
            audio_backend=data.get("audio_backend", "auto"),
        )
        for audio_batch in loader.epoch(epoch):
            yield lm_batch_from_audio(codec, gridder, tokenizer, audio_batch)

    trainer = LMTrainer(lm_cfg, train_cfg, device=device)
    if cfg.get("lora"):
        # adapter-only finetune over the (possibly foundation-loaded) base
        lora_cfg = dataclass_from_dict(LoRAConfig, cfg["lora"])
        state = trainer.init_lora_state(fit_cfg.seed, lora_cfg)
        log.info(
            f"LoRA finetune: rank {lora_cfg.rank}, "
            f"{lora_param_count(state.lora):,} trainable adapter params"
        )
    else:
        state = trainer.init_state(fit_cfg.seed)
    if cfg.get("text_foundation_model_path"):
        from safetensors.numpy import load_file

        # in place: the state's (base) params are the model's own tensors
        load_qwen2_foundation(trainer.model, load_file(cfg["text_foundation_model_path"]))
        log.info("loaded Qwen2 foundation weights into the slow model")

    LMFitLoop(trainer, train_batches, None, fit_cfg, device=device).run(state)


if __name__ == "__main__":
    main()
