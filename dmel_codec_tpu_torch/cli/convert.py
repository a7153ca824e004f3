"""Bring the original torch reference's released checkpoints into this
package (port of `dmel_codec_tpu/cli/convert.py`; the same subcommands).

    python -m dmel_codec_tpu_torch.cli.convert vqgan   --ckpt epoch=...ckpt --out ckpt/codec [--config codec.yaml]
    python -m dmel_codec_tpu_torch.cli.convert bigvgan --dir bigvgan_v2_24khz_100band_256x --out ckpt/vocoder
    python -m dmel_codec_tpu_torch.cli.convert qwen2   --safetensors model.safetensors --out ckpt/lm [--config lm.yaml]

This package's modules carry the reference's parameter names, so each
subcommand is a load, a strict key check and a save in the form that the
package's own consumer reads:

  * vqgan: a Lightning `.ckpt` (its "state_dict": the generator under
    `encoder.`, `quantizer.`, `decoder.`, `quality_projection.`, the
    discriminator under `discriminator.`, the mel transforms' buffers) ->
    a `CodecTrainState` at step 0 with fresh optimizers, through
    `CheckpointManager`: `cli.train_codec` resumes from it (`fit.ckpt_dir`),
    `cli.stream_codec --codec-ckpt` and `load_codec_adapter` serve its
    `gen_params`. `--config` is a codec YAML (`model:`, `train:`).
  * bigvgan: a release directory (`config.json`, `bigvgan_generator.pt`)
    -> the same layout with the generator's state_dict in its own dtype:
    `cli.stream_codec --vocoder-dir OUT`, and `OUT/bigvgan_generator.pt` as
    the `vocoder_ckpt` of `cli.infer_lm` / `cli.evaluate`.
  * qwen2: a HF Qwen2 safetensors file merged into a `ChatMusicLM`
    (`models/lm.load_qwen2_foundation`) -> an `LMTrainState` at step 0 with
    a fresh optimizer: `cli.train_lm` resumes a full finetune from it, and
    `cli.infer_lm` (`lm_ckpt_dir`) serves its `params`. `--config` is the
    train_lm YAML (`slow_lm:`, `fast_lm:`, `train:`), so that the state
    has the shapes and the optimizer layout the run expects.

vqgan and qwen2 build their train states on `--device` (default cuda);
the files load on any device.
"""

from __future__ import annotations

import argparse
import os
import shutil

import torch

from dmel_codec_tpu_torch.cli.common import build_lm_config
from dmel_codec_tpu_torch.models.bigvgan import from_pretrained
from dmel_codec_tpu_torch.models.codec import DMelCodecConfig
from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
from dmel_codec_tpu_torch.utils.config import dataclass_from_dict, load_yaml
from dmel_codec_tpu_torch.utils.logging import RankedLogger
from dmel_codec_tpu_torch.utils.precision import strict_float32

log = RankedLogger(__name__)

GENERATOR_PREFIXES = ("encoder.", "quantizer.", "decoder.", "quality_projection.")
DISCRIMINATOR_PREFIX = "discriminator."
# the Lightning module's subtrees that hold no trained weight: the mel
# transforms' buffers (its frozen vocoder is dropped at save)
SKIPPED_PREFIXES = ("encode_mel_transform.", "gt_mel_transform.")


def _yaml(path) -> dict:
    return load_yaml(path) if path else {}


def _weight_norm_names(sd: dict) -> dict:
    """torch's parametrized weight norm (`parametrizations.weight.original0/1`)
    under its classic names (`weight_g` / `weight_v`), which the modules use."""
    return {
        k.replace(".parametrizations.weight.original0", ".weight_g").replace(
            ".parametrizations.weight.original1", ".weight_v"
        ): v
        for k, v in sd.items()
    }


def load_strict(module: torch.nn.Module, sd: dict, what: str) -> None:
    """`module.load_state_dict(sd)`, with a missing or an extra key an error
    that names them."""
    want = set(module.state_dict())
    missing, extra = sorted(want - set(sd)), sorted(set(sd) - want)
    if missing or extra:
        raise ValueError(f"{what}: {len(missing)} missing keys {missing[:5]}, {len(extra)} unexpected keys {extra[:5]}")
    module.load_state_dict(sd)


def split_vqgan_state_dict(sd: dict):
    """A VQGAN Lightning state_dict -> (the generator's state_dict, the
    discriminator's or None). A key outside the known subtrees is an error."""
    gen, disc, unknown = {}, {}, []
    for key, value in _weight_norm_names(sd).items():
        if key.startswith(GENERATOR_PREFIXES):
            gen[key] = value
        elif key.startswith(DISCRIMINATOR_PREFIX):
            disc[key[len(DISCRIMINATOR_PREFIX):]] = value
        elif not key.startswith(SKIPPED_PREFIXES):
            unknown.append(key)
    if unknown:
        raise ValueError(f"vqgan checkpoint: {len(unknown)} keys outside the VQGAN's subtrees: {sorted(unknown)[:5]}")
    return gen, (disc or None)


def convert_vqgan(args) -> None:
    from dmel_codec_tpu_torch.train.codec_trainer import CodecTrainConfig, CodecTrainer

    cfg = _yaml(args.config)
    ckpt = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    gen_sd, disc_sd = split_vqgan_state_dict(ckpt.get("state_dict", ckpt))
    trainer = CodecTrainer(
        dataclass_from_dict(DMelCodecConfig, cfg.get("model")),
        dataclass_from_dict(CodecTrainConfig, cfg.get("train")),
        device=args.device,
    )
    state = trainer.init_state(0)  # its parameters are the trainer's modules'
    load_strict(trainer.codec, gen_sd, "vqgan checkpoint, generator")
    if disc_sd is not None:
        load_strict(trainer.discriminator, disc_sd, "vqgan checkpoint, discriminator")
    CheckpointManager(args.out).save(0, state)
    log.info(f"wrote a CodecTrainState (step 0, discriminator {'from the file' if disc_sd else 'fresh'}) to {args.out}")


def convert_bigvgan(args) -> None:
    model = from_pretrained(args.dir)  # strict keys, the checkpoint's dtype
    os.makedirs(args.out, exist_ok=True)
    shutil.copyfile(os.path.join(args.dir, "config.json"), os.path.join(args.out, "config.json"))
    torch.save({"generator": model.state_dict()}, os.path.join(args.out, "bigvgan_generator.pt"))
    dtype = next(p.dtype for p in model.parameters())
    log.info(f"wrote the BigVGAN generator ({dtype}) and its config.json to {args.out}")


def convert_qwen2(args) -> None:
    from safetensors.numpy import load_file

    from dmel_codec_tpu_torch.models.lm import load_qwen2_foundation
    from dmel_codec_tpu_torch.train.lm_trainer import LMTrainConfig, LMTrainer

    cfg = _yaml(args.config)
    trainer = LMTrainer(
        build_lm_config(cfg), dataclass_from_dict(LMTrainConfig, cfg.get("train")), device=args.device
    )
    state = trainer.init_state(0)  # its params are the model's own tensors
    load_qwen2_foundation(trainer.model, load_file(args.safetensors))
    CheckpointManager(args.out).save(0, state)
    log.info(f"wrote an LMTrainState (step 0, the Qwen2 foundation merged) to {args.out}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="reference torch checkpoints -> this package's checkpoints")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("vqgan")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--config", default=None)
    p.set_defaults(fn=convert_vqgan)

    p = sub.add_parser("bigvgan")
    p.add_argument("--dir", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=convert_bigvgan)

    p = sub.add_parser("qwen2")
    p.add_argument("--safetensors", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--config", default=None)
    p.set_defaults(fn=convert_qwen2)

    for name in ("vqgan", "qwen2"):
        sub.choices[name].add_argument(
            "--device", default="cuda", help="where the train state is built: cuda (default), cuda:N or cpu"
        )
    args = parser.parse_args(argv)
    strict_float32()  # no TF32: the JAX package's float32 contract (utils/precision.py)
    args.fn(args)


if __name__ == "__main__":
    main()
