"""Codec GAN training entry point (port of `dmel_codec_tpu/cli/train_codec.py`;
reads the same YAML).

    python -m dmel_codec_tpu_torch.cli.train_codec --config configs/codec.yaml

YAML sections: model (DMelCodecConfig), train (CodecTrainConfig), fit
(FitConfig), data {train_manifest, val_manifest, max_duration,
val_max_duration, seed, audio_backend}, distributed (DistributedConfig).
Checkpoints go to `fit.ckpt_dir` as
`step_<N>/{step,gen_params,disc_params,gen_opt_state,disc_opt_state}.pt`
(train/checkpoint.py); a run resumes from the newest one, and serving
(`cli/common.load_codec_adapter`) reads its `gen_params`. Runs on `--device`
(default cuda).

`--distributed` (or `distributed: {enabled: true}`) trains data-parallel,
one process per device (parallel/multihost.py, parallel/mesh.py), e.g.

    torchrun --nproc-per-node 8 -m dmel_codec_tpu_torch.cli.train_codec \
        --config configs/codec.yaml --distributed

Each rank loads its shard of the manifest; with `fit.use_mesh` (the
default) each step is the step on the union of the ranks' batches.
"""

from __future__ import annotations

import argparse
import dataclasses

from dmel_codec_tpu_torch.cli.common import without_jax_only
from dmel_codec_tpu_torch.data.loader import DataLoader
from dmel_codec_tpu_torch.data.manifest import load_manifest
from dmel_codec_tpu_torch.models.codec import DMelCodecConfig
from dmel_codec_tpu_torch.parallel.multihost import DistributedConfig, distributed, host_shard
from dmel_codec_tpu_torch.train.codec_trainer import CodecTrainConfig, CodecTrainer
from dmel_codec_tpu_torch.train.loop import CodecFitLoop, FitConfig
from dmel_codec_tpu_torch.utils.config import dataclass_from_dict, load_yaml, print_config_tree
from dmel_codec_tpu_torch.utils.logging import RankedLogger
from dmel_codec_tpu_torch.utils.precision import strict_float32

log = RankedLogger(__name__)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train the dMel codec (GAN)")
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
    codec_cfg = dataclass_from_dict(DMelCodecConfig, cfg.get("model"))
    train_cfg = dataclass_from_dict(CodecTrainConfig, cfg.get("train"))
    fit_cfg = dataclass_from_dict(FitConfig, without_jax_only(cfg.get("fit")))
    data = cfg.get("data", {})

    shard, n_shards = host_shard()
    train_cuts = load_manifest(data["train_manifest"])
    audio_backend = data.get("audio_backend", "auto")

    def train_batches(epoch):
        # one device per process: a rank's batch needs no padding to a multiple
        return DataLoader(
            train_cuts,
            sample_rate=codec_cfg.sample_rate,
            max_duration=data.get("max_duration", 210.0),
            seed=data.get("seed", 0),
            num_shards=n_shards,
            shard_index=shard,
            audio_backend=audio_backend,
        ).epoch(epoch)

    val_batches = None
    if data.get("val_manifest"):
        val_cuts = load_manifest(data["val_manifest"])

        def val_batches():
            return iter(
                DataLoader(
                    val_cuts,
                    sample_rate=codec_cfg.sample_rate,
                    max_duration=data.get("val_max_duration", 4.0),
                    shuffle=False,
                    audio_backend=audio_backend,
                )
            )

    trainer = CodecTrainer(codec_cfg, train_cfg, device=device)
    CodecFitLoop(trainer, train_batches, val_batches, fit_cfg).run()


if __name__ == "__main__":
    main()
