"""Codec GAN trainer (port of `dmel_codec_tpu/train/codec_trainer.py`), in
the JAX step's order:
  1. mel extraction, quality scalar and masks (no gradient)
  2. ONE generator forward (encode -> FSQ -> decode)
  3. discriminator update on (real, detached fake), clip-norm 1000
  4. generator update: band-weighted mel L1 + adversarial loss against the
     UPDATED discriminator, on the same generator graph, clip-norm 1000

A train state holds the trainer's own modules' parameters, which the steps
update IN PLACE (what buffer donation gives the JAX trainer):
`train_step(state, batch)` returns the same state object, advanced, and a
trainer carries one state at a time. Float32 parameters and arithmetic.

With `data_parallel` set (a `parallel.mesh.DataParallel`; the fit loop sets
it under a process group) each step is the step on the union of the ranks'
batches: every masked mean is this rank's share of the global mean, and the
gradients (of both updates) and the logged values are summed over the
ranks before the clip, the non-finite guard and the update.

Both optimizers are `train/optim.AccumulatingAdamW` (optax's chain): the
accumulator keeps the MEAN of the micro-step gradients, so the losses are
not divided by `accumulate_grad`; every parameter is decayed.

A step's parts are spans `codec.train.<part>` on the port's one span
helper, `utils/trace.span`: preamble, generator_forward,
discriminator_forward, discriminator_backward, discriminator_optimizer,
generator_losses, generator_backward, generator_optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from dmel_codec_tpu_torch.dsp.spectrogram import LogMelSpectrogram
from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig, quality_from_gt_mels
from dmel_codec_tpu_torch.models.discriminator import MelDiscriminator
from dmel_codec_tpu_torch.parallel.mesh import DataParallel, global_batch
from dmel_codec_tpu_torch.train.losses import (
    adversarial_loss,
    discriminator_loss,
    resample_mask_nearest,
    weighted_mel_loss,
)
from dmel_codec_tpu_torch.train.optim import AccumulatingAdamW, copy_into, detached, global_norm
from dmel_codec_tpu_torch.train.schedule import cosine_schedule_with_warmup
from dmel_codec_tpu_torch.utils.masks import avg_with_mask, sequence_mask
from dmel_codec_tpu_torch.utils.trace import span

FROZEN_WITH_ENCODER = ("encoder.", "quantizer.")  # subtrees `freeze_encoder` leaves alone


@dataclasses.dataclass(frozen=True)
class CodecTrainConfig:
    """Flagship hyperparameters (the JAX package's CodecTrainConfig)."""

    weight_adv: float = 0.2
    weight_vq: float = 1.0
    weight_mel: float = 1.0
    learning_rate: float = 1e-5
    betas: Tuple[float, float] = (0.8, 0.99)
    eps: float = 1e-5
    weight_decay: float = 0.01
    grad_clip: float = 1000.0
    num_warmup_steps: int = 100
    num_training_steps: int = 1_000_000
    final_lr_ratio: float = 0.01
    accumulate_grad: int = 1
    freeze_encoder: bool = False
    # > 0: a micro-step whose gradient is not finite is dropped (up to N in
    # a row), in both optimizers
    skip_nonfinite_updates: int = 0


@dataclasses.dataclass
class CodecTrainState:
    """`step` counts micro-steps. `gen_params` / `disc_params` map names to
    the codec's / discriminator's own parameter tensors (a `state_dict` of
    the module: serving loads `gen_params` as it is)."""

    step: int
    gen_params: Dict[str, torch.Tensor]
    disc_params: Dict[str, torch.Tensor]
    gen_opt_state: AccumulatingAdamW
    disc_opt_state: AccumulatingAdamW

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "gen_params": detached(self.gen_params),
            "disc_params": detached(self.disc_params),
            "gen_opt_state": self.gen_opt_state.state_dict(),
            "disc_opt_state": self.disc_opt_state.state_dict(),
        }

    def load_state_dict(self, fields: dict) -> None:
        copy_into(self.gen_params, fields["gen_params"], "gen_params")
        copy_into(self.disc_params, fields["disc_params"], "disc_params")
        self.gen_opt_state.load_state_dict(fields["gen_opt_state"])
        self.disc_opt_state.load_state_dict(fields["disc_opt_state"])
        self.step = int(fields["step"])


class CodecTrainer:
    """Builds the modules, the state, the optimizers and the train / eval steps."""

    def __init__(
        self,
        codec_config: DMelCodecConfig = DMelCodecConfig(),
        train_config: CodecTrainConfig = CodecTrainConfig(),
        mel_transform: Optional[LogMelSpectrogram] = None,
        gt_mel_transform: Optional[LogMelSpectrogram] = None,
        device="cuda",
    ):
        self.codec_config = codec_config
        self.config = train_config
        self.device = torch.device(device)
        self.data_parallel: Optional[DataParallel] = None  # set by the fit loop under a process group
        self.codec = DMelCodec(codec_config).to(self.device).train()
        self.discriminator = MelDiscriminator().to(self.device).train()
        # two independently configurable transforms: `mel_transform` feeds
        # the encoder, `gt_mel_transform` the losses, the quality scalar and
        # the mask lengths; the flagship makes them identical
        self.mel_transform = (mel_transform or LogMelSpectrogram(
            sample_rate=codec_config.sample_rate,
            hop_length=codec_config.hop_length,
            n_mels=codec_config.n_mels,
        )).to(self.device)
        self.gt_mel_transform = (gt_mel_transform or self.mel_transform).to(self.device)
        c = train_config
        self.schedule = cosine_schedule_with_warmup(
            c.learning_rate, c.num_warmup_steps, c.num_training_steps, final_lr_ratio=c.final_lr_ratio
        )

    # ---- states ------------------------------------------------------------
    def trained(self, name: str) -> bool:
        """Whether the generator parameter `name` is updated."""
        return not (self.config.freeze_encoder and name.startswith(FROZEN_WITH_ENCODER))

    def make_optimizers(
        self, gen_params: Dict[str, torch.Tensor], disc_params: Dict[str, torch.Tensor]
    ) -> Tuple[AccumulatingAdamW, AccumulatingAdamW]:
        """With `freeze_encoder` the generator's optimizer holds the other
        subtrees only: the frozen ones get no update and no decay, and the
        clip's norm is taken over the trained gradients."""
        gen = {name: p for name, p in gen_params.items() if self.trained(name)}
        return tuple(
            AccumulatingAdamW(params, {name: True for name in params}, self.config, self.schedule)
            for params in (gen, disc_params)
        )

    def init_state(self, seed: int = 0) -> CodecTrainState:
        """Both modules re-initialised from `seed` (drawn on the CPU, so the
        weights do not depend on the device), and fresh optimizers. The
        state's parameters ARE the trainer's modules' (no copy): a trainer
        holds one state, and a second `init_state` re-initialises the
        tensors that the first state refers to."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            fresh = DMelCodec(self.codec_config), MelDiscriminator()
        self.codec.load_state_dict(fresh[0].state_dict())
        self.discriminator.load_state_dict(fresh[1].state_dict())
        gen_params = dict(self.codec.named_parameters())
        disc_params = dict(self.discriminator.named_parameters())
        gen_opt, disc_opt = self.make_optimizers(gen_params, disc_params)
        return CodecTrainState(
            step=0, gen_params=gen_params, disc_params=disc_params,
            gen_opt_state=gen_opt, disc_opt_state=disc_opt,
        )

    def _check_own(self, state: CodecTrainState) -> None:
        """The steps run the trainer's own modules, so a state of another
        trainer would be ignored silently: refuse it."""
        own = dict(self.codec.named_parameters())
        if state.gen_params.keys() != own.keys() or any(state.gen_params[n] is not p for n, p in own.items()):
            raise ValueError("the state is not this trainer's: take it from this trainer's init_state")

    def device_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A host batch (numpy arrays or tensors) on the trainer's device:
        `audios` [B, L] float32, `audio_lengths` [B] int64, and `noise`
        [B, T, concat_dim] float32 where the batch carries one."""
        out = {
            "audios": torch.as_tensor(batch["audios"]).to(self.device, torch.float32),
            "audio_lengths": torch.as_tensor(batch["audio_lengths"]).to(self.device, torch.long),
        }
        if batch.get("noise") is not None:
            out["noise"] = torch.as_tensor(batch["noise"]).to(self.device, torch.float32)
        return out

    # ---- steps -------------------------------------------------------------
    @torch.no_grad()
    def _prepare(self, audios: torch.Tensor, audio_lengths: torch.Tensor):
        """Mel extraction, masks and quality: the no-gradient preamble.
        Encoder input comes from `mel_transform`; gt mels, the quality
        scalar (of the UNMASKED mels) and mask lengths from
        `gt_mel_transform`."""
        encode_mels = self.mel_transform(audios)
        if self.gt_mel_transform is self.mel_transform:
            gt_raw = encode_mels
        else:
            gt_raw = self.gt_mel_transform(audios)
        quality = quality_from_gt_mels(gt_raw)
        mel_lengths = audio_lengths // self.gt_mel_transform.hop_length
        mel_masks = sequence_mask(mel_lengths, gt_raw.shape[1])[..., None].to(gt_raw.dtype)
        return encode_mels, gt_raw * mel_masks, mel_masks, quality

    def _noise(self, batch, encode_mels: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """`batch["noise"]` where given (the parity tests drive both
        packages with the same draw), else drawn from `generator`."""
        if batch.get("noise") is not None:
            return batch["noise"].float()
        shape = (*encode_mels.shape[:2], self.codec_config.concat_dim)
        return torch.randn(shape, generator=generator, device=encode_mels.device)

    def train_step(
        self,
        state: CodecTrainState,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[CodecTrainState, Dict[str, Any]]:
        """One micro-step on a device batch {'audios' [B, L],
        'audio_lengths' [B], optional 'noise' [B, T, concat_dim]}. The state
        is advanced in place and returned. `generator` (on the trainer's
        device) draws the decoder's noise when the batch has none. Each part
        runs under its span `codec.train.<part>`; the optimizers' own spans
        nest in the two `codec.train.*_optimizer` parts."""
        cfg = self.config
        dp = self.data_parallel
        self._check_own(state)
        with span("codec.train.preamble"):
            encode_mels, gt_mels, mel_masks, quality = self._prepare(batch["audios"].float(), batch["audio_lengths"])
            noise = self._noise(batch, encode_mels, generator)

        # the single generator forward; its graph serves the generator's update below
        with span("codec.train.generator_forward"):
            gen_mel, _ = self.codec(encode_mels, mel_masks, quality, noise)

        # discriminator update on (real, detached fake)
        with span("codec.train.discriminator_forward"), global_batch(dp):
            real = self.discriminator(gt_mels)
            fake = self.discriminator(gen_mel.detach())
            d_mask = resample_mask_nearest(mel_masks, real.shape[2])
            loss_d, loss_real, loss_fake = discriminator_loss(real, fake, d_mask)
        with span("codec.train.discriminator_backward"):
            d_grads = torch.autograd.grad(loss_d, list(state.disc_params.values()))
            if dp is not None:
                dp.sum_(d_grads)
            d_norm = global_norm(d_grads)
            del real, fake
        with span("codec.train.discriminator_optimizer"):
            state.disc_opt_state.update(d_grads)

        # generator losses against the UPDATED critic; the gradient is taken
        # with respect to the generator's parameters only, so none lands on
        # the critic's
        with span("codec.train.generator_losses"), global_batch(dp):
            loss_mel = weighted_mel_loss(gen_mel, gt_mels, mel_masks)
            loss_adv = adversarial_loss(self.discriminator(gen_mel), d_mask)
            loss_g = cfg.weight_mel * loss_mel + cfg.weight_adv * loss_adv
        names = list(state.gen_params)
        with span("codec.train.generator_backward"):
            g_grads = torch.autograd.grad(loss_g, [state.gen_params[n] for n in names])
            if dp is not None:
                dp.sum_(g_grads)
            g_norm = global_norm(g_grads)  # over every subtree, frozen ones too
        with span("codec.train.generator_optimizer"):
            state.gen_opt_state.update(
                [g for n, g in zip(names, g_grads) if self.trained(n)],
                watch=[g for n, g in zip(names, g_grads) if not self.trained(n)],
            )

        shares = {
            "train/discriminator/loss": loss_d.detach(),
            "train/discriminator/loss_real": loss_real.detach(),
            "train/discriminator/loss_fake": loss_fake.detach(),
            "train/generator/loss": loss_g.detach(),
            "train/generator/loss_mel": loss_mel.detach(),
            "train/generator/loss_adv": loss_adv.detach(),
        }
        if dp is not None:
            shares = dp.sum_metrics(shares)
        metrics = {
            "train/grad_norm/generator": g_norm,
            "train/grad_norm/discriminator": d_norm,
            **shares,
            # the schedule advances once per accumulated update
            "train/lr": self.schedule(state.step // max(1, cfg.accumulate_grad)),
        }
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def eval_step(
        self,
        state: CodecTrainState,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Masked L1 mel loss at the fixed quality 2.0. `state` must be the
        trainer's own (its parameters are the codec's)."""
        self._check_own(state)
        audios = batch["audios"].float()
        encode_mels, gt_mels, mel_masks, _ = self._prepare(audios, batch["audio_lengths"])
        quality = torch.full((audios.shape[0], 1), 2.0, device=audios.device)
        gen_mel, _ = self.codec(encode_mels, mel_masks, quality, self._noise(batch, encode_mels, generator))
        return {"val_loss": avg_with_mask((gen_mel - gt_mels).abs(), mel_masks)}
