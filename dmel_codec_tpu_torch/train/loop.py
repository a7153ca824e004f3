"""Fit-loop settings and the codec's fit loop (the `FitConfig` and
`CodecFitLoop` of `dmel_codec_tpu/train/loop.py`).

Under a process group with `use_mesh` (the JAX meaning: a data-parallel
mesh) the loops run the trainers' data-parallel steps
(`parallel/mesh.py`): every rank steps on its own shard, in lockstep by
step count (a rank whose shard gives fewer batches per epoch starts its
next epoch sooner), validates on the whole validation set, and rank 0
alone writes the metrics and the checkpoints. Every rank restores the
newest checkpoint of `ckpt_dir`, which must be visible to all of them;
the ranks then check that they stand at the same step and take rank 0's
parameters."""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from dmel_codec_tpu_torch.parallel.mesh import DataParallel, data_parallel
from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
from dmel_codec_tpu_torch.train.codec_trainer import CodecTrainer, CodecTrainState
from dmel_codec_tpu_torch.utils.logging import MetricsWriter, NullWriter, RankedLogger, plot_mel

log = RankedLogger(__name__)


@dataclasses.dataclass(frozen=True)
class FitConfig:
    max_steps: int = 1_000_000
    val_interval: int = 2000
    log_every: int = 50
    ckpt_dir: str = "checkpoints"
    log_dir: str = "tb_logs"
    keep_checkpoints: int = 2
    # Metric-ranked retention. None keeps the k newest; "val_loss" (codec) /
    # "val/audio_loss" (LM) keeps the k best.
    best_metric: Optional[str] = None
    best_mode: str = "min"
    seed: int = 0
    max_val_batches: int = 4
    # data-parallel steps when a process group is up
    use_mesh: bool = True


def epoch_batches(batches: Iterable[dict], epoch: int) -> Iterable[dict]:
    """The epoch's batches; raises when there is none (the loop would spin
    without stepping, and its data-parallel peers would wait for it)."""
    empty = True
    for batch in batches:
        empty = False
        yield batch
    if empty:
        raise RuntimeError(f"epoch {epoch} gave no training batch (an empty manifest or shard)")


def start_replicated(dp: Optional[DataParallel], step: int, tensors: Iterable[torch.Tensor]) -> None:
    """Data parallelism starts from one state: every rank at the same step,
    with rank 0's parameters."""
    if dp is not None:
        dp.same_step(step)
        dp.broadcast_(list(tensors))


class CodecFitLoop:
    """Data loader -> codec train step -> metrics / checkpoints / validation
    (the `CodecFitLoop` of `dmel_codec_tpu/train/loop.py`), data-parallel
    under a process group (module docstring). Resumes from the newest
    checkpoint; validation and the checkpoint share one cadence, and the
    validation metrics rank the checkpoint."""

    def __init__(
        self,
        trainer: CodecTrainer,
        train_batches: Callable[[int], Iterable[dict]],
        val_batches: Optional[Callable[[], Iterable[dict]]] = None,
        fit_config: FitConfig = FitConfig(),
        vocoder_apply: Optional[Callable] = None,
    ):
        """train_batches(epoch) / val_batches() yield host batches
        {'audios' [B, L], 'audio_lengths' [B], ...}. vocoder_apply: mel
        [B, T, M] tensor -> wave [B, L] tensor (a frozen BigVGAN), used for
        the validation media. The loop runs on the trainer's device."""
        self.trainer = trainer
        self.train_batches = train_batches
        self.val_batches = val_batches
        self.cfg = fit_config
        self.vocoder_apply = vocoder_apply
        self._warned_no_figure = False

    def _generator(self, seed: int, step: int = 0, dp: Optional[DataParallel] = None) -> torch.Generator:
        """The noise generator for one step, keyed like `jax.random.fold_in`:
        the same (seed, step) draws the same noise, resumed or not; under
        data parallelism each rank draws its own (the key takes the rank
        too, and is the single-process key at world size 1)."""
        key = seed * 1_000_003 + step
        if dp is not None:
            key = key * dp.world + dp.rank
        return torch.Generator(device=self.trainer.device).manual_seed(key)

    def run(self, state: Optional[CodecTrainState] = None) -> CodecTrainState:
        cfg = self.cfg
        trainer = self.trainer
        dp = trainer.data_parallel = data_parallel(cfg.use_mesh)
        is_main = dp is None or dp.is_main
        writer = MetricsWriter(cfg.log_dir) if is_main else NullWriter()
        ckpt = CheckpointManager(
            cfg.ckpt_dir,
            max_to_keep=cfg.keep_checkpoints,
            best_metric=cfg.best_metric,
            best_mode=cfg.best_mode,
        )
        if state is None:
            state = trainer.init_state(cfg.seed)
        if ckpt.restore_latest(state) is not None:
            log.info(f"resumed from checkpoint step {state.step}")
        start_replicated(dp, state.step, [*state.gen_params.values(), *state.disc_params.values()])

        step = state.step
        epoch = 0
        try:
            while step < cfg.max_steps:
                for batch in epoch_batches(self.train_batches(epoch), epoch):
                    state, metrics = trainer.train_step(
                        state, trainer.device_batch(batch), self._generator(cfg.seed + 1, step, dp)
                    )
                    step = state.step
                    if step % cfg.log_every == 0:
                        writer.scalars(step, {k: float(v) for k, v in metrics.items()})
                    if step % cfg.val_interval == 0:
                        val_metrics = None
                        if self.val_batches is not None:
                            val_metrics = self._validate(state, writer, step)
                        if is_main:
                            ckpt.save(step, state, metrics=val_metrics)
                    if step >= cfg.max_steps:
                        break
                epoch += 1
            if is_main and ckpt.latest_step() != step:
                ckpt.save(step, state)
            ckpt.wait()
            if dp is not None:
                dp.barrier()  # every rank returns once the last checkpoint is written
        finally:
            writer.close()
            ckpt.close()
        return state

    def _validate(self, state: CodecTrainState, writer: MetricsWriter, step: int) -> Optional[dict]:
        """Mean `val_loss` over the first `max_val_batches` validation
        batches, and the media of the first one's first clip. Every rank
        takes the whole validation set, outside the data-parallel step."""
        cfg = self.cfg
        losses = []
        first_batch = None
        for i, batch in enumerate(self.val_batches()):
            if i >= cfg.max_val_batches:
                break
            db = self.trainer.device_batch(batch)
            out = self.trainer.eval_step(state, db, self._generator(cfg.seed + 2 + i))
            losses.append(float(out["val_loss"]))
            if first_batch is None:
                first_batch = db
        metrics = None
        if losses:
            metrics = {"val_loss": float(np.mean(losses))}
            writer.scalars(step, metrics)
            log.info(f"step {step}: val_loss {metrics['val_loss']:.4f}")
        if first_batch is not None:
            self._log_media(state, writer, step, first_batch)
        return metrics

    @torch.no_grad()
    def _log_media(self, state: CodecTrainState, writer: MetricsWriter, step: int, batch: dict) -> None:
        """Mel figure and audio clips for sample 0."""
        trainer = self.trainer
        audios = batch["audios"][:1].float()
        lengths = batch["audio_lengths"][:1]
        encode_mels, gt_mels, mel_masks, _ = trainer._prepare(audios, lengths)
        quality = torch.full((1, 1), 2.0, device=audios.device)
        gen_mel, _ = trainer.codec(encode_mels, mel_masks, quality, generator=self._generator(0))
        n = int(lengths[0])
        mel_len = n // trainer.mel_transform.hop_length
        try:
            fig = plot_mel(
                [gt_mels[0, :mel_len].T.cpu().numpy(), gen_mel[0, :mel_len].T.cpu().numpy()],
                ["Ground-Truth", "Auxiliary"],
            )
        except ImportError:
            fig = None  # no matplotlib here: the audio clips are still logged
            if not self._warned_no_figure:
                log.warning("matplotlib is not installed: the mel figure 'sample-0/mels' is skipped, the audio clips are logged")
                self._warned_no_figure = True
        else:
            writer.figure(step, "sample-0/mels", fig)
        sr = trainer.codec_config.sample_rate
        writer.audio(step, "sample-0/wavs/gt", audios[0, :n].cpu().numpy(), sr)
        if self.vocoder_apply is not None:
            gen_wav = self.vocoder_apply(gen_mel)
            writer.audio(step, "sample-0/wavs/gen", gen_wav[0, :n].float().cpu().numpy(), sr)
        if fig is not None:
            import matplotlib.pyplot as plt

            plt.close(fig)
