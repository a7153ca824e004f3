"""LM fit loop: token-grid batches -> LM train step (port of
`dmel_codec_tpu/train/lm_loop.py`); data-parallel under a process group with
`use_mesh`, as `train/loop.py` describes."""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from dmel_codec_tpu_torch.parallel.mesh import data_parallel
from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
from dmel_codec_tpu_torch.train.lm_trainer import LMTrainer, LMTrainState, LoRATrainState
from dmel_codec_tpu_torch.train.lora import lora_leaves
from dmel_codec_tpu_torch.train.loop import FitConfig, epoch_batches, start_replicated
from dmel_codec_tpu_torch.utils.logging import MetricsWriter, NullWriter, RankedLogger

log = RankedLogger(__name__)


class LMFitLoop:
    def __init__(
        self,
        trainer: LMTrainer,
        train_batches: Callable[[int], Iterable[dict]],
        val_batches: Optional[Callable[[], Iterable[dict]]] = None,
        fit_config: FitConfig = FitConfig(),
        device="cuda",
    ):
        """train_batches(epoch) / val_batches() yield host token-grid
        batches (lm/data.lm_batch_from_audio). `device` is where the steps
        run; the trainer must have been built on it."""
        self.trainer = trainer
        self.train_batches = train_batches
        self.val_batches = val_batches
        self.cfg = fit_config
        self.device = torch.device(device)
        if self.device.type != trainer.device.type:
            raise ValueError(f"the loop runs on {self.device} but the trainer was built on {trainer.device}")

    def run(self, state: Optional[LMTrainState] = None) -> LMTrainState:
        cfg = self.cfg
        dp = self.trainer.data_parallel = data_parallel(cfg.use_mesh)
        is_main = dp is None or dp.is_main
        writer = MetricsWriter(cfg.log_dir) if is_main else NullWriter()
        ckpt = CheckpointManager(
            cfg.ckpt_dir,
            max_to_keep=cfg.keep_checkpoints,
            best_metric=cfg.best_metric,
            best_mode=cfg.best_mode,
        )

        if state is None:
            state = self.trainer.init_state(cfg.seed)
        if ckpt.restore_latest(state) is not None:
            log.info(f"resumed from checkpoint step {state.step}")

        # LoRA finetune states train through the adapter-only step; the
        # checkpoints they produce contain base + adapters (restoring just
        # the `lora` field is a LoRA-only checkpoint)
        is_lora = isinstance(state, LoRATrainState)
        step_fn = self.trainer.lora_train_step if is_lora else self.trainer.train_step
        if is_lora:
            start_replicated(dp, state.step, [*state.base_params.values(), *lora_leaves(state.lora).values()])
        else:
            start_replicated(dp, state.step, state.params.values())

        step = state.step
        epoch = 0
        try:
            while step < cfg.max_steps:
                for batch in epoch_batches(self.train_batches(epoch), epoch):
                    state, metrics = step_fn(state, self.trainer.device_batch(batch))
                    step = state.step
                    if step % cfg.log_every == 0:
                        writer.scalars(step, {k: float(v) for k, v in metrics.items()})
                    if step % cfg.val_interval == 0:
                        val_means = None
                        if self.val_batches is not None:
                            val_means = self._validate(state, is_lora)
                            if val_means:
                                writer.scalars(step, val_means)
                                log.info(
                                    f"step {step}: val loss {val_means['val/audio_loss']:.4f} "
                                    f"top1 {val_means.get('val/audio_top1_acc', 0.0):.3f}"
                                )
                        # checkpoint cadence == val cadence; val metrics rank it
                        if is_main:
                            ckpt.save(step, state, metrics=val_means)
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

    def _validate(self, state, is_lora: bool) -> Optional[dict]:
        """Means of the losses and top-k accuracies over the first
        `max_val_batches` validation batches; None when there is none."""
        params = self.trainer.merged_lora_params(state) if is_lora else state.params
        sums: dict = {}
        count = 0
        for i, vb in enumerate(self.val_batches()):
            if i >= self.cfg.max_val_batches:
                break
            m = self.trainer.eval_metrics(params, self.trainer.device_batch(vb))
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
        return {k: v / count for k, v in sums.items()} if count else None
