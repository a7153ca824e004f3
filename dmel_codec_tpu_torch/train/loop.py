"""Fit-loop settings (the `FitConfig` of `dmel_codec_tpu/train/loop.py`)."""

from __future__ import annotations

import dataclasses
from typing import Optional


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
