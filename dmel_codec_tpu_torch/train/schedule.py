"""LR schedules as plain functions of the step (port of
`dmel_codec_tpu/train/schedule.py`)."""

from __future__ import annotations

import math
from typing import Callable

import torch


def cosine_schedule_with_warmup(
    base_lr: float,
    num_warmup_steps: int | float,
    num_training_steps: int,
    num_cycles: float = 0.5,
    final_lr_ratio: float = 0.0,
) -> Callable[[int], float]:
    """Returns schedule(step) -> lr: linear warmup, then a cosine with a
    final-ratio floor. A float warmup in (0, 1) is a fraction of the total
    steps."""
    if 0 < num_warmup_steps < 1:
        num_warmup_steps = int(num_warmup_steps * num_training_steps)

    def schedule(step: int) -> float:
        if step < num_warmup_steps:
            return base_lr * step / max(1, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(1, num_training_steps - num_warmup_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress))
        return base_lr * max(final_lr_ratio, cosine)

    return schedule


def lambda_lr(
    optimizer: torch.optim.Optimizer, schedule: Callable[[int], float], base_lr: float
) -> torch.optim.lr_scheduler.LambdaLR:
    """`schedule` as a LambdaLR over an optimizer whose groups were built
    with lr = base_lr (LambdaLR multiplies the initial lr by the factor)."""
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: schedule(step) / base_lr)
