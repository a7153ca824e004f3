"""Rank-aware logging and metric writing (the `RankedLogger`, `plot_mel`
and `MetricsWriter` of `dmel_codec_tpu/utils/logging.py`). The writer's backend
is tensorboardX when importable, always mirrored to a metrics.jsonl for
machine consumption."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch.distributed as dist


class RankedLogger(logging.LoggerAdapter):
    """Prefixes [rank N] and (by default) only emits on process 0."""

    def __init__(
        self, name: str = __name__, rank_zero_only: bool = True, rank: Optional[int] = None
    ):
        super().__init__(logging.getLogger(name), {})
        self.rank_zero_only = rank_zero_only
        self._rank = rank

    @property
    def rank(self) -> int:
        if self._rank is not None:
            return self._rank
        return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0

    def log(self, level, msg, *args, **kwargs):
        if self.isEnabledFor(level):
            rank = self.rank
            if self.rank_zero_only and rank != 0:
                return
            msg, kwargs = self.process(f"[rank {rank}] {msg}", kwargs)
            self.logger.log(level, msg, *args, **kwargs)


def plot_mel(mels, titles=None):
    """List of [M, T] mel arrays -> stacked matplotlib figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(mels)
    fig, axes = plt.subplots(n, 1, squeeze=False, figsize=(10, 2.5 * n))
    for i, mel in enumerate(mels):
        axes[i][0].imshow(np.asarray(mel), origin="lower", aspect="auto", interpolation="none")
        if titles:
            axes[i][0].set_title(titles[i], fontsize="medium")
    fig.tight_layout()
    return fig


class MetricsWriter:
    """Scalars/figures/audio to TensorBoard (if available) + metrics.jsonl."""

    def __init__(self, log_dir: str, enable_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if enable_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except ImportError:
                pass

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec |= {k: float(v) for k, v in values.items()}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), int(step))

    def figure(self, step: int, tag: str, fig) -> None:
        if self._tb:
            self._tb.add_figure(tag, fig, int(step))

    def audio(self, step: int, tag: str, audio: np.ndarray, sample_rate: int) -> None:
        if self._tb:
            try:
                self._tb.add_audio(
                    tag, np.asarray(audio).reshape(-1, 1), int(step), sample_rate
                )
            except ImportError:
                pass  # tensorboardX audio needs soundfile; skip media only

    def close(self) -> None:
        self._jsonl.close()
        if self._tb:
            self._tb.close()


class NullWriter:
    """A `MetricsWriter` that writes nothing (the data-parallel ranks other
    than 0)."""

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        pass

    def figure(self, step: int, tag: str, fig) -> None:
        pass

    def audio(self, step: int, tag: str, audio: np.ndarray, sample_rate: int) -> None:
        pass

    def close(self) -> None:
        pass
