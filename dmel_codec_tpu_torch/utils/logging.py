"""Rank-aware logging (the `RankedLogger` of `dmel_codec_tpu/utils/logging.py`)."""

from __future__ import annotations

import logging
from typing import Optional

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
