"""Length-mask helpers (port of `dmel_codec_tpu/utils/masks.py`)."""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """lengths [B] (or [1, B]) -> bool [B, max_length]."""
    lengths = lengths.reshape(-1)
    positions = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    return positions[None, :] < lengths[:, None]
