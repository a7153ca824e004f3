"""Length-mask helpers (port of `dmel_codec_tpu/utils/masks.py`)."""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """lengths [B] (or [1, B]) -> bool [B, max_length]."""
    lengths = lengths.reshape(-1)
    positions = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    return positions[None, :] < lengths[:, None]


def avg_with_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over positions where mask == 1; mask broadcasts against x,
    and the denominator counts every element of x it covers. Inside a
    data-parallel step (`parallel.mesh.global_batch`) the denominator counts
    the positions of every rank: this rank's share of the global mean."""
    # imported here: `parallel` imports the models, which import this module
    from dmel_codec_tpu_torch.parallel.mesh import global_count

    bmask = mask.to(x.dtype).expand_as(x)
    return (x * bmask).sum() / global_count(bmask.sum())
