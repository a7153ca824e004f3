"""Masks, precision, YAML configs, logging."""

from dmel_codec_tpu_torch.utils.masks import avg_with_mask, sequence_mask

__all__ = [
    "sequence_mask",
    "avg_with_mask",
]
