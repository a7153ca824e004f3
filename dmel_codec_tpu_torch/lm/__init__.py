"""Slow-fast LM host code: token grids, tokenizer, sampling, generation."""

from dmel_codec_tpu_torch.lm.inputs import TokenGridBuilder, pad_grids_to_batch
from dmel_codec_tpu_torch.lm.sampling import logits_to_probs, sample_token

__all__ = [
    "TokenGridBuilder",
    "pad_grids_to_batch",
    "sample_token",
    "logits_to_probs",
]
