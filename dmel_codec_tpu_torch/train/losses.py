"""GAN and reconstruction losses of codec training (port of
`dmel_codec_tpu/train/losses.py`): LSGAN real / fake objectives, the masked
band-weighted L1 mel loss (low 0.6 / mid 0.3 / high 0.1, halved, plus half
the full band), and nearest-neighbour mask resampling onto the
discriminator's strided time axis.

Layout: mels [B, T, M]; masks [B, T, 1]; discriminator logits [B, M', T'].
"""

from __future__ import annotations

from typing import Tuple

import torch

from dmel_codec_tpu_torch.utils.masks import avg_with_mask


def resample_mask_nearest(mel_masks: torch.Tensor, target_len: int) -> torch.Tensor:
    """[B, T, 1] -> [B, 1, T'] by the integer index (i * T) // T' (exact,
    where a float index could round the other way)."""
    t = mel_masks.shape[1]
    idx = (torch.arange(target_len, device=mel_masks.device) * t) // target_len
    return mel_masks[:, idx, 0][:, None, :]


def discriminator_loss(
    real_logits: torch.Tensor, fake_logits: torch.Tensor, d_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LSGAN critic loss. Returns (total, loss_real, loss_fake)."""
    loss_real = avg_with_mask((real_logits - 1.0) ** 2, d_mask)
    loss_fake = avg_with_mask(fake_logits**2, d_mask)
    return loss_real + loss_fake, loss_real, loss_fake


def adversarial_loss(fake_logits: torch.Tensor, d_mask: torch.Tensor) -> torch.Tensor:
    """LSGAN generator objective."""
    return avg_with_mask((fake_logits - 1.0) ** 2, d_mask)


def weighted_mel_loss(
    gen_mel: torch.Tensor, gt_mel: torch.Tensor, mel_masks: torch.Tensor
) -> torch.Tensor:
    """Band-weighted masked L1: bands split at mel 40 and 70."""
    dist = (gen_mel - gt_mel).abs()
    low = avg_with_mask(dist[..., :40], mel_masks)
    mid = avg_with_mask(dist[..., 40:70], mel_masks)
    high = avg_with_mask(dist[..., 70:], mel_masks)
    full = avg_with_mask(dist, mel_masks)
    return (low * 0.6 + mid * 0.3 + high * 0.1) * 0.5 + full * 0.5
