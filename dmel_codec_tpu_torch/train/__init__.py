"""Training: schedules, losses, checkpoints, the LM and codec trainers and
their fit loops."""

from dmel_codec_tpu_torch.train.schedule import cosine_schedule_with_warmup
from dmel_codec_tpu_torch.train.losses import adversarial_loss, discriminator_loss, weighted_mel_loss

__all__ = [
    "cosine_schedule_with_warmup",
    "discriminator_loss",
    "adversarial_loss",
    "weighted_mel_loss",
]
