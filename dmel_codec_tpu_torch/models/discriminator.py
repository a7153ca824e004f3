"""Mel-spectrogram image discriminator, the LSGAN critic of codec training
(port of `dmel_codec_tpu/models/discriminator.py`).

One 2-D conv pyramid (1 -> 64 -> 128 -> 256 -> 512 -> 1024 -> 1 channels)
over the mel "image", weight-normalised convs, SiLU between layers, stride 2
over the time axis only. The public layout is the JAX package's: mel
[B, T, M] in, logits [B, M', T'] out; inside, the image is [B, 1, M, T].
Parameter names follow the original torch reference: `blocks.{0, 2, .., 10}`
are the convs of one Sequential whose odd positions are the SiLUs.
"""

from __future__ import annotations

import torch
from torch import nn

from dmel_codec_tpu_torch.nn.weight_norm import WNConv2d

# (features, kernel (mel, time), strides (mel, time), padding (mel, time))
SPECS = (
    (64, (3, 9), (1, 1), (1, 4)),
    (128, (3, 9), (1, 2), (1, 4)),
    (256, (3, 9), (1, 2), (1, 4)),
    (512, (3, 9), (1, 2), (1, 4)),
    (1024, (3, 3), (1, 1), (1, 1)),
    (1, (3, 3), (1, 1), (1, 1)),
)


class MelDiscriminator(nn.Module):
    def __init__(self):
        super().__init__()
        channels = (1,) + tuple(spec[0] for spec in SPECS)
        layers = []
        for i, (features, kernel, strides, padding) in enumerate(SPECS):
            layers += [WNConv2d(channels[i], features, kernel, strides, padding), nn.SiLU()]
        self.blocks = nn.Sequential(*layers[:-1])

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T, M] -> logits [B, M', T']."""
        return self.blocks(mel.transpose(1, 2)[:, None])[:, 0]  # the image is [B, 1, M, T]
