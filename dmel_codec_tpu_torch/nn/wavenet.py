"""WaveNet encoder/decoder stack (port of `dmel_codec_tpu/nn/wavenet.py`).

Channels-first [B, C, T], with the original torch reference's module names
(models/modules/wavenet.py): every projection is a 1x1 `ConvNorm`, so the
reference's state_dict keys (`residual_layers.{i}.conv_layer.conv.weight`,
...) load directly. Gated unit = sigmoid(first half) * tanh(second half);
the residual is scaled by 1/sqrt(2) and the skip sum by 1/sqrt(L). The
diffusion-step pathway is not ported: no codec config uses it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F


def _init(conv: nn.Conv1d) -> nn.Conv1d:
    # the JAX package's truncated_normal(stddev=0.02), zero bias
    nn.init.trunc_normal_(conv.weight, std=0.02, a=-0.04, b=0.04)
    nn.init.zeros_(conv.bias)
    return conv


class ConvNorm(nn.Module):
    """Conv1d wrapper kept for the reference's `<name>.conv.weight` keys."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1, dilation: int = 1):
        super().__init__()
        padding = dilation * (kernel_size - 1) // 2
        self.conv = _init(
            nn.Conv1d(in_ch, out_ch, kernel_size, dilation=dilation, padding=padding)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ResidualBlock(nn.Module):
    def __init__(self, residual_channels: int, dilation: int, condition_channels: Optional[int]):
        super().__init__()
        c = residual_channels
        self.conv_layer = ConvNorm(c, 2 * c, kernel_size=3, dilation=dilation)
        self.condition_projection = (
            ConvNorm(condition_channels, 2 * c) if condition_channels is not None else None
        )
        self.output_projection = ConvNorm(c, 2 * c)

    def forward(self, x: torch.Tensor, condition: Optional[torch.Tensor] = None):
        y = self.conv_layer(x)
        if self.condition_projection is not None:
            y = y + self.condition_projection(condition)
        gate, filt = torch.chunk(y, 2, dim=1)
        y = torch.sigmoid(gate) * torch.tanh(filt)
        residual, skip = torch.chunk(self.output_projection(y), 2, dim=1)
        return (x + residual) / math.sqrt(2.0), skip


class WaveNet(nn.Module):
    """[B, C_in, T] -> [B, C_out, T]."""

    def __init__(
        self,
        input_channels: Optional[int] = None,
        output_channels: Optional[int] = None,
        residual_channels: int = 512,
        residual_layers: int = 20,
        dilation_cycle: Optional[int] = 4,
        condition_channels: Optional[int] = None,
    ):
        super().__init__()
        c = residual_channels
        self.n_layers = residual_layers
        self.input_projection = (
            ConvNorm(input_channels, c)
            if input_channels is not None and input_channels != c
            else None
        )
        self.residual_layers = nn.ModuleList(
            ResidualBlock(
                c,
                2 ** (i % dilation_cycle) if dilation_cycle else 1,
                condition_channels,
            )
            for i in range(residual_layers)
        )
        self.skip_projection = ConvNorm(c, c)
        self.output_projection = (
            ConvNorm(c, output_channels)
            if output_channels is not None and output_channels != c
            else None
        )

    def forward(self, x: torch.Tensor, condition: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.input_projection is not None:
            x = F.silu(self.input_projection(x))
        skip_sum = None
        for layer in self.residual_layers:
            x, skip = layer(x, condition)
            skip_sum = skip if skip_sum is None else skip_sum + skip
        y = self.skip_projection(skip_sum / math.sqrt(self.n_layers))
        if self.output_projection is not None:
            y = self.output_projection(F.silu(y))
        return y
