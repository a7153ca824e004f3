"""WaveNet encoder/decoder stack (port of `dmel_codec_tpu/nn/wavenet.py`).

Channels-first [B, C, T], with the original torch reference's module names
(models/modules/wavenet.py): every projection is a 1x1 `ConvNorm`, so the
reference's state_dict keys (`residual_layers.{i}.conv_layer.conv.weight`,
...) load directly. Gated unit = sigmoid(first half) * tanh(second half);
the residual is scaled by 1/sqrt(2) and the skip sum by 1/sqrt(L).

The diffusion-step pathway (`is_diffusion`, the step `t`) is here as in the
JAX package, for API completeness: no codec config uses it. Its bias-free
projections are `nn.Linear`s named after the flax ones (`mlp_0`, `mlp_1`,
each block's `diffusion_projection`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F


def _init(layer: nn.Module) -> nn.Module:
    # the JAX package's truncated_normal(stddev=0.02), zero bias
    nn.init.trunc_normal_(layer.weight, std=0.02, a=-0.04, b=0.04)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)
    return layer


def diffusion_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal step embedding (reference DiffusionEmbedding). t [B] -> [B, dim]."""
    half = dim // 2
    k = torch.arange(half, device=t.device, dtype=torch.float32)
    freqs = torch.exp(math.log(10000.0) / (half - 1) * -k)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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
    def __init__(
        self,
        residual_channels: int,
        dilation: int,
        condition_channels: Optional[int],
        is_diffusion: bool = False,
    ):
        super().__init__()
        c = residual_channels
        self.diffusion_projection = _init(nn.Linear(c, c, bias=False)) if is_diffusion else None
        self.conv_layer = ConvNorm(c, 2 * c, kernel_size=3, dilation=dilation)
        self.condition_projection = (
            ConvNorm(condition_channels, 2 * c) if condition_channels is not None else None
        )
        self.output_projection = ConvNorm(c, 2 * c)

    def forward(
        self,
        x: torch.Tensor,
        condition: Optional[torch.Tensor] = None,
        diffusion_step: Optional[torch.Tensor] = None,
    ):
        y = x
        if diffusion_step is not None:
            y = y + self.diffusion_projection(diffusion_step)[:, :, None]
        y = self.conv_layer(y)
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
        is_diffusion: bool = False,
    ):
        super().__init__()
        c = residual_channels
        self.n_layers = residual_layers
        self.is_diffusion = is_diffusion
        if is_diffusion:
            self.mlp_0 = _init(nn.Linear(c, 4 * c, bias=False))
            self.mlp_1 = _init(nn.Linear(4 * c, c, bias=False))
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
                is_diffusion,
            )
            for i in range(residual_layers)
        )
        self.skip_projection = ConvNorm(c, c)
        self.output_projection = (
            ConvNorm(c, output_channels)
            if output_channels is not None and output_channels != c
            else None
        )

    def forward(
        self,
        x: torch.Tensor,
        condition: Optional[torch.Tensor] = None,
        t: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if self.input_projection is not None:
            x = F.silu(self.input_projection(x))
        step = None
        if t is not None:
            if not self.is_diffusion:
                raise ValueError("pass is_diffusion=True to use t")
            step = diffusion_embedding(t, self.mlp_0.in_features)
            step = self.mlp_1(F.mish(self.mlp_0(step)))
        skip_sum = None
        for layer in self.residual_layers:
            x, skip = layer(x, condition, step)
            skip_sum = skip if skip_sum is None else skip_sum + skip
        y = self.skip_projection(skip_sum / math.sqrt(self.n_layers))
        if self.output_projection is not None:
            y = self.output_projection(F.silu(y))
        return y
