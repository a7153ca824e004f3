"""ConvNeXt-1D block and channel LayerNorm (port of `dmel_codec_tpu/nn/convnext.py`).

Depthwise k=7 conv -> LayerNorm (eps 1e-6) -> Linear x4 -> exact GELU ->
Linear -> layer-scale gamma -> residual, on channels-first [B, C, T], with
the reference's parameter names (dwconv, norm, pwconv1, pwconv2, gamma).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


class ConvNeXtBlock(nn.Module):
    def __init__(
        self,
        dim: int,
        mlp_ratio: float = 4.0,
        kernel_size: int = 7,
        layer_scale_init_value: float = 1e-6,
    ):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, kernel_size, padding=kernel_size // 2, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, int(mlp_ratio * dim))
        self.pwconv2 = nn.Linear(int(mlp_ratio * dim), dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dwconv(x).transpose(1, 2)  # [B, T, C]
        y = self.pwconv2(F.gelu(self.pwconv1(self.norm(y))))
        return x + (self.gamma * y).transpose(1, 2)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of [B, C, T], eps 1e-6 (fish-speech's
    `LayerNorm(data_format="channels_first")`; `dmel_codec_tpu/nn/convnext.py`)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=1, keepdim=True)
        var = (x - mean).square().mean(dim=1, keepdim=True)
        x = (x - mean) / torch.sqrt(var + self.eps)
        return self.weight[:, None] * x + self.bias[:, None]
