"""Weight-normalised convolutions (port of `dmel_codec_tpu/nn/weight_norm.py`).

Parameters use torch's classic weight_norm names (`weight_v`, `weight_g`,
`bias`), which the JAX package's BigVGAN converter reads
(models/bigvgan.py `_wn_pair`). Norm over every axis but dim 0 of the torch
layout:
  * Conv1d          [out, in, k] -> one g per OUTPUT channel
  * Conv2d          [out, in, k_h, k_w] -> one g per OUTPUT channel
  * ConvTranspose1d [in, out, k] -> one g per INPUT channel
`weight()` materialises g * v / ||v|| in the parameters' dtype, op by op
as the JAX `weight_norm_kernel` does (a bf16 model gets the JAX package's
bf16 weights); the serving vocoder calls it once per conv.
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F


def weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    norm = (v * v).sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return g.reshape(norm.shape) * v / norm


class _WeightNormed(nn.Module):
    def __init__(self, shape, fan_in: int, bias_ch: int, bias: bool):
        super().__init__()
        # the JAX package's lecun_normal init, with g = ||v|| (identity at init)
        v = torch.randn(shape) / math.sqrt(fan_in)
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(
            v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
        )
        self.bias = nn.Parameter(torch.zeros(bias_ch)) if bias else None

    def weight(self) -> torch.Tensor:
        return weight_norm(self.weight_v, self.weight_g)


class WNConv1d(_WeightNormed):
    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        kernel_size: int,
        dilation: int = 1,
        padding: int = 0,
        bias: bool = True,
    ):
        super().__init__((out_ch, in_ch, kernel_size), in_ch * kernel_size, out_ch, bias)
        self.dilation = dilation
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(
            x, self.weight(), self.bias, padding=self.padding, dilation=self.dilation
        )


class WNConvTranspose1d(_WeightNormed):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int, padding: int = 0):
        super().__init__((in_ch, out_ch, kernel_size), in_ch * kernel_size, out_ch, True)
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(
            x, self.weight(), self.bias, stride=self.stride, padding=self.padding
        )


class WNConv2d(_WeightNormed):
    """2-D weight-normalised conv on [B, C, H, W]; `weight_v`
    [out, in, k_h, k_w], one g per output channel, symmetric padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=(1, 1), padding=(0, 0)):
        k_h, k_w = kernel_size
        super().__init__((out_ch, in_ch, k_h, k_w), in_ch * k_h * k_w, out_ch, True)
        self.stride = tuple(stride)
        self.padding = tuple(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight(), self.bias, stride=self.stride, padding=self.padding)
