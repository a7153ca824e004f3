"""Plain reference of the BigVGAN v2 generator (mel -> waveform).

Stands for `dmel_codec_tpu_torch/models/bigvgan.py` (`BigVGAN.forward`, and
`FusedBigVGAN`, the serving form that computes the same function with kernels
K1 and K2), `nn/weight_norm.py`, `nn/snake.py`, `nn/resample.py` and
`ops/stage_fused.py`'s stage (the JAX package's `bigvgan_apply_fused`),
after NVIDIA's `bigvgan_v2_24khz_100band_256x` generator: weight-normed
conv_pre (k7), per stage a weight-normed transposed conv and the mean of
three AMP resblocks (anti-aliased SnakeBeta before each conv), anti-aliased
SnakeBeta, conv_post (k7), clamp to [-1, 1]. Weight norm and the snake's
coefficients are worked out here from the raw parameters.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def stage_channels(cfg: dict, i: int) -> int:
    return cfg["upsample_initial_channel"] // (2 ** (i + 1))


def param_shapes(cfg: dict) -> "OrderedDict[str, tuple]":
    """Every parameter of the generator, by checkpoint name (weight norm's
    `weight_v` / `weight_g`), in a fixed order."""
    out = []

    def wn(name, shape, bias=True):
        out.extend([(f"{name}.weight_v", shape), (f"{name}.weight_g", (shape[0],) + (1,) * (len(shape) - 1))])
        if bias:
            out.append((f"{name}.bias", (shape[0] if "ups." not in name else shape[1],)))

    c0 = cfg["upsample_initial_channel"]
    wn("conv_pre", (c0, cfg["num_mels"], 7))
    n = 0
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        ch = stage_channels(cfg, i)
        wn(f"ups.{i}.0", (2 * ch, ch, k))
        for rk, rd in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]):
            for j in range(len(rd)):
                wn(f"resblocks.{n}.convs1.{j}", (ch, ch, rk))
            for j in range(len(rd)):
                wn(f"resblocks.{n}.convs2.{j}", (ch, ch, rk))
            for a in range(2 * len(rd)):
                out.extend([(f"resblocks.{n}.activations.{a}.act.alpha", (ch,)),
                            (f"resblocks.{n}.activations.{a}.act.beta", (ch,))])
            n += 1
    ch = stage_channels(cfg, len(cfg["upsample_rates"]) - 1)
    out.extend([("activation_post.act.alpha", (ch,)), ("activation_post.act.beta", (ch,))])
    wn("conv_post", (1, ch, 7), bias=cfg["use_bias_at_final"])
    return OrderedDict(out)


def weight(p: Params, name: str) -> torch.Tensor:
    """g * v / ||v||, the norm over every axis but the first."""
    v, g = p[f"{name}.weight_v"], p[f"{name}.weight_g"]
    return g * v / v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()


def kaiser_sinc(cutoff: float = 0.25, half_width: float = 0.3, size: int = 12) -> np.ndarray:
    """The 12-tap Kaiser-windowed sinc low-pass of the alias-free
    activation (BigVGAN's alias_free_activation/torch/filter.py)."""
    half = size // 2
    a = 2.285 * (half - 1) * math.pi * 4 * half_width + 7.95
    beta = 0.1102 * (a - 8.7) if a > 50.0 else (0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0) if a >= 21.0 else 0.0)
    time = np.arange(-half, half) + 0.5
    filt = 2 * cutoff * np.kaiser(size, beta) * np.sinc(2 * cutoff * time)
    return (filt / filt.sum()).astype(np.float32)


def alias_free_snake(x: torch.Tensor, log_alpha: torch.Tensor, log_beta: torch.Tensor) -> torch.Tensor:
    """2x up (replicate pad 5, transposed depthwise FIR, crop 15 / 15) ->
    SnakeBeta x + sin^2(a x) / (b + 1e-9), a = exp(alpha), b = exp(beta) ->
    2x down (replicate pad 5 / 6, depthwise FIR, stride 2), in float32."""
    c = x.shape[1]
    filt = torch.from_numpy(kaiser_sinc()).to(x.device)[None, None, :].expand(c, 1, 12)
    up = 2 * F.conv_transpose1d(F.pad(x, (5, 5), mode="replicate"), filt, stride=2, groups=c)[..., 15:-15]
    a, b = torch.exp(log_alpha.float())[:, None], torch.exp(log_beta.float())[:, None]
    s = torch.sin(up * a)
    v = up + (1.0 / (b + 1e-9)) * s * s
    return F.conv1d(F.pad(v, (5, 6), mode="replicate"), filt, stride=2, groups=c)


def _resblock(p: Params, cfg: dict, n: int, x: torch.Tensor, k: int, dils) -> torch.Tensor:
    act = f"resblocks.{n}.activations"
    for j, d in enumerate(dils):
        c1, c2 = f"resblocks.{n}.convs1.{j}", f"resblocks.{n}.convs2.{j}"
        xt = alias_free_snake(x, p[f"{act}.{2 * j}.act.alpha"], p[f"{act}.{2 * j}.act.beta"])
        xt = F.conv1d(xt, weight(p, c1), p[f"{c1}.bias"], padding=d * (k - 1) // 2, dilation=d)
        xt = alias_free_snake(xt, p[f"{act}.{2 * j + 1}.act.alpha"], p[f"{act}.{2 * j + 1}.act.beta"])
        x = x + F.conv1d(xt, weight(p, c2), p[f"{c2}.bias"], padding=(k - 1) // 2)
    return x


def stage(p: Params, cfg: dict, i: int, x: torch.Tensor) -> torch.Tensor:
    """Upsample stage i: the transposed conv, then the mean of its three
    resblocks."""
    u, k = cfg["upsample_rates"][i], cfg["upsample_kernel_sizes"][i]
    x = F.conv_transpose1d(x, weight(p, f"ups.{i}.0"), p[f"ups.{i}.0.bias"], stride=u, padding=(k - u) // 2)
    nk = len(cfg["resblock_kernel_sizes"])
    blocks = [_resblock(p, cfg, i * nk + j, x, rk, rd)
              for j, (rk, rd) in enumerate(zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]))]
    return sum(blocks) / nk


def vocode(p: Params, cfg: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T, num_mels] -> waveform [B, T * prod(upsample_rates)], float32."""
    x = F.conv1d(mel.float().transpose(1, 2), weight(p, "conv_pre"), p["conv_pre.bias"], padding=3)
    for i in range(len(cfg["upsample_rates"])):
        x = stage(p, cfg, i, x)
    x = alias_free_snake(x, p["activation_post.act.alpha"], p["activation_post.act.beta"])
    x = F.conv1d(x, weight(p, "conv_post"), p.get("conv_post.bias"), padding=3)[:, 0]
    return torch.tanh(x) if cfg["use_tanh_at_final"] else torch.clamp(x, -1.0, 1.0)
