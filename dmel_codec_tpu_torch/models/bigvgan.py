"""BigVGAN vocoder, mel -> waveform (port of `dmel_codec_tpu/models/bigvgan.py`).

conv_pre (k7) -> N x [weight-norm transposed-conv upsample -> averaged
parallel AMPBlock1 resblocks] -> anti-aliased snake -> conv_post (k7) ->
clamp (or tanh). Module names are the reference generator's (conv_pre,
ups.{i}.0, resblocks.{n}.convs1/convs2/activations.{a}.act, activation_post,
conv_post), so `bigvgan_generator.pt` state_dict keys line up. The
reference's filter buffers are module constants here (ops/anti_alias.FILT).

Two forwards on the same weights:
  * `BigVGAN.forward` — the module form; every activation goes through
    ops/anti_alias (kernel K1 on the card);
  * `FusedBigVGAN` — the serving form (the JAX `bigvgan_apply_fused`):
    weight norm materialised once, and every stage with
    C <= fuse_max_channels runs its three resblocks as one fused stage
    (ops/stage_fused, kernel K2).
Input mel [B, T, num_mels], output waveform [B, T * prod(upsample_rates)].
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from dmel_codec_tpu_torch.nn.snake import SnakeBeta
from dmel_codec_tpu_torch.nn.weight_norm import WNConv1d, WNConvTranspose1d
from dmel_codec_tpu_torch.ops.anti_alias import anti_alias_activation
from dmel_codec_tpu_torch.ops.stage_fused import StageSpec, amp_stage, pack_stage


@dataclasses.dataclass(frozen=True)
class BigVGANConfig:
    """Defaults = the bigvgan_v2_24khz_100band_256x generator. Only the
    AMPBlock1 resblock is ported."""

    num_mels: int = 100
    upsample_rates: Tuple[int, ...] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"
    snake_logscale: bool = True
    use_bias_at_final: bool = False
    use_tanh_at_final: bool = False

    @property
    def num_kernels(self) -> int:
        return len(self.resblock_kernel_sizes)

    def stage_channels(self, i: int) -> int:
        return self.upsample_initial_channel // (2 ** (i + 1))


def _get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class AliasFreeActivation(nn.Module):
    """2x upsample -> snake/snakebeta -> 2x downsample per channel
    (the reference's Activation1d; parameters under `.act`)."""

    def __init__(self, channels: int, activation: str, logscale: bool):
        super().__init__()
        self.act = SnakeBeta(channels, activation, logscale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return anti_alias_activation(x, self.act.alpha, self.act.beta, self.act.logscale)


class AMPBlock1(nn.Module):
    """Dilated + plain conv pairs with anti-aliased snake before each conv."""

    def __init__(self, channels: int, kernel_size: int, dilation: Sequence[int], activation: str, logscale: bool):
        super().__init__()
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, d, _get_padding(kernel_size, d))
            for d in dilation
        )
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, 1, _get_padding(kernel_size, 1))
            for _ in dilation
        )
        self.activations = nn.ModuleList(
            AliasFreeActivation(channels, activation, logscale) for _ in range(2 * len(dilation))
        )

    def forward(self, x: torch.Tensor, weights: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """weights: the convs' materialised weights in (convs1[0], convs2[0],
        convs1[1], ...) order; computed from (v, g) when absent."""
        for j, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            w1, w2 = (c1.weight(), c2.weight()) if weights is None else weights[2 * j : 2 * j + 2]
            xt = self.activations[2 * j](x)
            xt = F.conv1d(xt, w1, c1.bias, padding=c1.padding, dilation=c1.dilation)
            xt = self.activations[2 * j + 1](xt)
            xt = F.conv1d(xt, w2, c2.bias, padding=c2.padding)
            x = x + xt
        return x


class BigVGAN(nn.Module):
    """mel [B, T, num_mels] -> waveform [B, T * prod(upsample_rates)]."""

    def __init__(self, config: BigVGANConfig = BigVGANConfig()):
        super().__init__()
        cfg = self.config = config
        ch0 = cfg.upsample_initial_channel
        self.conv_pre = WNConv1d(cfg.num_mels, ch0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch = cfg.stage_channels(i)
            self.ups.append(nn.ModuleList([WNConvTranspose1d(2 * ch, ch, k, u, (k - u) // 2)]))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(AMPBlock1(ch, rk, rd, cfg.activation, cfg.snake_logscale))
        ch = cfg.stage_channels(len(cfg.upsample_rates) - 1)
        self.activation_post = AliasFreeActivation(ch, cfg.activation, cfg.snake_logscale)
        self.conv_post = WNConv1d(ch, 1, 7, padding=3, bias=cfg.use_bias_at_final)

    def stage_blocks(self, i: int) -> Sequence[AMPBlock1]:
        nk = self.config.num_kernels
        return self.resblocks[i * nk : (i + 1) * nk]

    def _finish(self, x: torch.Tensor) -> torch.Tensor:
        if self.config.use_tanh_at_final:
            return torch.tanh(x)
        return torch.clamp(x, -1.0, 1.0)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up[0](x)
            blocks = self.stage_blocks(i)
            x = sum(blk(x) for blk in blocks) / len(blocks)
        x = self.conv_post(self.activation_post(x))[:, 0]
        return self._finish(x)


class FusedBigVGAN:
    """Serving forward of a BigVGAN (port of `bigvgan_apply_fused`).

    Built once per weight set: every conv's weight norm is materialised, and
    each stage with C <= fuse_max_channels is packed for the fused stage
    op (weights in the model's dtype). Same function as `BigVGAN.forward`.
    """

    @torch.no_grad()
    def __init__(self, model: BigVGAN, fuse_max_channels: int = 192):
        self.model = model
        cfg = model.config
        dtype = model.conv_pre.weight_v.dtype
        self.conv_pre = model.conv_pre.weight()
        self.conv_post = model.conv_post.weight()
        self.ups = [up[0].weight() for up in model.ups]
        self.stages = []  # per stage: (spec, packed) fused, or (None, weights) per-block
        for i in range(len(cfg.upsample_rates)):
            ch = cfg.stage_channels(i)
            blocks = model.stage_blocks(i)
            if ch <= fuse_max_channels:
                spec = StageSpec(
                    channels=ch,
                    kernel_sizes=tuple(cfg.resblock_kernel_sizes),
                    dilations=tuple(tuple(d) for d in cfg.resblock_dilation_sizes),
                    activation=cfg.activation,
                    logscale=cfg.snake_logscale,
                )
                packed = pack_stage(blocks, spec)
                packed["w"] = [w.to(dtype) for w in packed["w"]]
                self.stages.append((spec, packed))
            else:
                weights = [
                    [conv.weight() for pair in zip(b.convs1, b.convs2) for conv in pair]
                    for b in blocks
                ]
                self.stages.append((None, weights))

    @torch.no_grad()
    def pre(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T, num_mels] -> conv_pre output [B, C0, T]."""
        return F.conv1d(mel.transpose(1, 2), self.conv_pre, self.model.conv_pre.bias, padding=3)

    @torch.no_grad()
    def stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Upsample stage i: transposed conv, then the resblock group."""
        up = self.model.ups[i][0]
        x = F.conv_transpose1d(x, self.ups[i], up.bias, stride=up.stride, padding=up.padding)
        spec, arg = self.stages[i]
        if spec is not None:
            return amp_stage(x, arg, spec)
        blocks = self.model.stage_blocks(i)
        return sum(b(x, w) for b, w in zip(blocks, arg)) / len(blocks)

    @torch.no_grad()
    def post(self, x: torch.Tensor) -> torch.Tensor:
        m = self.model
        x = F.conv1d(m.activation_post(x), self.conv_post, m.conv_post.bias, padding=3)
        return m._finish(x[:, 0])

    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.pre(mel)
        for i in range(len(self.stages)):
            x = self.stage(i, x)
        return self.post(x)

