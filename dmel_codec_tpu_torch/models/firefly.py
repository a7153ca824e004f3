"""Firefly (fish-speech) codec: ConvNeXt encoder + downsample-FSQ + HiFiGAN
head (port of `dmel_codec_tpu/models/firefly.py`).

  * ResBlock1: SiLU -> dilated WN conv -> SiLU -> WN conv, x3
  * ParallelBlock: mean over kernel-size-parallel ResBlock1s
  * HiFiGANGenerator: WN conv_pre -> N x [SiLU -> WN transposed conv
    (+ optional template noise conv) -> ParallelBlock] -> SiLU ->
    WN conv_post -> tanh
  * ConvNeXtEncoder: stem conv + LN, LN + 1x1 mid layers, ConvNeXt stages,
    final LN
  * FireflyGAN: the firefly-gan-base vocoder (ConvNeXt backbone + HiFiGAN
    head) on the public mel layout [B, T, 128]
  * FireflyArchitecture: the fish-speech codec (log-mel -> ConvNeXt backbone
    -> downsample-FSQ tokens -> HiFiGAN waveform head) with the encode /
    decode surface the reference's evaluation drives

The modules carry fish-speech's names ("generator."-stripped checkpoint
keys: `backbone.downsample_layers.*`, `backbone.stages.*`, `head.conv_pre`,
`head.ups.*`, `head.resblocks.*.blocks.*.convs1.*`, `quantizer.*`), so the
JAX package's `firefly_architecture_params_from_torch` reads the
`state_dict()`. Convs run channels-first [B, C, T].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from dmel_codec_tpu_torch.dsp.spectrogram import LogMelSpectrogram
from dmel_codec_tpu_torch.nn.convnext import ChannelLayerNorm, ConvNeXtBlock
from dmel_codec_tpu_torch.nn.weight_norm import WNConv1d, WNConvTranspose1d
from dmel_codec_tpu_torch.quantize.downsample_fsq import DownsampleFiniteScalarQuantize
from dmel_codec_tpu_torch.utils.masks import sequence_mask


def _get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3, dilation: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, d, _get_padding(kernel_size, d)) for d in dilation
        )
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, 1, _get_padding(kernel_size, 1)) for _ in dilation
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.silu(c1(F.silu(x))))
        return x


class ParallelBlock(nn.Module):
    def __init__(
        self,
        channels: int,
        kernel_sizes: Tuple[int, ...] = (3, 7, 11),
        dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
    ):
        super().__init__()
        self.blocks = nn.ModuleList(ResBlock1(channels, k, tuple(d)) for k, d in zip(kernel_sizes, dilation_sizes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sum(block(x) for block in self.blocks) / len(self.blocks)


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    hop_length: int = 512
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 8, 2, 2)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    num_mels: int = 128
    upsample_initial_channel: int = 512
    use_template: bool = True
    pre_conv_kernel_size: int = 7
    post_conv_kernel_size: int = 7


class HiFiGANGenerator(nn.Module):
    def __init__(self, config: HiFiGANConfig = HiFiGANConfig()):
        super().__init__()
        cfg = self.config = config
        assert math.prod(cfg.upsample_rates) == cfg.hop_length
        ch0 = cfg.upsample_initial_channel
        self.conv_pre = WNConv1d(cfg.num_mels, ch0, cfg.pre_conv_kernel_size,
                                 padding=_get_padding(cfg.pre_conv_kernel_size))
        self.ups = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch = ch0 // (2 ** (i + 1))
            self.ups.append(WNConvTranspose1d(2 * ch, ch, k, u, padding=(k - u) // 2))
            if cfg.use_template:
                if i + 1 < len(cfg.upsample_rates):
                    stride_f0 = int(np.prod(cfg.upsample_rates[i + 1 :]))
                    self.noise_convs.append(
                        nn.Conv1d(1, ch, stride_f0 * 2, stride=stride_f0, padding=stride_f0 // 2)
                    )
                else:
                    self.noise_convs.append(nn.Conv1d(1, ch, 1))
            self.resblocks.append(ParallelBlock(ch, cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))
        self.conv_post = WNConv1d(ch, 1, cfg.post_conv_kernel_size, padding=_get_padding(cfg.post_conv_kernel_size))

    def forward(self, x: torch.Tensor, template: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, num_mels, T] (+ template [B, 1, T*hop]) -> [B, T*hop]."""
        x = self.conv_pre(x)
        for i, (up, block) in enumerate(zip(self.ups, self.resblocks)):
            x = up(F.silu(x))
            if self.config.use_template:
                assert template is not None, "use_template needs a template signal"
                x = x + self.noise_convs[i](template)[..., : x.shape[-1]]
            x = block(x)
        return torch.tanh(self.conv_post(F.silu(x))[:, 0])


@dataclasses.dataclass(frozen=True)
class ConvNeXtEncoderConfig:
    input_channels: int = 3
    depths: Tuple[int, ...] = (3, 3, 9, 3)
    dims: Tuple[int, ...] = (96, 192, 384, 768)
    kernel_size: int = 7


class ConvNeXtEncoder(nn.Module):
    def __init__(self, config: ConvNeXtEncoderConfig = ConvNeXtEncoderConfig()):
        super().__init__()
        cfg = config
        self.downsample_layers = nn.ModuleList(
            [nn.Sequential(
                nn.Conv1d(cfg.input_channels, cfg.dims[0], cfg.kernel_size, padding=cfg.kernel_size // 2),
                ChannelLayerNorm(cfg.dims[0]),
            )]
            + [nn.Sequential(ChannelLayerNorm(cfg.dims[i - 1]), nn.Conv1d(cfg.dims[i - 1], cfg.dims[i], 1))
               for i in range(1, len(cfg.depths))]
        )
        self.stages = nn.ModuleList(
            nn.Sequential(*(ConvNeXtBlock(cfg.dims[i], kernel_size=cfg.kernel_size) for _ in range(cfg.depths[i])))
            for i in range(len(cfg.depths))
        )
        self.norm = ChannelLayerNorm(cfg.dims[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C_in, T] -> [B, dims[-1], T]."""
        for down, stage in zip(self.downsample_layers, self.stages):
            x = stage(down(x))
        return self.norm(x)


# fish-speech's firefly-gan-base head, shared by the vocoder and the codec
_BASE_HEAD = HiFiGANConfig(
    hop_length=512,
    upsample_rates=(8, 8, 2, 2, 2),
    upsample_kernel_sizes=(16, 16, 4, 4, 4),
    num_mels=512,
    upsample_initial_channel=512,
    use_template=False,
    pre_conv_kernel_size=13,
    post_conv_kernel_size=13,
)


class FireflyGAN(nn.Module):
    """fish-speech firefly-gan-base: ConvNeXt backbone + HiFiGAN head.
    mel [B, T, 128] -> waveform [B, T * 512]."""

    def __init__(
        self,
        encoder: ConvNeXtEncoderConfig = ConvNeXtEncoderConfig(
            input_channels=128, depths=(3, 3, 9, 3), dims=(128, 256, 384, 512)
        ),
        head: HiFiGANConfig = _BASE_HEAD,
    ):
        super().__init__()
        self.backbone = ConvNeXtEncoder(encoder)
        self.head = HiFiGANGenerator(head)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self.head(self.backbone(mel.transpose(1, 2)))


@dataclasses.dataclass(frozen=True)
class FireflyArchitectureConfig:
    """fish-speech firefly-gan-vq codec sizes (8 groups x ~1k codes, ~21.5 Hz)."""

    sample_rate: int = 44100
    n_fft: int = 2048
    hop_length: int = 512
    n_mels: int = 160
    backbone: ConvNeXtEncoderConfig = ConvNeXtEncoderConfig(
        input_channels=160, depths=(3, 3, 9, 3), dims=(128, 256, 384, 512)
    )
    head: HiFiGANConfig = _BASE_HEAD
    fsq_input_dim: int = 512
    fsq_groups: int = 8
    fsq_codebooks: int = 1
    fsq_levels: Tuple[int, ...] = (8, 5, 5, 5)
    fsq_downsample: Tuple[int, ...] = (2, 2)

    @property
    def downsample_total(self) -> int:
        return int(np.prod(self.fsq_downsample))

    @property
    def codebook_size(self) -> int:
        """Codes per codebook (the FSQ levels' product), which the harness's
        entropy column reads; the JAX config has no such field."""
        return int(np.prod(self.fsq_levels))


class FireflyArchitecture(nn.Module):
    """log-mel -> ConvNeXt backbone -> downsample-FSQ tokens -> HiFiGAN head.

    Masks as fish-speech's FireflyArchitecture: mels and backbone features
    are zeroed past mel_lengths, decoded features past
    feature_lengths * factor, audio past feature_lengths * factor * hop."""

    def __init__(self, config: FireflyArchitectureConfig = FireflyArchitectureConfig()):
        super().__init__()
        cfg = self.config = config
        self.backbone = ConvNeXtEncoder(cfg.backbone)
        self.head = HiFiGANGenerator(cfg.head)
        self.quantizer = DownsampleFiniteScalarQuantize(
            input_dim=cfg.fsq_input_dim,
            n_codebooks=cfg.fsq_codebooks,
            n_groups=cfg.fsq_groups,
            levels=cfg.fsq_levels,
            downsample_factor=cfg.fsq_downsample,
            is_dmel=False,
        )
        self.mel_tf = LogMelSpectrogram(
            sample_rate=cfg.sample_rate,
            n_fft=cfg.n_fft,
            win_length=cfg.n_fft,
            hop_length=cfg.hop_length,
            n_mels=cfg.n_mels,
            f_max=None,
        )

    def _masked_features(self, audios: torch.Tensor, audio_lengths: torch.Tensor):
        mels = self.mel_tf(audios).transpose(1, 2)  # [B, M, F]
        mel_lengths = audio_lengths // self.config.hop_length
        mask = sequence_mask(mel_lengths, mels.shape[2])[:, None, :].to(mels.dtype)
        return self.backbone(mels * mask) * mask, mel_lengths

    def encode_unquantized(self, audios: torch.Tensor, audio_lengths: torch.Tensor):
        """audios [B, T] -> (backbone features [B, F, D], mel_lengths)."""
        feats, mel_lengths = self._masked_features(audios, audio_lengths)
        return feats.transpose(1, 2), mel_lengths

    def encode(self, audios: torch.Tensor, audio_lengths: torch.Tensor):
        """audios [B, T] -> (indices [B, G*R, L], feature_lengths [B])."""
        feats, mel_lengths = self._masked_features(audios, audio_lengths)
        return self.quantizer.encode(feats), mel_lengths // self.config.downsample_total

    def decode(self, indices: torch.Tensor, feature_lengths: torch.Tensor):
        """indices [B, G*R, L] -> (audios [B, L*factor*hop], audio_lengths)."""
        factor = self.config.downsample_total
        z = self.quantizer.decode(indices)  # [B, D, L*factor]
        z = z * sequence_mask(feature_lengths * factor, z.shape[2])[:, None, :].to(z.dtype)
        audio_lengths = feature_lengths * factor * self.config.hop_length
        audio = self.head(z)
        return audio * sequence_mask(audio_lengths, audio.shape[1]).to(audio.dtype), audio_lengths
