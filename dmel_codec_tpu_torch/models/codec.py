"""DMelCodec — the mel-domain codec (port of `dmel_codec_tpu/models/codec.py`).

Band-grouped WaveNet encoder -> grouped downsample-FSQ tokens -> FSQ decode
-> quality-conditioned WaveNet mel decoder driven by Gaussian noise. Module
names follow the original torch reference (encoder., quantizer., decoder.,
quality_projection.), so its checkpoints load directly.

Public layouts are the JAX package's: mels [B, T, M], masks [B, T, 1],
features/conditions/noise [B, T, C], indices [B, G*R, L]. The WaveNets and
the quantizer's conv stacks run channels-first inside.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from dmel_codec_tpu_torch.nn.wavenet import WaveNet
from dmel_codec_tpu_torch.quantize.downsample_fsq import DownsampleFiniteScalarQuantize, FSQResult
from dmel_codec_tpu_torch.utils.masks import sequence_mask
from dmel_codec_tpu_torch.utils.trace import span


@dataclasses.dataclass(frozen=True)
class DMelCodecConfig:
    """Flagship numbers (the JAX package's DMelCodecConfig)."""

    n_mels: int = 100
    dmel_groups: int = 10
    hop_length: int = 256
    sample_rate: int = 24000

    encoder_residual_channels: int = 70  # per band
    encoder_layers: int = 20
    decoder_layers: int = 20
    dilation_cycle: int = 4

    levels: Tuple[int, ...] = (7, 5, 5)
    n_codebooks: int = 1
    downsample_factor: Tuple[int, ...] = (2, 2)
    # activation dtype of decode-from-indices ("bfloat16" for serving)
    compute_dtype: Optional[str] = None

    @property
    def band_mels(self) -> int:
        return self.n_mels // self.dmel_groups

    @property
    def concat_dim(self) -> int:
        return self.dmel_groups * self.encoder_residual_channels

    @property
    def downsample_total(self) -> int:
        return math.prod(self.downsample_factor)

    @property
    def frame_rate(self) -> float:
        return self.sample_rate / self.hop_length / self.downsample_total

    @property
    def num_codebook_rows(self) -> int:
        """Rows in the public index layout [B, G*R, L]."""
        return self.dmel_groups * self.n_codebooks

    @property
    def codebook_size(self) -> int:
        return math.prod(self.levels)


class DMelCodec(nn.Module):
    def __init__(self, config: DMelCodecConfig = DMelCodecConfig()):
        super().__init__()
        cfg = self.config = config
        self.encoder = WaveNet(
            input_channels=cfg.band_mels,
            residual_channels=cfg.encoder_residual_channels,
            residual_layers=cfg.encoder_layers,
            dilation_cycle=cfg.dilation_cycle,
        )
        self.quantizer = DownsampleFiniteScalarQuantize(
            input_dim=cfg.concat_dim,
            n_codebooks=cfg.n_codebooks,
            n_groups=cfg.dmel_groups,
            levels=cfg.levels,
            downsample_factor=cfg.downsample_factor,
            is_dmel=True,
        )
        self.decoder = WaveNet(
            input_channels=cfg.concat_dim,
            output_channels=cfg.n_mels,
            residual_channels=cfg.concat_dim,
            residual_layers=cfg.decoder_layers,
            dilation_cycle=cfg.dilation_cycle,
            condition_channels=cfg.concat_dim,
        )
        self.quality_projection = nn.Linear(1, cfg.concat_dim)

    def _masks(self, lengths: torch.Tensor, t: int, dtype: torch.dtype) -> torch.Tensor:
        return sequence_mask(lengths, t)[..., None].to(dtype)  # [B, T, 1]

    def encode_features(self, mels: torch.Tensor, mel_masks: torch.Tensor) -> torch.Tensor:
        """Masked per-band WaveNet encode: [B, T, M] -> [B*G, T, res]."""
        g = self.config.dmel_groups
        b, t, m = mels.shape
        band_masks = mel_masks.transpose(1, 2).repeat_interleave(g, dim=0)  # [B*G, 1, T]
        bands = mels.transpose(1, 2).reshape(b * g, m // g, t) * band_masks
        return (self.encoder(bands) * band_masks).transpose(1, 2)

    def decode_mel(
        self, condition: torch.Tensor, mel_masks: torch.Tensor, noise: torch.Tensor
    ) -> torch.Tensor:
        """Noise-driven conditional decode: condition [B, T, concat] -> mel [B, T, M]."""
        y = self.decoder((noise * mel_masks).transpose(1, 2), condition.transpose(1, 2))
        return y.transpose(1, 2) * mel_masks

    def project_quality(self, quality: torch.Tensor) -> torch.Tensor:
        """quality [B, 1] -> [B, 1, concat]."""
        return self.quality_projection(quality)[:, None, :]

    # ---- training forward ---------------------------------------------------
    def forward(
        self,
        encode_mels: torch.Tensor,
        mel_masks: torch.Tensor,
        quality: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, FSQResult]:
        """Training-path forward: encode_mels [B, T, M], mel_masks
        [B, T, 1], quality [B, 1] -> (gen_mel [B, T, M], vq_result).

        noise [B, T, concat]; when absent it is drawn from `generator`, a
        `torch.Generator` on the module's device."""
        features = self.encode_features(encode_mels, mel_masks)
        vq_result = self.quantizer(features.transpose(1, 2))
        z = vq_result.z.transpose(1, 2) * mel_masks + self.project_quality(quality)
        if noise is None:
            noise = torch.randn(z.shape, generator=generator, device=z.device, dtype=z.dtype)
        return self.decode_mel(z * mel_masks, mel_masks, noise), vq_result

    # ---- public token API (reference codec_lit_modules.py:462-531) --------
    def encode_unquantized(
        self, mels: torch.Tensor, mel_lengths: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """mels [B, T, M] -> (features [B*G, T, res], mel_lengths)."""
        masks = self._masks(mel_lengths, mels.shape[1], mels.dtype)
        return self.encode_features(mels, masks), mel_lengths

    def get_indices_from_unquantized_features(
        self, features: torch.Tensor, mel_lengths: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        indices = self.quantizer.encode(features.transpose(1, 2))
        return indices, mel_lengths // self.config.downsample_total

    def encode(
        self, mels: torch.Tensor, mel_lengths: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """mels [B, T, M] + frame lengths -> (indices [B, G*R, L], index lengths)."""
        with span("codec.encode"):
            with span("codec.encode.wavenet"):
                features, mel_lengths = self.encode_unquantized(mels, mel_lengths)
            with span("codec.encode.fsq"):
                return self.get_indices_from_unquantized_features(features, mel_lengths)

    def get_quantized_features_from_indices(
        self, indices: torch.Tensor, feature_lengths: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """indices [B, G*R, L] -> (condition z [B, T, concat], mel mask [B, T, 1]).

        Quality is fixed at 2.0 (reference :523)."""
        factor = self.config.downsample_total
        dtype = getattr(torch, self.config.compute_dtype) if self.config.compute_dtype else None
        z = self.quantizer.decode(indices, dtype=dtype).transpose(1, 2)
        mel_masks = self._masks(feature_lengths * factor, z.shape[1], z.dtype)
        z = z * mel_masks
        quality = torch.full((z.shape[0], 1), 2.0, dtype=z.dtype, device=z.device)
        return z + self.project_quality(quality), mel_masks

    def decode(
        self,
        indices: torch.Tensor,
        feature_lengths: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """indices [B, G*R, L] -> gen_mel [B, T, M] (vocoder applied outside).

        noise [B, T, concat]; when absent it is drawn from `generator`."""
        with span("codec.decode"):
            with span("codec.decode.fsq"):
                z, mel_masks = self.get_quantized_features_from_indices(indices, feature_lengths)
                if noise is None:
                    noise = torch.randn(
                        z.shape, generator=generator, device=z.device, dtype=z.dtype
                    )
            with span("codec.decode.wavenet"):
                return self.decode_mel(z, mel_masks, noise)


def quality_from_gt_mels(gt_mels: torch.Tensor) -> torch.Tensor:
    """Mel-occupancy quality scalar (reference :173-174): [B, T, M] -> [B, 1]."""
    occupancy = (gt_mels.mean(dim=1) > -8.0).sum(dim=-1)
    return ((occupancy - 90.0) / 10.0).to(gt_mels.dtype)[:, None]
