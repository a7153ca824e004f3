"""Temporal-downsampled grouped FSQ (port of `dmel_codec_tpu/quantize/downsample_fsq.py`).

Module names follow the reference (models/modules/dowmsample_fsq.py:49-77):
`downsample.{i}` = (strided Conv1d, ConvNeXt), `upsample.{s}` =
(ConvTranspose1d, ConvNeXt) built in REVERSED stage order, and
`residual_fsq.rvqs.{g}`. The conv stacks run channels-first on the per-band
layout [B*G, f, T] (the reference's "(b g) f t" view); the FSQ runs on the
regrouped channels-last [B, L, G*f]. The public index layout is the
reference's [B, G*R, L] ("b (g r) l").
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from dmel_codec_tpu_torch.nn.convnext import ConvNeXtBlock
from dmel_codec_tpu_torch.quantize.fsq import GroupedResidualFSQ


@dataclasses.dataclass
class FSQResult:
    z: torch.Tensor        # reconstructed features, channels-first like the input
    codes: torch.Tensor    # [G, B, L, Q] raw grouped indices
    latents: torch.Tensor  # pre-quantization downsampled features [B, L, dim]
    loss: torch.Tensor | float = 0.0


class DownsampleFiniteScalarQuantize(nn.Module):
    def __init__(
        self,
        input_dim: int = 512,
        n_codebooks: int = 9,
        n_groups: int = 1,
        levels: Tuple[int, ...] = (8, 5, 5, 5),
        downsample_factor: Tuple[int, ...] = (2, 2),
        downsample_dims: Optional[Tuple[int, ...]] = None,
        is_dmel: bool = False,
    ):
        super().__init__()
        self.n_groups = n_groups
        self.is_dmel = is_dmel
        dims = downsample_dims or tuple(input_dim for _ in downsample_factor)
        if is_dmel:
            all_dims = (input_dim // n_groups,) + tuple(d // n_groups for d in dims)
        else:
            all_dims = (input_dim,) + tuple(dims)
        self.residual_fsq = GroupedResidualFSQ(
            dim=input_dim, levels=levels, num_quantizers=n_codebooks, groups=n_groups
        )
        self.downsample = nn.ModuleList(
            nn.Sequential(
                nn.Conv1d(all_dims[i], all_dims[i + 1], f, stride=f),
                ConvNeXtBlock(all_dims[i + 1]),
            )
            for i, f in enumerate(downsample_factor)
        )
        self.upsample = nn.ModuleList(
            nn.Sequential(
                nn.ConvTranspose1d(all_dims[i + 1], all_dims[i], f, stride=f),
                ConvNeXtBlock(all_dims[i]),
            )
            for i, f in reversed(list(enumerate(downsample_factor)))
        )

    def _bands_to_grouped(self, z: torch.Tensor, batch: int) -> torch.Tensor:
        """[B*G, f, T] -> [B, G*f, T] (reference "(b g) f t -> b (g f) t")."""
        _, f, t = z.shape
        return z.reshape(batch, self.n_groups * f, t)

    def _grouped_to_bands(self, z: torch.Tensor) -> torch.Tensor:
        """[B, G*f, T] -> [B*G, f, T]."""
        b, gf, t = z.shape
        return z.reshape(b * self.n_groups, gf // self.n_groups, t)

    def _downsample(self, z: torch.Tensor) -> torch.Tensor:
        """[B*G, f, T] (dMel) or [B, C, T] -> the FSQ's input [B, L, dim]."""
        batch = z.shape[0] // self.n_groups if self.is_dmel else z.shape[0]
        for stage in self.downsample:
            z = stage(z)
        if self.is_dmel:
            z = self._bands_to_grouped(z, batch)
        return z.transpose(1, 2)

    def _upsample(self, z: torch.Tensor) -> torch.Tensor:
        """The FSQ's output [B, L, dim] -> features [B, G*f, L*prod(factors)]."""
        b = z.shape[0]
        z = z.transpose(1, 2)
        if self.is_dmel:
            z = self._grouped_to_bands(z)
        for stage in self.upsample:
            z = stage(z)
        if self.is_dmel:
            z = self._bands_to_grouped(z, b)
        return z

    def forward(self, z: torch.Tensor) -> FSQResult:
        """Training path. z [B*G, f, T] (dMel) or [B, C, T] ->
        FSQResult with z [B, G*f, T]: the gradient passes the rounding
        straight through, and time is zero-padded back to T (the stages
        give 4 * floor(T / 4) <= T frames)."""
        original_t = z.shape[-1]
        latents = self._downsample(z)
        quantized, codes = self.residual_fsq(latents)
        zq = self._upsample(quantized)
        diff = original_t - zq.shape[-1]
        if diff < 0:
            raise ValueError("upsample produced more frames than the input")
        if diff > 0:
            zq = F.pad(zq, (diff // 2, diff - diff // 2))
        return FSQResult(z=zq, codes=codes, latents=latents)

    def encode(self, z: torch.Tensor) -> torch.Tensor:
        """[B*G, f, T] (dMel) or [B, C, T] -> indices [B, G*R, L]."""
        _, indices = self.residual_fsq(self._downsample(z))  # [G, B, L, R]
        g, b, l, r = indices.shape
        return indices.permute(1, 0, 3, 2).reshape(b, g * r, l)

    def decode(self, indices: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """indices [B, G*R, L] -> features [B, G*f, L*prod(factors)] (channels-first).

        dtype: activation dtype of the upsample stack; the FSQ lookup itself
        stays float32."""
        b, gr, l = indices.shape
        g = self.n_groups
        grouped = indices.reshape(b, g, gr // g, l).permute(1, 0, 3, 2)  # [G, B, L, R]
        z = self.residual_fsq.decode(grouped)  # [B, L, dim]
        if dtype is not None:
            z = z.to(dtype)
        return self._upsample(z)
