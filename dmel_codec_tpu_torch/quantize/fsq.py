"""Finite Scalar Quantization (port of `dmel_codec_tpu/quantize/fsq.py`).

Same semantics as the JAX package, which matches the `vector_quantize_pytorch`
GroupedResidualFSQ the reference wraps:
  * bound z with tanh into [-(L-1)/2, (L-1)/2] (1e-3 widening, half-shift
    for even L), round half to even with a straight-through estimator,
    normalise to [-1, 1]
  * indices = float mixed-radix sum against basis = cumprod([1, levels[:-1]]),
    then cast to int (truncation, as the JAX package does)
  * ResidualFSQ projects dim -> len(levels), runs its rounds in float32
    starting from bound(project_in(x)) — the library's double bound — and
    projects back
  * GroupedResidualFSQ: independent ResidualFSQs over contiguous feature
    groups (`rvqs.{g}`, the reference's key layout)
Layout is channels-last [B, T, dim], as in the library.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

_EPS = 1e-3


def _levels_np(levels: Tuple[int, ...]) -> np.ndarray:
    return np.asarray(levels, dtype=np.int32)


def _basis_np(levels: Tuple[int, ...]) -> np.ndarray:
    return np.concatenate(([1], np.cumprod(levels[:-1]))).astype(np.int32)


def round_ste(z: torch.Tensor) -> torch.Tensor:
    return z + (torch.round(z) - z).detach()


class FSQ:
    """Single-codebook FSQ over the last axis (size == len(levels)); no parameters."""

    def __init__(self, levels: Tuple[int, ...]):
        self.levels = tuple(levels)

    @property
    def codebook_size(self) -> int:
        return int(np.prod(self.levels))

    def _const(self, arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(arr, dtype=torch.float32, device=like.device)

    def bound(self, z: torch.Tensor) -> torch.Tensor:
        levels = self._const(_levels_np(self.levels), z)
        half_l = (levels - 1) * (1 + _EPS) / 2
        offset = torch.where(levels % 2 == 0, 0.5, 0.0)
        shift = torch.atanh(offset / half_l)
        return torch.tanh(z + shift) * half_l - offset

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """z [..., d] -> normalized codes in [-1, 1] with STE."""
        quantized = round_ste(self.bound(z))
        return quantized / self._const(_levels_np(self.levels) // 2, z)

    def codes_to_indices(self, codes: torch.Tensor) -> torch.Tensor:
        half_width = self._const(_levels_np(self.levels) // 2, codes)
        zhat = codes * half_width + half_width
        basis = self._const(_basis_np(self.levels), codes)
        return (zhat * basis).sum(-1).to(torch.int32)

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        levels = torch.as_tensor(_levels_np(self.levels), device=indices.device)
        basis = torch.as_tensor(_basis_np(self.levels), device=indices.device)
        codes_non_centered = torch.div(indices[..., None], basis, rounding_mode="floor") % levels
        half_width = self._const(_levels_np(self.levels) // 2, indices)
        return (codes_non_centered.float() - half_width) / half_width

    def __call__(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        codes = self.quantize(z.float())
        return codes, self.codes_to_indices(codes.detach())


class ResidualFSQ(nn.Module):
    """dim -> len(levels) projection, residual FSQ rounds, projection back."""

    def __init__(self, dim: int, levels: Tuple[int, ...], num_quantizers: int = 1):
        super().__init__()
        self.dim = dim
        self.levels = tuple(levels)
        codebook_dim = len(levels)
        self.requires_projection = codebook_dim != dim
        if self.requires_projection:
            self.project_in = nn.Linear(dim, codebook_dim)
            self.project_out = nn.Linear(codebook_dim, dim)
        self.fsq = FSQ(levels)
        self.num_quantizers = num_quantizers
        levels_minus_1 = np.asarray(levels, np.float32) - 1
        self.scales = np.stack(
            [levels_minus_1 ** (-float(i)) for i in range(num_quantizers)]
        )  # [Q, d]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, dim] -> (quantized [B, T, dim], indices [B, T, Q])."""
        orig_dtype = x.dtype
        if self.requires_projection:
            x = self.project_in(x)
        x = x.float()
        quantized_out = torch.zeros_like(x)
        residual = self.fsq.bound(x)
        all_indices = []
        for i in range(self.num_quantizers):
            scale = torch.as_tensor(self.scales[i], device=x.device)
            codes, indices = self.fsq(residual / scale)
            codes = codes * scale
            residual = residual - codes.detach()
            quantized_out = quantized_out + codes
            all_indices.append(indices)
        quantized_out = quantized_out.to(orig_dtype)
        if self.requires_projection:
            quantized_out = self.project_out(quantized_out)
        return quantized_out, torch.stack(all_indices, dim=-1)

    def get_output_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """indices [B, T, Q] -> [B, T, dim] in float32 (as the JAX Dense
        promotes float32 codes against its parameters)."""
        codes_summed = None
        for i in range(self.num_quantizers):
            codes = self.fsq.indices_to_codes(indices[..., i])
            codes = codes * torch.as_tensor(self.scales[i], device=codes.device)
            codes_summed = codes if codes_summed is None else codes_summed + codes
        if self.requires_projection:
            w, b = self.project_out.weight, self.project_out.bias
            codes_summed = F.linear(codes_summed, w.float(), b.float())
        return codes_summed


class GroupedResidualFSQ(nn.Module):
    """Feature dim split into `groups` independent ResidualFSQs.

    forward: x [B, T, dim] -> (quantized [B, T, dim], indices [G, B, T, Q])
    decode:  indices [G, B, T, Q] -> [B, T, dim]
    """

    def __init__(self, dim: int, levels: Tuple[int, ...], num_quantizers: int = 1, groups: int = 1):
        super().__init__()
        if dim % groups:
            raise ValueError(f"dim {dim} is not divisible by groups {groups}")
        self.dim = dim
        self.levels = tuple(levels)
        self.num_quantizers = num_quantizers
        self.groups = groups
        self.rvqs = nn.ModuleList(
            ResidualFSQ(dim // groups, levels, num_quantizers) for _ in range(groups)
        )

    @property
    def dim_per_group(self) -> int:
        return self.dim // self.groups

    def forward(self, x: torch.Tensor):
        outs = [rvq(z) for rvq, z in zip(self.rvqs, x.chunk(self.groups, dim=-1))]
        return (
            torch.cat([q for q, _ in outs], dim=-1),
            torch.stack([i for _, i in outs], dim=0),
        )

    def decode(self, indices: torch.Tensor) -> torch.Tensor:
        return torch.cat(
            [rvq.get_output_from_indices(i) for rvq, i in zip(self.rvqs, indices)], dim=-1
        )
