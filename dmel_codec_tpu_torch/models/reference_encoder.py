"""Reference / speaker encoder: WaveNet + latent-query attention pooling
(port of `dmel_codec_tpu/models/reference_encoder.py`).

WaveNet trunk -> `latent_len` learned queries cross-attend over the time
axis (per-head LayerNorm on q / k), residual MLP, output projection, mean
over the latent axis -> one embedding per utterance. The original torch
module's names are not available, so the parameters keep the JAX module's
(`wavenet`, `latent`, `q`, `kv`, `q_norm`, `k_norm`, `proj`, `norm`,
`mlp_0`, `mlp_1`, `output_projection_attn`); a JAX tree reaches this module
through `convert.reference_encoder_state_dict_from_jax`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from dmel_codec_tpu_torch.nn.wavenet import WaveNet

_LN_EPS = 1e-6  # flax LayerNorm's default


def _linear(in_f: int, out_f: int) -> nn.Linear:
    # the JAX module's truncated_normal(stddev=0.02), zero bias
    layer = nn.Linear(in_f, out_f)
    nn.init.trunc_normal_(layer.weight, std=0.02, a=-0.04, b=0.04)
    nn.init.zeros_(layer.bias)
    return layer


class ReferenceEncoder(nn.Module):
    def __init__(
        self,
        input_channels: Optional[int] = None,
        output_channels: int = 512,
        residual_channels: int = 512,
        residual_layers: int = 20,
        dilation_cycle: int = 4,
        num_heads: int = 8,
        latent_len: int = 4,
    ):
        super().__init__()
        c = residual_channels
        self.num_heads = num_heads
        self.wavenet = WaveNet(
            input_channels=input_channels,
            residual_channels=c,
            residual_layers=residual_layers,
            dilation_cycle=dilation_cycle,
        )
        self.latent = nn.Parameter(torch.empty(1, latent_len, c))
        nn.init.trunc_normal_(self.latent, std=0.02, a=-0.04, b=0.04)
        self.q = _linear(c, c)
        self.kv = _linear(c, 2 * c)
        self.q_norm = nn.LayerNorm(c // num_heads, eps=_LN_EPS)
        self.k_norm = nn.LayerNorm(c // num_heads, eps=_LN_EPS)
        self.proj = _linear(c, c)
        self.dropout = nn.Dropout(0.1)
        self.norm = nn.LayerNorm(c, eps=_LN_EPS)
        self.mlp_0 = _linear(c, 4 * c)
        self.mlp_1 = _linear(4 * c, c)
        self.output_projection_attn = _linear(c, output_channels)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, C_in], attn_mask [B, T] bool -> embedding [B, out]
        (dropout in training mode only)."""
        x = self.wavenet(x.transpose(1, 2)).transpose(1, 2)  # [B, T, c]
        b, n, c = x.shape
        h, hd = self.num_heads, c // self.num_heads
        q = self.q(self.latent.expand(b, -1, -1)).reshape(b, -1, h, hd)
        k, v = self.kv(x).reshape(b, n, 2, h, hd).unbind(dim=2)
        q, k = self.q_norm(q), self.k_norm(k)

        scores = torch.einsum("blhd,bnhd->bhln", q, k) / math.sqrt(hd)
        if attn_mask is not None:
            scores = torch.where(attn_mask[:, None, None, :], scores, torch.full_like(scores, -1e30))
        out = torch.einsum("bhln,bnhd->blhd", torch.softmax(scores, dim=-1), v).reshape(b, -1, c)

        out = self.dropout(self.proj(out))
        out = out + self.mlp_1(F.silu(self.mlp_0(self.norm(out))))
        return self.output_projection_attn(out).mean(dim=1)
