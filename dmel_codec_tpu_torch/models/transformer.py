"""Qwen2-style decoder-only transformer (port of `dmel_codec_tpu/models/transformer.py`).

Pre-RMSNorm blocks, RoPE (theta 1e6, HF half-duplicated layout),
grouped-query attention with Q/K/V biases and a bias-free output
projection, SiLU gated MLP, final RMSNorm. Parameter names are HF Qwen2's
(`layers.{i}.self_attn.q_proj.weight`, ...), so a `Qwen2Model` state_dict
loads into `Decoder` directly.

  * The KV cache is a dict of static-shape tensors
    ([L, B, max_len, kv_heads, head_dim]) and the number of filled positions
    `index`, a 0-d int64 tensor on the cache's device. A cached call writes
    the new keys and values IN PLACE at `index + arange(S)` (the start
    clamped so that the S rows fit, as `dynamic_update_slice` clamps it),
    builds RoPE from those device positions and attends over all max_len
    positions under the mask `key_pos <= position`, as the JAX package does.
    Nothing on the cached path reads the index on the host, so a frame step
    over the cache can be captured in a CUDA graph.
  * Attention outside the flash kernel is einsum-based with a float32
    softmax; GQA goes through a group axis, K/V are never repeated.
  * With `flash_attention=True`, the cache-less causal path at
    S >= flash_min_seq runs `ops.flash_attention` (on a CUDA tensor kernel
    FA forward and, under autograd, FA-dKV and FA-dQ backward).
  * With `remat=True` the cache-less path checkpoints each block
    (`torch.utils.checkpoint`, non-reentrant): a block keeps only its input
    for the backward pass and runs its forward a second time there, as
    `nn.remat` does in the JAX package.
  * RoPE is applied in float32 and returned in the input dtype, so that the
    cache and the flash kernel see one dtype (the JAX function leaves the
    float32 promotion in place; in float32 the two are the same).
  * Under tensor parallelism (`parallel/tensor.set_model_groups`) an
    attention or MLP block holds its rank's whole heads or MLP columns and
    takes its head counts from its projections' widths; Megatron's copy
    and reduce over `model_group` bracket it (None: one process).
`scan_layers` of the JAX config (one compiled layer body under `nn.scan`)
is an XLA device and has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dmel_codec_tpu_torch.ops.flash_attention import flash_attention
from dmel_codec_tpu_torch.parallel.tensor import copy_to_model, reduce_from_model


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    # flash_attention: use the flash kernel on the cache-less (training)
    # path for sequences >= flash_min_seq: O(S) memory instead of the
    # materialised [S, S] score matrix.
    flash_attention: bool = False
    flash_min_seq: int = 512
    # remat: recompute each block's activations in the backward pass instead
    # of keeping them (training memory; cache-less path only).
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


# Flagship sizes (Qwen2-0.5B slow decoder, 12-layer fast depth decoder).
SLOW_LM_CONFIG = TransformerConfig(
    vocab_size=151936,
    hidden_size=896,
    intermediate_size=4864,
    num_layers=24,
    num_heads=14,
    num_kv_heads=2,
)
FAST_LM_CONFIG = TransformerConfig(
    vocab_size=1800,
    hidden_size=480,
    intermediate_size=2880,
    num_layers=12,
    num_heads=10,
    num_kv_heads=2,
)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (self.weight * (xf * torch.rsqrt(var + self.eps))).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """RoPE's frequencies on `device`, made once: a copy from the host would
    break a CUDA graph that captures the cached path."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    return torch.from_numpy(inv_freq.astype(np.float32)).to(device)


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [..., S] -> float32 cos/sin [..., S, head_dim] (HF half-duplicated)."""
    inv_freq = _inv_freq(head_dim, theta, positions.device)
    angles = positions[..., None].float() * inv_freq  # [..., S, hd/2]
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, hd]; cos/sin [B, S, hd] (broadcast over heads)."""
    half = x.shape[-1] // 2
    xf = x.float()
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos[..., None, :] + rotated * sin[..., None, :]).to(x.dtype)


def init_kv_cache(
    config: TransformerConfig, batch: int, max_len: int, dtype=torch.float32, device=None
) -> dict:
    """Static-shape cache: per-layer K/V [L, B, max_len, kv_heads, head_dim]
    and the number of filled positions (a 0-d int64 tensor on `device`)."""
    shape = (config.num_layers, batch, max_len, config.num_kv_heads, config.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": torch.zeros((), dtype=torch.int64, device=device),
    }


class Attention(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        cfg = self.config = config
        hd = cfg.head_dim
        self.q_proj = nn.Linear(cfg.hidden_size, cfg.num_heads * hd)
        self.k_proj = nn.Linear(cfg.hidden_size, cfg.num_kv_heads * hd)
        self.v_proj = nn.Linear(cfg.hidden_size, cfg.num_kv_heads * hd)
        self.o_proj = nn.Linear(cfg.num_heads * hd, cfg.hidden_size, bias=False)
        self.model_group = None  # tensor parallel: this rank's heads, see parallel/tensor.py

    def forward(
        self,
        x: torch.Tensor,
        cos: torch.Tensor,
        sin: torch.Tensor,
        mask: Optional[torch.Tensor],
        cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        cache_rows: Optional[torch.Tensor] = None,
        mask_is_causal: bool = False,
    ) -> torch.Tensor:
        """x [B, S, H]; mask [B, S, T] bool (None only on the flash path).
        With `cache_kv` ([B, max_len, kh, hd] each) the new keys and values
        are written in place at the positions `cache_rows` [S] (a device
        tensor) and T = max_len."""
        cfg = self.config
        b, s, _ = x.shape
        hd = cfg.head_dim
        x = copy_to_model(x, self.model_group)
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        heads, kv_heads = q.shape[-1] // hd, k.shape[-1] // hd  # this rank's under tensor parallelism

        q = apply_rope(q.reshape(b, s, heads, hd), cos, sin)
        k = apply_rope(k.reshape(b, s, kv_heads, hd), cos, sin)
        v = v.reshape(b, s, kv_heads, hd)

        if cache_kv is not None:
            ck, cv = cache_kv
            ck.index_copy_(1, cache_rows, k.to(ck.dtype))
            cv.index_copy_(1, cache_rows, v.to(cv.dtype))
            k, v = ck, cv
        elif cfg.flash_attention and s >= cfg.flash_min_seq and mask_is_causal:
            # a caller-supplied mask must use the einsum path
            out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
            return reduce_from_model(self.o_proj(out.reshape(b, s, -1)), self.model_group)

        # GQA: [B, T, kh, hd] -> heads via an extra group axis in the einsum;
        # a cache of another dtype promotes as jnp.einsum does
        groups = heads // kv_heads
        qk = torch.promote_types(q.dtype, k.dtype)
        qg = q.reshape(b, s, kv_heads, groups, hd).to(qk)
        scores = torch.einsum("bskgh,btkh->bkgst", qg, k.to(qk)) / math.sqrt(hd)
        scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
        probs = torch.softmax(scores.float(), dim=-1).to(torch.promote_types(x.dtype, v.dtype))
        out = torch.einsum("bkgst,btkh->bskgh", probs, v.to(probs.dtype))
        return reduce_from_model(self.o_proj(out.reshape(b, s, -1).to(x.dtype)), self.model_group)


class MLP(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = nn.Linear(h, i, bias=False)
        self.up_proj = nn.Linear(h, i, bias=False)
        self.down_proj = nn.Linear(i, h, bias=False)
        self.model_group = None  # tensor parallel: this rank's columns, see parallel/tensor.py

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_model(x, self.model_group)
        return reduce_from_model(self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x)), self.model_group)


class Block(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.self_attn = Attention(config)
        self.mlp = MLP(config)
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps)

    def forward(self, x, cos, sin, mask, cache_kv=None, cache_rows=None, mask_is_causal=False):
        x = x + self.self_attn(
            self.input_layernorm(x), cos, sin, mask, cache_kv, cache_rows, mask_is_causal
        )
        return x + self.mlp(self.post_attention_layernorm(x))


class Decoder(nn.Module):
    """Stack of blocks + final norm over input EMBEDDINGS (no token table:
    the multimodal model owns its embeddings)."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        self.layers = nn.ModuleList(Block(config) for _ in range(config.num_layers))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)

    def forward(
        self,
        inputs_embeds: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        cache: Optional[dict] = None,
        attn_mask: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[dict]]:
        """inputs_embeds [B, S, H]. Without cache: causal self-attention.
        With cache: S new tokens appended at cache['index'] (the cache
        tensors are updated in place); attention over all cached positions
        <= current. Returns (hidden, cache), the returned cache's index
        advanced by S (a new tensor; the input cache's index is left as it
        was). Past max_len the rows' start is clamped, as in the JAX
        package; generation checks index + S <= max_len where it starts, and
        only S <= max_len is checked here, since the index lives on the
        device."""
        cfg = self.config
        b, s, _ = inputs_embeds.shape
        dev = inputs_embeds.device

        mask_is_causal = False
        rows = None
        if cache is None:
            if positions is None:
                positions = torch.arange(s, device=dev).expand(b, s)
            if attn_mask is None:
                mask_is_causal = True
                if not (cfg.flash_attention and s >= cfg.flash_min_seq):
                    attn_mask = torch.ones(s, s, dtype=torch.bool, device=dev).tril().expand(b, s, s)
        else:
            index, max_len = cache["index"], cache["k"].shape[2]
            if s > max_len:
                raise ValueError(f"KV cache of {max_len} positions cannot take {s}")
            steps = torch.arange(s, device=dev)
            if positions is None:
                positions = (index + steps).expand(b, s)
            # dynamic_update_slice's rows: the start clamped so that all S fit
            rows = index.clamp(max=max_len - s) + steps
            key_pos = torch.arange(max_len, device=dev)[None, None, :]  # [1, 1, T]
            attn_mask = key_pos <= positions[:, :, None]  # [B, S, T]

        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

        x = inputs_embeds
        for i, layer in enumerate(self.layers):
            if cache is not None:
                x = layer(x, cos, sin, attn_mask, (cache["k"][i], cache["v"][i]), rows, mask_is_causal)
            elif cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, cos, sin, attn_mask, None, None, mask_is_causal, use_reentrant=False)
            else:
                x = layer(x, cos, sin, attn_mask, None, None, mask_is_causal)
        x = self.norm(x)

        if cache is not None:
            cache = {"k": cache["k"], "v": cache["v"], "index": cache["index"] + s}
        return x, cache
