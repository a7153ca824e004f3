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
  * `kind="deepseek_v3"` builds DeepSeek-V3 blocks instead
    (`models/deepseek_v3.py`, HF `DeepseekV3DecoderLayer`, no JAX
    counterpart): multi-head latent attention with its latent cache, and
    from layer `first_k_dense_replace` on a mixture of experts in place of
    the MLP. The kind is fixed when the decoder is built; the cache's
    layout follows it (`init_kv_cache`).
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

from dmel_codec_tpu_torch.ops.fast_block import BlockWeights, fast_block, shape_fault
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
    # kind: "qwen2" (the blocks below) or "deepseek_v3" (models/deepseek_v3.py, HF DeepseekV3's
    # names): latent attention of rank kv_lora_rank, query / key heads of
    # qk_nope_head_dim + qk_rope_head_dim, value heads of v_head_dim, no
    # query compression; `first_k_dense_replace` dense layers of
    # intermediate_size, then mixtures of n_routed_experts SwiGLU experts of
    # moe_intermediate_size, num_experts_per_tok a token (sigmoid scores,
    # top-k by score + correction bias, weights normalised and scaled by
    # routed_scaling_factor), plus n_shared_experts experts' width of shared
    # SwiGLU. RoPE on the rope part only, in DeepSeek's interleaved pairs.
    kind: str = "qwen2"
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    n_routed_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    n_shared_experts: int = 0
    first_k_dense_replace: int = 0
    routed_scaling_factor: float = 1.0

    def __post_init__(self):
        if self.kind not in CACHE_KEYS:
            raise ValueError(f"unknown decoder kind {self.kind!r}: one of {sorted(CACHE_KEYS)}")
        if self.kind == "deepseek_v3" and self.flash_attention:
            raise ValueError("flash_attention runs the qwen2 kind's equal q / v head sizes; deepseek_v3 attends by einsum")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def rope_dim(self) -> int:
        """The width RoPE rotates: the whole head, or MLA's rope part."""
        return self.qk_rope_head_dim if self.kind == "deepseek_v3" else self.head_dim


# The cache's per-layer tensors of each kind: per-head keys and values; or
# MLA's normalised latent and rotated shared rope key side by side.
CACHE_KEYS = {"qwen2": ("k", "v"), "deepseek_v3": ("kv",)}


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
    """Static-shape cache and the number of filled positions `index` (a 0-d
    int64 tensor on `device`). qwen2: per-layer K/V [L, B, max_len,
    kv_heads, head_dim]; deepseek_v3: per-layer "kv" [L, B, max_len,
    kv_lora_rank + qk_rope_head_dim], each position's normalised latent
    then its rotated rope key (shared by the heads)."""
    if config.kind == "deepseek_v3":
        shape = (config.num_layers, batch, max_len, config.kv_lora_rank + config.qk_rope_head_dim)
        cache = {"kv": torch.zeros(shape, dtype=dtype, device=device)}
    else:
        shape = (config.num_layers, batch, max_len, config.num_kv_heads, config.head_dim)
        cache = {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}
    cache["index"] = torch.zeros((), dtype=torch.int64, device=device)
    return cache


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
    def __init__(self, config: TransformerConfig, intermediate_size: Optional[int] = None):
        super().__init__()
        h, i = config.hidden_size, intermediate_size or config.intermediate_size
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
        if config.kind == "deepseek_v3":
            from dmel_codec_tpu_torch.models import deepseek_v3  # it builds on this module's norm, RoPE and MLP

            self.layers = nn.ModuleList(deepseek_v3.Block(config, i) for i in range(config.num_layers))
        else:
            self.layers = nn.ModuleList(Block(config) for _ in range(config.num_layers))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        self.cache_keys = CACHE_KEYS[config.kind]
        self.pair_counts: Optional[torch.Tensor] = None  # see track_pairs
        self.route_log: Optional[torch.Tensor] = None  # see track_routes

    def _moe_layers(self) -> list:
        return [layer.mlp for layer in self.layers if hasattr(layer.mlp, "pair_counts")]

    def track_pairs(self) -> Optional[torch.Tensor]:
        """The MoE layers' routed-pair counter, int64 [moe layers, 2,
        experts] on the decoder's device: each layer adds its (token, expert)
        pairs in place, under [:, 0] in a call over several positions (a
        prefill, a teacher-forced forward) and under [:, 1] in a
        one-position step (a decode, also inside a captured graph). Made at
        the first call and shared by later callers; whoever reads it zeroes
        it. None for a decoder without experts."""
        moe = self._moe_layers()
        if not moe:
            return None
        device = self.norm.weight.device
        if self.pair_counts is None or self.pair_counts.device != device:
            e = self.config.n_routed_experts
            self.pair_counts = torch.zeros((len(moe), 2, e), dtype=torch.int64, device=device)
            for m, counts in zip(moe, self.pair_counts):
                m.pair_counts = counts
        return self.pair_counts

    def track_routes(self, batch: int, max_len: int) -> Optional[torch.Tensor]:
        """The MoE layers' routing log, int16 [moe layers, batch, max_len,
        num_experts_per_tok] on the decoder's device: in every call over a
        cache of `batch` rows each layer writes the experts it chose for
        each position at the position's cache row (also inside a captured
        graph, so ask before the capture). Made once, at the first call; a
        later call over the cache overwrites its rows. None for a decoder
        without experts; nothing is logged until someone asks."""
        moe = self._moe_layers()
        if not moe:
            return None
        if self.route_log is None:
            k = self.config.num_experts_per_tok
            self.route_log = torch.zeros((len(moe), batch, max_len, k), dtype=torch.int16,
                                         device=self.norm.weight.device)
            for m, log in zip(moe, self.route_log):
                m.route_log = log
        elif self.route_log.shape[1:3] != (batch, max_len):
            raise ValueError(f"the routing log is kept for {tuple(self.route_log.shape[1:3])} (a captured graph "
                             f"may write to it), not {(batch, max_len)}")
        return self.route_log

    def fusable(self, s: int) -> bool:
        """Whether a cache-less causal call over S positions may run its
        blocks as kernel K4 (`forward(fused=True)`): Qwen2 blocks of sizes K4
        takes (ops/fast_block.shape_fault), every parameter bf16 off the CPU,
        no gradient taken, no block cut for tensor parallelism."""
        cfg = self.config
        return (cfg.kind == "qwen2" and not torch.is_grad_enabled()
                and not shape_fault(s, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                    cfg.intermediate_size)
                and all(p.dtype == torch.bfloat16 and p.device.type != "cpu" for p in self.parameters())
                and all(layer.self_attn.model_group is None and layer.mlp.model_group is None
                        for layer in self.layers))

    def forward(
        self,
        inputs_embeds: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        cache: Optional[dict] = None,
        attn_mask: Optional[torch.Tensor] = None,
        fused: bool = False,
    ) -> Tuple[torch.Tensor, Optional[dict]]:
        """inputs_embeds [B, S, H]. Without cache: causal self-attention.
        With cache: S new tokens appended at cache['index'] (the cache
        tensors are updated in place); attention over all cached positions
        <= current. Returns (hidden, cache), the returned cache's index
        advanced by S (a new tensor; the input cache's index is left as it
        was). Past max_len the rows' start is clamped, as in the JAX
        package; generation checks index + S <= max_len where it starts, and
        only S <= max_len is checked here, since the index lives on the
        device. `fused` (cache-less and causal only; see `fusable`) runs each
        block through `ops/fast_block.fast_block`: kernel K4 on the card, the
        blocks' own maths on the CPU."""
        cfg = self.config
        b, s, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        if fused and (cache is not None or positions is not None or attn_mask is not None):
            raise ValueError("a fused call is cache-less and causal over positions 0..S-1")

        mask_is_causal = False
        rows = None
        if cache is None:
            if positions is None:
                positions = torch.arange(s, device=dev).expand(b, s)
            if attn_mask is None:
                mask_is_causal = True
                if not (fused or cfg.flash_attention and s >= cfg.flash_min_seq):
                    attn_mask = torch.ones(s, s, dtype=torch.bool, device=dev).tril().expand(b, s, s)
        else:
            index, max_len = cache["index"], cache[self.cache_keys[0]].shape[2]
            if s > max_len:
                raise ValueError(f"KV cache of {max_len} positions cannot take {s}")
            steps = torch.arange(s, device=dev)
            if positions is None:
                positions = (index + steps).expand(b, s)
            # dynamic_update_slice's rows: the start clamped so that all S fit
            rows = index.clamp(max=max_len - s) + steps
            key_pos = torch.arange(max_len, device=dev)[None, None, :]  # [1, 1, T]
            attn_mask = key_pos <= positions[:, :, None]  # [B, S, T]

        cos, sin = rope_cos_sin(positions, cfg.rope_dim, cfg.rope_theta)

        x = inputs_embeds
        for i, layer in enumerate(self.layers):
            if fused:  # every row's positions are 0..S-1: one [S, head_dim] table
                x = fast_block(x, BlockWeights.of(layer), cos[0], sin[0], cfg.rms_norm_eps)
            elif cache is not None:
                x = layer(x, cos, sin, attn_mask, [cache[k][i] for k in self.cache_keys], rows, mask_is_causal)
            elif cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, cos, sin, attn_mask, None, None, mask_is_causal, use_reentrant=False)
            else:
                x = layer(x, cos, sin, attn_mask, None, None, mask_is_causal)
        x = self.norm(x)

        if cache is not None:
            cache = dict(cache, index=cache["index"] + s)
        return x, cache
