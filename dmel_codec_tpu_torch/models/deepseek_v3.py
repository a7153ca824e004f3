"""The DeepSeek-V3 block (HF `DeepseekV3DecoderLayer`, without query
compression): multi-head latent attention, then a dense SwiGLU in the
first `first_k_dense_replace` layers and a mixture of experts after. No
counterpart in the JAX package; `TransformerConfig(kind="deepseek_v3")`
builds it.

Latent attention (MLA). Per position: `q_proj` gives each head a query of
qk_nope_head_dim + qk_rope_head_dim; `kv_a_proj_with_mqa` gives the latent
c (kv_lora_rank, normalised by `kv_a_layernorm`) and one rope key k_pe
shared by the heads; `kv_b_proj` expands c into each head's k_nope and
value. RoPE turns the rope parts in DeepSeek's interleaved pairs (HF
`apply_rotary_pos_emb_interleave`: the pairs (x0, x1), (x2, x3), .. are
gathered into halves, then rotated as Qwen2's half-duplicated layout).
score = (q_nope . k_nope + q_pe . k_pe) / sqrt(qk head), a float32 softmax.
The cache holds, per position, c after the norm and k_pe after RoPE (one
tensor, "kv"; `transformer.init_kv_cache`). Two forms of the same
product, chosen by shape when the call is made:
  * expanded (every call over several positions, and every call without a
    cache): k_nope and the values from `kv_b_proj` of the keys' latents,
    then the attention core of `ops/mla_attention.py`: kernel K5 (one
    launch) where `k5_takes` holds and the mask is the decoder's own causal
    one (its positions passed down), else the plain chunked core, the
    queries in chunks of at most SCORE_ELEMENTS scores (float32, training,
    the CPU, a caller's mask);
  * absorbed (a one-position step over the cache, the decode): W_uk folded
    into the query, so the scores are taken against the latents directly,
    and W_uv applied after the weighted sum of latents. The cache is read
    once, and nothing of it is expanded per head.

Mixture of experts (HF `DeepseekV3MoE` with `DeepseekV3TopkRouter`,
`topk_method` "noaux_tc", one expert group). For a token h:
  s = sigmoid(gate.weight . h), one score an expert, in float32;
  the num_experts_per_tok experts of the largest s + e_score_correction_bias
  (the bias, a persistent buffer, only selects);
  w_i = routed_scaling_factor * s_i / (sum of the chosen s + 1e-20);
  y = sum_i w_i E_i(h) + S(h): E_i a SwiGLU of moe_intermediate_size, S the
  shared SwiGLU of n_shared_experts times that width. With
  `TransformerConfig.mlp_hidden_act` "relu2" (Nemotron-H's experts) each is
  non-gated, down(relu(up(h))^2), and S of shared_expert_intermediate_size.
No capacity: every token reaches its experts, whatever the imbalance. The
experts' weights are stacked (`experts.gate_up_proj` [E, 2 I, H], gate rows
then up rows, or for relu2 `experts.up_proj` [E, I, H]; `experts.down_proj`
[E, H, I]). Two ways of computing the
same sum, chosen by shape when the call is made:
  * routed (a call over several positions: the prefill, a teacher-forced
    forward): the (token, expert) pairs sorted by expert, each expert's
    product over its own tokens only; its host reads the pair counts, so it
    runs eagerly;
  * dense (a one-position step: the decode, inside a captured graph): every
    expert over every token of the step in two matmuls over the stacked
    weights, the unchosen weighted by zero. No host read and no shape that
    depends on the routing; at a decode's batch most experts are chosen by
    some token anyway, and the step reads every expert's weights once.
Each layer adds its (token, expert) pairs to `Decoder.track_pairs`'
counter, and over a cache writes its choices at the positions' rows of
`Decoder.track_routes`' log (what the served tokens were computed with),
where someone asked for them.

The expert share (expert parallelism, `TransformerConfig.experts_held` /
`expert_offset`): a layer may hold only the experts offset .. offset +
held - 1 of its router's. The router keeps every output and its bias and
routes over all of them; the counter and the log keep the router's expert
ids. `routed` computes the pairs routed to held experts only, `dense` the
held experts with the absent ones' weights dropped, and the shared experts
run as before: the layer adds its own experts' part of the sum, and nothing
stands in for the others. Holding every expert is the whole layer, on the
same kernels.

The latent attention of `kind="kimi_linear"` (Kimi Linear's MLA layers,
`mla_use_nope` in its config): nothing is rotated (the rope parts of query and key
are plain parts of the head, cached as they come), and `kv_a_layernorm`
takes the configuration's rms_norm_eps.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dmel_codec_tpu_torch.models.transformer import MLP, RMSNorm, TransformerConfig, apply_rope
from dmel_codec_tpu_torch.ops import mla_attention as k5
from dmel_codec_tpu_torch.utils.trace import span

# Largest score block of the expanded form's plain core ([B, heads, queries,
# keys] in float32: 1 GiB); longer prefills take their queries in chunks.
SCORE_ELEMENTS = k5.SCORE_ELEMENTS
# HF DeepseekV3's kv_a_layernorm keeps DeepseekV3RMSNorm's default eps.
LATENT_NORM_EPS = 1e-6


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """[..., d] pairs (x0, x1), (x2, x3), .. -> [x0, x2, .., x1, x3, ..]."""
    return x.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)


class LatentAttention(nn.Module):
    # expanded-form calls of every instance, by core: "fused" (K5) or "plain";
    # `SlowFastGenerator` zeroes them and reports the fused share
    calls = {"fused": 0, "plain": 0}

    def __init__(self, config: TransformerConfig):
        super().__init__()
        cfg = self.config = config
        h, nh, r = cfg.hidden_size, cfg.num_heads, cfg.kv_lora_rank
        self.nope, self.rope, self.v = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        self.q_proj = nn.Linear(h, nh * (self.nope + self.rope), bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(h, r + self.rope, bias=False)
        self.kv_a_layernorm = RMSNorm(r, cfg.rms_norm_eps if cfg.kind == "kimi_linear" else LATENT_NORM_EPS)
        self.kv_b_proj = nn.Linear(r, nh * (self.nope + self.v), bias=False)
        self.o_proj = nn.Linear(nh * self.v, h, bias=False)
        self.scale = 1.0 / math.sqrt(self.nope + self.rope)

    def forward(
        self,
        x: torch.Tensor,
        cos: torch.Tensor,
        sin: torch.Tensor,
        mask: torch.Tensor,
        cache: Optional[torch.Tensor] = None,
        cache_rows: Optional[torch.Tensor] = None,
        mask_pos: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """x [B, S, H]; cos / sin [B, S, qk_rope_head_dim]; mask [B, S, T]
        bool. With `cache` ([B, max_len, latent + rope]) the new positions
        are written in place at `cache_rows` and T = max_len. `mask_pos`
        [B, S]: where the mask is the decoder's own causal one, key t <=
        mask_pos[b, s]; None for a caller's mask."""
        with span("lm.mla"):
            b, s, _ = x.shape
            nh, r = self.config.num_heads, self.config.kv_lora_rank
            q = self.q_proj(x).view(b, s, nh, self.nope + self.rope)
            q_nope, q_pe = q.split([self.nope, self.rope], dim=-1)
            c, k_pe = self.kv_a_proj_with_mqa(x).split([r, self.rope], dim=-1)
            if self.config.kind != "kimi_linear":
                q_pe = apply_rope(deinterleave(q_pe), cos, sin)
                k_pe = apply_rope(deinterleave(k_pe)[:, :, None, :], cos, sin)[:, :, 0]
            kv = torch.cat([self.kv_a_layernorm(c), k_pe], dim=-1)  # [B, S, r + rope]
            if cache is not None:
                cache.index_copy_(1, cache_rows, kv.to(cache.dtype))
                kv = cache
                if s == 1:
                    return self.o_proj(self._absorbed(q_nope, q_pe, kv, mask).reshape(b, s, -1).to(x.dtype))
            if s == 1 or not self.k5_takes(q_nope, kv):
                mask_pos = None  # the plain core
            out = self._expanded(q_nope, q_pe, kv, mask, mask_pos)
            return self.o_proj(out.reshape(b, s, -1).to(x.dtype))

    def k5_takes(self, q_nope: torch.Tensor, kv: torch.Tensor) -> bool:
        """Whether the expanded form's core may run as K5: bf16 queries,
        latents and `kv_b_proj` off the CPU, no gradient taken, head sizes
        K5 takes (`ops/mla_attention.shape_fault`)."""
        return (not torch.is_grad_enabled() and q_nope.device.type != "cpu"
                and q_nope.dtype == kv.dtype == self.kv_b_proj.weight.dtype == torch.bfloat16
                and not k5.shape_fault(self.config.num_heads, self.nope, self.rope, self.v))

    def _expanded(self, q_nope, q_pe, kv, mask, mask_pos) -> torch.Tensor:
        """Keys and values from `kv_b_proj` of every key's latent, then the
        attention core: K5 given the mask's positions, or the plain chunked
        core given the mask where `mask_pos` is None. -> [B, S, heads, v]."""
        b, nh = q_nope.shape[0], q_nope.shape[2]
        t, r = kv.shape[1], self.config.kv_lora_rank
        latent, k_pe = kv[..., :r], kv[..., r:]
        k_nope, value = self.kv_b_proj(latent.to(self.kv_b_proj.weight.dtype)).view(b, t, nh, -1).split(
            [self.nope, self.v], dim=-1)
        LatentAttention.calls["plain" if mask_pos is None else "fused"] += 1
        with span("lm.mla.attend"):
            if mask_pos is not None:
                return k5.mla_attention(q_nope, q_pe, k_nope, k_pe, value, mask_pos, self.scale)
            return k5.expanded_attention(q_nope, q_pe, k_nope, k_pe, value, mask, self.scale, SCORE_ELEMENTS)

    def _absorbed(self, q_nope, q_pe, kv, mask) -> torch.Tensor:
        """One step against the cached latents: q_nope . (W_uk c) =
        (q_nope W_uk) . c, and W_uv after the weighted sum. -> [B, S,
        heads, v]."""
        nh, r = self.config.num_heads, self.config.kv_lora_rank
        w = self.kv_b_proj.weight.view(nh, self.nope + self.v, r)
        dtype = torch.promote_types(q_nope.dtype, kv.dtype)
        q_latent = torch.einsum("bshd,hdr->bshr", q_nope, w[:, : self.nope])
        queries = torch.cat([q_latent, q_pe], dim=-1).to(dtype)
        scores = torch.einsum("bshr,btr->bhst", queries, kv.to(dtype)).float() * self.scale
        scores = torch.where(mask[:, None, :, :], scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(dtype)
        latent = torch.einsum("bhst,btr->bshr", probs, kv[..., :r].to(dtype))
        return torch.einsum("bshr,hdr->bshd", latent.to(w.dtype), w[:, self.nope:])


NORM_EPS = 1e-20  # HF's guard on the chosen scores' sum


class TopkRouter(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.top_k = config.num_experts_per_tok
        self.scaling = config.routed_scaling_factor
        self.weight = nn.Parameter(torch.empty(config.n_routed_experts, config.hidden_size))
        self.register_buffer("e_score_correction_bias", torch.zeros(config.n_routed_experts))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N, H] -> (experts [N, k] int64, weights [N, k] float32)."""
        scores = torch.sigmoid(F.linear(x.float(), self.weight.float()))
        chosen = torch.topk(scores + self.e_score_correction_bias.float(), self.top_k, dim=-1, sorted=False).indices
        w = scores.gather(1, chosen)
        return chosen, w * (self.scaling / (w.sum(dim=-1, keepdim=True) + NORM_EPS))


class Experts(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        e, h, i = config.held_experts, config.hidden_size, config.moe_intermediate_size
        self.gated = config.mlp_hidden_act == "silu"
        if self.gated:  # SwiGLU: gate rows, then up rows
            self.gate_up_proj = nn.Parameter(torch.empty(e, 2 * i, h))
        else:  # squared ReLU
            self.up_proj = nn.Parameter(torch.empty(e, i, h))
        self.down_proj = nn.Parameter(torch.empty(e, h, i))
        self.offset, self.router_width = config.expert_offset, config.n_routed_experts

    @property
    def whole(self) -> bool:
        """Whether the layer holds every expert of its router."""
        return self.down_proj.shape[0] == self.router_width

    def routed(self, x: torch.Tensor, chosen: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Only the chosen (token, expert) pairs of held experts. x [N, H],
        chosen [N, k] router ids -> float32 [N, H]."""
        k = chosen.shape[1]
        flat = chosen.flatten()
        held = self.down_proj.shape[0]
        if not self.whole:  # the held experts' own ids; every absent one past them, sorted last and left out
            flat = flat - self.offset
            flat = torch.where((flat >= 0) & (flat < held), flat, held)
        order = torch.argsort(flat, stable=True)
        token = order // k
        weight = w.flatten()[order]
        out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        start = 0
        for e, n in enumerate(torch.bincount(flat, minlength=held).tolist()[:held]):
            if n:
                rows = token[start:start + n]
                if self.gated:
                    gate, up = F.linear(x.index_select(0, rows), self.gate_up_proj[e]).chunk(2, dim=-1)
                    hidden = F.silu(gate) * up
                else:
                    hidden = F.relu(F.linear(x.index_select(0, rows), self.up_proj[e])).square()
                y = F.linear(hidden, self.down_proj[e])
                out.index_add_(0, rows, y.float() * weight[start:start + n, None])
                start += n
        return out

    def dense(self, x: torch.Tensor, chosen: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Every held expert over every token, weighted by zero where
        unchosen. x [N, H], chosen [N, k] router ids -> float32 [N, H]."""
        e, h, i = self.down_proj.shape
        weights = torch.zeros((x.shape[0], self.router_width), dtype=torch.float32, device=x.device).scatter_(1, chosen, w)
        if not self.whole:
            weights = weights[:, self.offset:self.offset + e]
        if self.gated:
            gate, up = F.linear(x, self.gate_up_proj.view(e * 2 * i, h)).view(-1, e, 2 * i).chunk(2, dim=-1)
            hidden = F.silu(gate) * up
        else:
            hidden = F.relu(F.linear(x, self.up_proj.view(e * i, h)).view(-1, e, i)).square()
        y = torch.bmm(hidden.transpose(0, 1), self.down_proj.transpose(1, 2))  # [E, N, H]
        return torch.einsum("enh,ne->nh", y.float(), weights)


class SquaredReluMLP(nn.Module):
    """The non-gated expert of `mlp_hidden_act` "relu2": down(relu(up(x))^2)."""

    def __init__(self, config: TransformerConfig, intermediate_size: int):
        super().__init__()
        self.up_proj = nn.Linear(config.hidden_size, intermediate_size, bias=False)
        self.down_proj = nn.Linear(intermediate_size, config.hidden_size, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.relu(self.up_proj(x)).square())


class MoE(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.gate = TopkRouter(config)
        self.experts = Experts(config)
        width = config.shared_expert_intermediate_size or config.moe_intermediate_size * config.n_shared_experts
        self.shared_experts = (MLP if config.mlp_hidden_act == "silu" else SquaredReluMLP)(config, width)
        # Decoder.track_pairs' counter ([2, experts]) and track_routes' log ([B, max_len, k]) of this
        # layer, None when no one reads them
        self.pair_counts: Optional[torch.Tensor] = None
        self.route_log: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, S, H]; `rows`: the positions' cache rows, in a call over a
        cache, where the log takes the chosen experts."""
        b, s, h = x.shape
        flat = x.reshape(b * s, h)
        with span("lm.moe.route"):
            chosen, w = self.gate(flat)
            if rows is not None and self.route_log is not None and self.route_log.shape[0] == b:
                self.route_log.index_copy_(1, rows, chosen.view(b, s, -1).to(self.route_log.dtype))
            if self.pair_counts is not None:
                pairs = chosen.flatten()
                self.pair_counts[int(s == 1)].index_add_(0, pairs, torch.ones_like(pairs))
        with span("lm.moe.experts"):
            y = self.experts.dense(flat, chosen, w) if s == 1 else self.experts.routed(flat, chosen, w)
        with span("lm.moe.shared"):
            y = y + self.shared_experts(flat).float()
        return y.to(x.dtype).view(b, s, h)


class Block(nn.Module):
    """Pre-norm block: latent attention, then the layer's MLP or MoE."""

    def __init__(self, config: TransformerConfig, layer: int):
        super().__init__()
        self.self_attn = LatentAttention(config)
        self.mlp = MoE(config) if layer >= config.first_k_dense_replace else MLP(config)
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps)

    def forward(self, x, cos, sin, mask, cache: Optional[Sequence[torch.Tensor]] = None, cache_rows=None,
                mask_pos: Optional[torch.Tensor] = None):
        """`transformer.Block`'s call; `cache` is the layer's ("kv",) of the
        cache; `mask_pos` the positions of the decoder's own causal mask
        (`LatentAttention.forward`), in place of Qwen2's `mask_is_causal`."""
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, mask, None if cache is None else cache[0], cache_rows,
                               mask_pos)
        h = self.post_attention_layernorm(x)
        return x + (self.mlp(h, cache_rows) if isinstance(self.mlp, MoE) else self.mlp(h))
