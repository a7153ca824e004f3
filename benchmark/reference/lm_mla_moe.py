"""Plain reference of the slow-fast LM with a DeepSeek-V3 slow decoder:
multi-head latent attention in its expanded form (queries and keys of
qk_nope_head_dim + qk_rope_head_dim a head, RoPE on the rope parts in
DeepSeek's interleaved pairs, a float32 softmax), a dense first block, then
mixtures of experts (sigmoid scores, top-k by score + correction bias,
weights normalised and scaled, each expert looped over on the tokens routed
to it, plus the shared experts). The embedding, the fast depth decoder and
the heads are `reference/lm.py`'s.

Stands for `dmel_codec_tpu_torch/models/deepseek_v3.py` (`LatentAttention`,
whose decode takes the absorbed form of the same product, `MoE`, `Block`)
and `models/transformer.py` (`Decoder` of kind "deepseek_v3"), and `models/lm.py` `ChatMusicLM.forward`; HF
`DeepseekV3Attention` (without query compression) and `DeepseekV3MoE`. No
JAX counterpart. Configuration keys at the top level, as HF's config.json
names them; parameters by HF DeepseekV3's names, the experts stacked as
`mlp.experts.gate_up_proj` [E, 2 I, H] (gate rows, then up) and
`mlp.experts.down_proj` [E, H, I].

Every function takes `cast`, applied to each of a layer's tensors when the
layer starts: float32 by default. A layer's tensors are made float32 one
layer at a time, so the reference fits beside a model held in bf16.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import lm as ref_lm

Params = Dict[str, torch.Tensor]
LATENT_NORM_EPS = 1e-6  # HF's kv_a_layernorm keeps DeepseekV3RMSNorm's default
SCORE_NORM_EPS = 1e-20  # HF's guard on the chosen scores' sum


def _float(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def _slow_shapes(cfg: dict) -> List[Tuple[str, tuple]]:
    h, nh, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    e, im = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    shared = im * cfg["n_shared_experts"]
    out = []
    for n in range(cfg["num_hidden_layers"]):
        p = f"slow_decoder.layers.{n}"
        out += [(f"{p}.self_attn.q_proj.weight", (nh * (nope + rope), h)),
                (f"{p}.self_attn.kv_a_proj_with_mqa.weight", (r + rope, h)),
                (f"{p}.self_attn.kv_a_layernorm.weight", (r,)),
                (f"{p}.self_attn.kv_b_proj.weight", (nh * (nope + v), r)),
                (f"{p}.self_attn.o_proj.weight", (h, nh * v))]
        if n < cfg["first_k_dense_replace"]:
            i = cfg["intermediate_size"]
            out += [(f"{p}.mlp.gate_proj.weight", (i, h)), (f"{p}.mlp.up_proj.weight", (i, h)),
                    (f"{p}.mlp.down_proj.weight", (h, i))]
        else:
            out += [(f"{p}.mlp.gate.weight", (e, h)), (f"{p}.mlp.gate.e_score_correction_bias", (e,)),
                    (f"{p}.mlp.experts.gate_up_proj", (e, 2 * im, h)), (f"{p}.mlp.experts.down_proj", (e, h, im)),
                    (f"{p}.mlp.shared_experts.gate_proj.weight", (shared, h)),
                    (f"{p}.mlp.shared_experts.up_proj.weight", (shared, h)),
                    (f"{p}.mlp.shared_experts.down_proj.weight", (h, shared))]
        out += [(f"{p}.input_layernorm.weight", (h,)), (f"{p}.post_attention_layernorm.weight", (h,))]
    return out + [("slow_decoder.norm.weight", (h,))]


def param_shapes(cfg: dict) -> "OrderedDict[str, tuple]":
    """Every parameter (and the routers' correction biases) of the
    slow-fast LM, by name, in a fixed order."""
    h, hf = cfg["hidden_size"], cfg["fast"]["hidden_size"]
    c = cfg["audio_codebook_count"]
    av = c * cfg["audio_codebook_size"]
    out = [("text_embed.weight", (cfg["vocab_size"], h)), ("slow_audio_embed.weight", (av, h)),
           ("audio_projector.weight", (h, c * h))]
    out += _slow_shapes(cfg)
    out += [("fast_pre_norm.weight", (h,)), ("fast_projector.weight", (hf, h)), ("fast_projector.bias", (hf,)),
            ("fast_audio_embed.weight", (av, hf))]
    out += ref_lm._decoder_shapes("fast_decoder", cfg["fast"])
    out += [("text_head.weight", (cfg["vocab_size"], h)), ("audio_head.weight", (av, hf))]
    return OrderedDict(out)


def rope_interleaved(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """HF `apply_rotary_pos_emb_interleave`: x [B, S, heads, d]; the pairs
    (x0, x1), (x2, x3), .. gathered into halves, then the half-duplicated
    rotation."""
    b, s, nh, d = x.shape
    return ref_lm.rope(x.reshape(b, s, nh, d // 2, 2).transpose(3, 4).reshape(b, s, nh, d), positions, theta)


def attention(w: Params, cfg: dict, y: torch.Tensor, pos: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
    """MLA, expanded: every head's k_nope and value from the latent."""
    b, s, _ = y.shape
    nh, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q = F.linear(y, w["self_attn.q_proj.weight"]).view(b, s, nh, nope + rope)
    q_nope, q_pe = q.split([nope, rope], dim=-1)
    c, k_pe = F.linear(y, w["self_attn.kv_a_proj_with_mqa.weight"]).split([r, rope], dim=-1)
    c = ref_lm.rms_norm(c, w["self_attn.kv_a_layernorm.weight"], LATENT_NORM_EPS)
    k_nope, value = F.linear(c, w["self_attn.kv_b_proj.weight"]).view(b, s, nh, nope + v).split([nope, v], dim=-1)
    q_pe = rope_interleaved(q_pe, pos, cfg["rope_theta"])
    k_pe = rope_interleaved(k_pe[:, :, None, :], pos, cfg["rope_theta"])
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, s, nh, rope)], dim=-1)
    scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(nope + rope)
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    att = torch.einsum("bhst,bthd->bshd", probs, value).reshape(b, s, nh * v)
    return F.linear(att, w["self_attn.o_proj.weight"])


def swiglu(w: Params, prefix: str, y: torch.Tensor) -> torch.Tensor:
    return F.linear(F.silu(F.linear(y, w[f"{prefix}.gate_proj.weight"])) * F.linear(y, w[f"{prefix}.up_proj.weight"]),
                    w[f"{prefix}.down_proj.weight"])


def route(w: Params, cfg: dict, t: torch.Tensor, forced: Optional[torch.Tensor] = None):
    """t [N, H] -> (experts computed with [N, k], their weights [N, k], the
    reference's own choices [N, k], the gap [N] by which the computed
    experts' lowest score + bias lies below the k-th best). `forced`: the
    experts to compute with (another's choices) instead of its own; the
    weights are then the reference's scores of those experts."""
    scores = torch.sigmoid(F.linear(t, w["mlp.gate.weight"]))
    biased = scores + w["mlp.gate.e_score_correction_bias"]
    best = torch.topk(biased, cfg["num_experts_per_tok"], dim=-1)
    chosen = best.indices if forced is None else forced
    gap = best.values[:, -1] - biased.gather(1, chosen).min(-1).values
    weights = scores.gather(1, chosen)
    weights = weights / (weights.sum(-1, keepdim=True) + SCORE_NORM_EPS) * cfg["routed_scaling_factor"]
    return chosen, weights, best.indices, gap


def moe(w: Params, cfg: dict, y: torch.Tensor, routes: Optional[list] = None,
        forced: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The routed experts, one at a time on the tokens routed to it, plus
    the shared experts. `forced` [N, k]: compute with those experts;
    `routes` receives (own choices [N, k], gap [N]) of `route`."""
    t = y.reshape(-1, y.shape[-1])
    chosen, weights, own, gap = route(w, cfg, t, forced)
    if routes is not None:
        routes.append((own, gap))
    out = torch.zeros_like(t)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        if tok.numel():
            gate, up = F.linear(t[tok], w["mlp.experts.gate_up_proj"][e]).chunk(2, dim=-1)
            out[tok] += F.linear(F.silu(gate) * up, w["mlp.experts.down_proj"][e]) * weights[tok, slot, None]
    return (out + swiglu(w, "mlp.shared_experts", t)).view(y.shape)


def decoder(p: Params, cfg: dict, x: torch.Tensor, cast: Callable = _float, routes: Optional[list] = None,
            forced: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The slow decoder over embeddings x [B, S, H], causal, float32 ->
    final-normed hidden; each layer's tensors `cast` as the layer starts.
    `forced` [MoE layers, B * S, k]: each MoE layer computes with those
    experts; `routes` receives each MoE layer's (own choices, gap), see
    `route`."""
    b, s, _ = x.shape
    eps = cfg["rms_norm_eps"]
    pos = torch.arange(s, device=x.device).expand(b, s)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    x = x.float()
    for n in range(cfg["num_hidden_layers"]):
        prefix = f"slow_decoder.layers.{n}."
        w = {k[len(prefix):]: cast(v) for k, v in p.items() if k.startswith(prefix)}
        x = x + attention(w, cfg, ref_lm.rms_norm(x, w["input_layernorm.weight"], eps), pos, causal)
        y = ref_lm.rms_norm(x, w["post_attention_layernorm.weight"], eps)
        if n < cfg["first_k_dense_replace"]:
            x = x + swiglu(w, "mlp", y)
        else:
            x = x + moe(w, cfg, y, routes, None if forced is None else forced[n - cfg["first_k_dense_replace"]])
        del w
    return ref_lm.rms_norm(x, cast(p["slow_decoder.norm.weight"]), eps)


def outer(p: Params, cast: Callable = _float) -> Params:
    """Every tensor outside the slow decoder's layers, cast whole."""
    return {k: cast(v) for k, v in p.items() if not k.startswith("slow_decoder.layers.")}


def losses(p: Params, cfg: dict, batch: Dict[str, torch.Tensor], counts: Tuple[float, float]):
    """(text CE sum / counts[0], audio CE sum / counts[1]): `reference/lm.py`
    `losses` with this slow decoder."""
    c = cfg["audio_codebook_count"]
    q = outer(p)
    x = ref_lm.embed(q, cfg, batch["text_tokens"], batch["audio_tokens"]) * batch["valid"][..., None]
    b, s, _ = x.shape
    hid = decoder(p, cfg, x)
    text_logits = F.linear(hid, q["text_head.weight"])
    text_sum = F.cross_entropy(text_logits[:, :-1].reshape(-1, text_logits.shape[-1]), batch["text_labels"][:, 1:].reshape(-1),
                               ignore_index=ref_lm.IGNORE, reduction="sum")
    frame_labels = batch["audio_labels"][:, 1:, :]
    fast_ids = frame_labels.masked_fill(frame_labels == ref_lm.IGNORE, cfg["fast_audio_pad_id"])
    h = F.linear(ref_lm.rms_norm(hid[:, :-1], q["fast_pre_norm.weight"], cfg["fast"]["rms_norm_eps"]),
                 q["fast_projector.weight"], q["fast_projector.bias"])
    emb = F.embedding(fast_ids, q["fast_audio_embed.weight"]) * (fast_ids != cfg["fast_audio_pad_id"])[..., None]
    fast_in = torch.cat([h[:, :, None, :], emb], dim=2).reshape(b * (s - 1), c + 1, -1)
    audio_logits = F.linear(ref_lm.decoder(q, "fast_decoder", cfg["fast"], fast_in), q["audio_head.weight"])
    depth = torch.cat([batch["text_labels"][:, 1:].reshape(b * (s - 1), 1), frame_labels.reshape(b * (s - 1), c)], dim=1)
    audio_sum = F.cross_entropy(audio_logits[:, :-1].reshape(-1, audio_logits.shape[-1]), depth[:, 1:].reshape(-1),
                                ignore_index=ref_lm.IGNORE, reduction="sum")
    return text_sum / counts[0], audio_sum / counts[1]
