"""Plain reference of the slow-fast LM with a Kimi Linear slow decoder
(HF `KimiDecoderLayer` of moonshotai/Kimi-Linear-48B-A3B; "Kimi Linear: An
Expressive, Efficient Attention Architecture", arXiv:2510.26692): Kimi
Delta Attention (KDA) in the layers linear_attn_config["kda_layers"]
(counted from 1), NoPE latent attention in the others, a dense first
block, then mixtures of experts (`reference/lm_mla_moe.py`'s router). The
embedding, the fast depth decoder and the heads are `reference/lm.py`'s.

KDA, fla's `naive_recurrent_kda` and the paper's section 3, position by
position (not the chunked form): q~, k~, v~ = SiLU(causal depthwise conv of
W_q x, W_k x, W_v x); q, k l2-normalised per head (x * rsqrt(sum x^2 +
1e-6)); the gate a = -exp(A_log[h]) * softplus(W_fb W_fa x + dt_bias), one
a channel; beta = sigmoid(W_b x); S = diag(exp(a)) S, then S += beta k (v -
S^T k)^T; o = d^-1/2 S^T q; y = W_o [RMSNorm(o) * o_norm.weight *
sigmoid(W_gb W_ga x)]. Latent attention: HF DeepseekV3Attention without
query compression and without rotation (mla_use_nope), its queries in
blocks so that a long sequence fits, kv_a_layernorm at rms_norm_eps.

Stands for `dmel_codec_tpu_torch/models/kimi_linear.py` (`KimiDeltaAttention`,
whose prefill takes the chunked form of the same recurrence and whose
decode steps it in place; `Block`), `models/deepseek_v3.py` (`LatentAttention`
with `mla_use_nope`, `MoE` with its expert share) and `models/transformer.py`
(`Decoder` of kind "kimi_linear"). No JAX counterpart. Configuration keys
at the top level as HF's config.json names them; parameters by HF's names.

Departures from the published model, as the program has them:
  * the held share: each MoE layer holds num_experts (64) of the router's
    published_num_experts (256), those of expert_parallel["rank"]; the
    router scores and selects over all 256, and only the held experts' part
    of the routed sum is added (the other ranks' is left out), the shared
    expert counted whole (`moe`);
  * the experts stacked per layer (`mlp.experts.gate_up_proj` [held, 2 I,
    H], gate rows then up; `mlp.experts.down_proj` [held, H, I]), where HF
    holds one module an expert.

Every function takes `cast`, applied to each of a layer's tensors when the
layer starts: float32 by default, one layer at a time.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import lm as ref_lm
from benchmark.reference import lm_mla_moe as ref_mla

Params = Dict[str, torch.Tensor]
L2NORM_EPS = 1e-6  # fla's l2norm
QUERY_BLOCK = 512  # queries a block of latent attention's scores


def kda_layers(cfg: dict) -> List[int]:
    """The KDA layers, counted from 0 (the config counts from 1)."""
    return [n - 1 for n in cfg["linear_attn_config"]["kda_layers"]]


def held(cfg: dict) -> Tuple[int, int]:
    """(first held expert, experts held): rank r of the expert-parallel
    deployment holds num_experts of them from r * num_experts."""
    n = cfg["num_experts"]
    return cfg["expert_parallel"]["rank"] * n, n


def _slow_shapes(cfg: dict) -> List[Tuple[str, tuple]]:
    h, nh, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    lin = cfg["linear_attn_config"]
    kh, kd, taps = lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]
    width = kh * kd
    e, im, router = cfg["num_experts"], cfg["moe_intermediate_size"], cfg["published_num_experts"]
    shared = im * cfg["num_shared_experts"]
    kda = set(kda_layers(cfg))
    out = []
    for n in range(cfg["num_hidden_layers"]):
        p = f"slow_decoder.layers.{n}"
        if n in kda:
            a = f"{p}.self_attn"
            out += [(f"{a}.q_proj.weight", (width, h)), (f"{a}.k_proj.weight", (width, h)),
                    (f"{a}.v_proj.weight", (width, h)), (f"{a}.q_conv1d.weight", (width, 1, taps)),
                    (f"{a}.k_conv1d.weight", (width, 1, taps)), (f"{a}.v_conv1d.weight", (width, 1, taps)),
                    (f"{a}.f_a_proj.weight", (kd, h)), (f"{a}.f_b_proj.weight", (width, kd)),
                    (f"{a}.A_log", (kh,)), (f"{a}.dt_bias", (width,)), (f"{a}.b_proj.weight", (kh, h)),
                    (f"{a}.g_a_proj.weight", (kd, h)), (f"{a}.g_b_proj.weight", (width, kd)),
                    (f"{a}.o_norm.weight", (kd,)), (f"{a}.o_proj.weight", (h, width))]
        else:
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
            out += [(f"{p}.mlp.gate.weight", (router, h)), (f"{p}.mlp.gate.e_score_correction_bias", (router,)),
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


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + L2NORM_EPS)


def short_conv(u: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise convolution over time: u [B, S, c],
    weight [c, 1, taps]."""
    s, taps = u.shape[1], weight.shape[-1]
    y = F.conv1d(u.transpose(1, 2), weight, padding=taps - 1, groups=u.shape[-1])[..., :s]
    return F.silu(y.transpose(1, 2))


def kda(w: Params, cfg: dict, y: torch.Tensor) -> torch.Tensor:
    """Kimi Delta Attention over y [B, S, H], position by position."""
    b, s, _ = y.shape
    lin = cfg["linear_attn_config"]
    nh, d = lin["num_heads"], lin["head_dim"]
    a = "self_attn."
    q, k, v = (short_conv(F.linear(y, w[f"{a}{n}_proj.weight"]), w[f"{a}{n}_conv1d.weight"]).view(b, s, nh, d)
               for n in "qkv")
    q, k = l2norm(q) / math.sqrt(d), l2norm(k)
    pre = F.linear(F.linear(y, w[f"{a}f_a_proj.weight"]), w[f"{a}f_b_proj.weight"]) + w[f"{a}dt_bias"]
    decay = torch.exp(-torch.exp(w[f"{a}A_log"])[:, None] * F.softplus(pre.view(b, s, nh, d)))
    beta = torch.sigmoid(F.linear(y, w[f"{a}b_proj.weight"]))
    # each (row, head) a sequence of its own: [B * heads, S, d], the state [B * heads, d (key), d (value)]
    qs, ks, vs, ds = (t.transpose(1, 2).reshape(b * nh, s, d) for t in (q, k, v, decay))
    bks = beta.transpose(1, 2).reshape(b * nh, s, 1) * ks
    state = y.new_zeros(b * nh, d, d)
    o = y.new_empty(s, b * nh, 1, d)
    for t in range(s):
        state.mul_(ds[:, t, :, None])
        err = vs[:, t:t + 1] - torch.bmm(ks[:, t:t + 1], state)
        state.baddbmm_(bks[:, t:t + 1].transpose(1, 2), err)
        torch.bmm(qs[:, t:t + 1], state, out=o[t])
    o = o.view(s, b, nh, d).transpose(0, 1)
    gate = torch.sigmoid(F.linear(F.linear(y, w[f"{a}g_a_proj.weight"]), w[f"{a}g_b_proj.weight"]))
    out = ref_lm.rms_norm(o, w[f"{a}o_norm.weight"], cfg["rms_norm_eps"]) * gate.view(b, s, nh, d)
    return F.linear(out.reshape(b, s, nh * d), w[f"{a}o_proj.weight"])


def attention(w: Params, cfg: dict, y: torch.Tensor) -> torch.Tensor:
    """Causal latent attention without rotation, expanded (every head's
    k_nope and value from the latent), QUERY_BLOCK queries at a time."""
    b, s, _ = y.shape
    nh, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q = F.linear(y, w["self_attn.q_proj.weight"]).view(b, s, nh, nope + rope)
    c, k_pe = F.linear(y, w["self_attn.kv_a_proj_with_mqa.weight"]).split([r, rope], dim=-1)
    c = ref_lm.rms_norm(c, w["self_attn.kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    k_nope, value = F.linear(c, w["self_attn.kv_b_proj.weight"]).view(b, s, nh, nope + v).split([nope, v], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, nh, rope)], dim=-1)
    att = y.new_empty(b, s, nh, v)
    for lo in range(0, s, QUERY_BLOCK):
        hi = min(s, lo + QUERY_BLOCK)
        scores = torch.einsum("bshd,bthd->bhst", q[:, lo:hi], k[:, :hi]) / math.sqrt(nope + rope)
        visible = torch.arange(hi, device=y.device)[None, :] <= torch.arange(lo, hi, device=y.device)[:, None]
        probs = torch.softmax(scores.masked_fill(~visible, float("-inf")), dim=-1)
        att[:, lo:hi] = torch.einsum("bhst,bthd->bshd", probs, value[:, :hi])
    return F.linear(att.reshape(b, s, nh * v), w["self_attn.o_proj.weight"])


def route_cfg(cfg: dict) -> dict:
    """`lm_mla_moe.route`'s keys of this configuration."""
    return {"num_experts_per_tok": cfg["num_experts_per_token"], "routed_scaling_factor": cfg["routed_scaling_factor"]}


def moe(w: Params, cfg: dict, y: torch.Tensor, routes: Optional[list] = None,
        forced: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The held routed experts, one at a time on the tokens routed to it,
    plus the shared expert. The router scores every expert; `forced` [N, k]
    (router ids): compute with those experts; `routes` receives (own
    choices [N, k], gap [N]) of `lm_mla_moe.route`."""
    t = y.reshape(-1, y.shape[-1])
    chosen, weights, own, gap = ref_mla.route(w, route_cfg(cfg), t, forced)
    if routes is not None:
        routes.append((own, gap))
    first, n = held(cfg)
    out = torch.zeros_like(t)
    for e in range(first, first + n):
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        if tok.numel():
            gate, up = F.linear(t[tok], w["mlp.experts.gate_up_proj"][e - first]).chunk(2, dim=-1)
            out[tok] += F.linear(F.silu(gate) * up, w["mlp.experts.down_proj"][e - first]) * weights[tok, slot, None]
    return (out + ref_mla.swiglu(w, "mlp.shared_experts", t)).view(y.shape)


def decoder(p: Params, cfg: dict, x: torch.Tensor, cast: Callable = ref_mla._float, routes: Optional[list] = None,
            forced: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The slow decoder over embeddings x [B, S, H], causal, float32 ->
    final-normed hidden; each layer's tensors `cast` as the layer starts.
    `forced` [MoE layers, B * S, k]: each MoE layer computes with those
    experts; `routes` receives each MoE layer's (own choices, gap)."""
    eps = cfg["rms_norm_eps"]
    kda_at = set(kda_layers(cfg))
    dense = cfg["first_k_dense_replace"]
    x = x.float()
    for n in range(cfg["num_hidden_layers"]):
        prefix = f"slow_decoder.layers.{n}."
        w = {k[len(prefix):]: cast(v) for k, v in p.items() if k.startswith(prefix)}
        y = ref_lm.rms_norm(x, w["input_layernorm.weight"], eps)
        x = x + (kda(w, cfg, y) if n in kda_at else attention(w, cfg, y))
        y = ref_lm.rms_norm(x, w["post_attention_layernorm.weight"], eps)
        if n < dense:
            x = x + ref_mla.swiglu(w, "mlp", y)
        else:
            x = x + moe(w, cfg, y, routes, None if forced is None else forced[n - dense])
        del w
    return ref_lm.rms_norm(x, cast(p["slow_decoder.norm.weight"]), eps)


outer = ref_mla.outer
