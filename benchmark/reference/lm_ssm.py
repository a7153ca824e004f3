"""Plain reference of the slow-fast LM with a Nemotron-H slow decoder (HF
`NemotronHForCausalLM` of nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B,
`modeling_nemotron_h`): one mixer a block by the layer's letter of
`hybrid_override_pattern` — "M" Mamba-2 ("Transformers are SSMs",
arXiv:2405.21060), "E" a mixture of squared-ReLU experts
(`reference/lm_mla_moe.py`'s router), "*" grouped-query attention without
positions — each block x + mixer(RMSNorm(x)), then a final norm. The
embedding, the fast depth decoder and the heads are `reference/lm.py`'s.

Mamba-2, HF `NemotronHMamba2Mixer.torch_forward` position by position (the
recurrence, not the chunked form): [z | xBC | dt] = in_proj(x); xBC =
SiLU(causal depthwise conv1d + bias) split into x [heads, P], B, C [groups,
N], head h reading group h // (heads / groups); dt = softplus(dt +
dt_bias), unclamped; h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T with A =
-exp(A_log); y_t = h_t C_t + D x_t; out_proj(RMSNorm over groups of
heads P / groups channels of y * SiLU(z), times its weight). Attention:
HF `NemotronHAttention`, q, k, v, o without bias, heads of head_dim, the
key / value heads repeated over their query heads, scale head_dim^-1/2,
causal, no rotation, queries in blocks so that a long sequence fits.
Experts: sigmoid scores, top num_experts_per_tok by score + correction
bias, weights normalised and scaled by routed_scaling_factor; each expert
down(relu(up(x))^2), plus the shared expert of
moe_shared_expert_intermediate_size.

Stands for `dmel_codec_tpu_torch/models/nemotron_h.py` (`Mamba2Mixer`,
whose prefill takes the chunked form of the same recurrence and whose
decode steps it in place; `NoPEAttention`, whose prefill runs FA; `Block`),
`models/deepseek_v3.py` (`MoE` with `mlp_hidden_act` "relu2" and its expert
share) and `models/transformer.py` (`Decoder` of kind "nemotron_h"). No
JAX counterpart. Configuration keys at the top level as HF's config.json
names them; parameters by HF's names under `slow_decoder.layers.<n>.`.

Departures from the published model, as the program has them:
  * the held share: each MoE layer holds n_routed_experts (64) of the
    router's published_n_routed_experts (128), those of
    expert_parallel["rank"]; the router scores and selects over all 128, and
    only the held experts' part of the routed sum is added (the other
    rank's is left out), the shared expert counted whole (`moe`);
  * the experts stacked per layer (`mixer.experts.up_proj` [held, I, H],
    `mixer.experts.down_proj` [held, H, I]), where HF holds one module an
    expert;
  * HF's gated norm rounds y * SiLU(z), normed, to the input dtype before
    its weight; here everything is float32 (`cast`'s precision).

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
QUERY_BLOCK = 512  # queries a block of attention's scores


def held(cfg: dict) -> Tuple[int, int]:
    """(first held expert, experts held): rank r of the expert-parallel
    deployment holds n_routed_experts of them from r * n_routed_experts."""
    n = cfg["n_routed_experts"]
    return cfg["expert_parallel"]["rank"] * n, n


def _mamba_sizes(cfg: dict) -> Tuple[int, int, int, int]:
    return cfg["mamba_num_heads"], cfg["mamba_head_dim"], cfg["n_groups"], cfg["ssm_state_size"]


def _slow_shapes(cfg: dict) -> List[Tuple[str, tuple]]:
    h, nh, kv, d = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    mh, p, g, n = _mamba_sizes(cfg)
    inner, conv = mh * p, mh * p + 2 * g * n
    e, im, router = cfg["n_routed_experts"], cfg["moe_intermediate_size"], cfg["published_n_routed_experts"]
    shared = cfg["moe_shared_expert_intermediate_size"]
    out = []
    for i, kind in enumerate(cfg["hybrid_override_pattern"]):
        m = f"slow_decoder.layers.{i}.mixer"
        out.append((f"slow_decoder.layers.{i}.norm.weight", (h,)))
        if kind == "M":
            out += [(f"{m}.in_proj.weight", (inner + conv + mh, h)), (f"{m}.conv1d.weight", (conv, 1, cfg["conv_kernel"])),
                    (f"{m}.conv1d.bias", (conv,)), (f"{m}.dt_bias", (mh,)), (f"{m}.A_log", (mh,)), (f"{m}.D", (mh,)),
                    (f"{m}.norm.weight", (inner,)), (f"{m}.out_proj.weight", (h, inner))]
        elif kind == "*":
            out += [(f"{m}.q_proj.weight", (nh * d, h)), (f"{m}.k_proj.weight", (kv * d, h)),
                    (f"{m}.v_proj.weight", (kv * d, h)), (f"{m}.o_proj.weight", (h, nh * d))]
        else:
            out += [(f"{m}.gate.weight", (router, h)), (f"{m}.gate.e_score_correction_bias", (router,)),
                    (f"{m}.experts.up_proj", (e, im, h)), (f"{m}.experts.down_proj", (e, h, im)),
                    (f"{m}.shared_experts.up_proj.weight", (shared, h)),
                    (f"{m}.shared_experts.down_proj.weight", (h, shared))]
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


def mamba(w: Params, cfg: dict, y: torch.Tensor) -> torch.Tensor:
    """The Mamba-2 mixer over y [B, S, H], position by position."""
    b, s, _ = y.shape
    nh, p, g, n = _mamba_sizes(cfg)
    inner, taps = nh * p, cfg["conv_kernel"]
    z, xbc, dt = F.linear(y, w["mixer.in_proj.weight"]).split([inner, inner + 2 * g * n, nh], dim=-1)
    xbc = F.conv1d(xbc.transpose(1, 2), w["mixer.conv1d.weight"], w["mixer.conv1d.bias"], padding=taps - 1,
                   groups=xbc.shape[-1])[..., :s]
    x, bs, cs = F.silu(xbc.transpose(1, 2)).split([inner, g * n, g * n], dim=-1)
    dt = F.softplus(dt + w["mixer.dt_bias"])  # [B, S, heads]
    decay = torch.exp(dt * -torch.exp(w["mixer.A_log"]))
    x = x.reshape(b, s, nh, p)
    # each (row, head) a sequence of its own, position-major: [S, B * heads, ...]
    by_head = lambda t, *shape: t.transpose(0, 1).reshape(s, b * nh, *shape).contiguous()  # noqa: E731
    bs, cs = (t.reshape(b, s, g, 1, n).expand(b, s, g, nh // g, n) for t in (bs, cs))
    decays, inputs = by_head(decay, 1, 1), by_head(x * dt[..., None], p, 1)
    bh, ch = by_head(bs, 1, n), by_head(cs, n, 1)
    state = y.new_zeros(b * nh, p, n)
    out = y.new_empty(s, b * nh, p, 1)
    for t in range(s):
        state.mul_(decays[t])
        state.baddbmm_(inputs[t], bh[t])
        torch.bmm(state, ch[t], out=out[t])
    out = out.view(s, b, nh, p).transpose(0, 1) + w["mixer.D"][:, None] * x
    gated = (out.reshape(b, s, inner) * F.silu(z)).view(b, s, g, inner // g)
    normed = gated * torch.rsqrt(gated.square().mean(-1, keepdim=True) + cfg["layer_norm_epsilon"])
    return F.linear(normed.reshape(b, s, inner) * w["mixer.norm.weight"], w["mixer.out_proj.weight"])


def attention(w: Params, cfg: dict, y: torch.Tensor) -> torch.Tensor:
    """Causal grouped-query attention without rotation, QUERY_BLOCK queries
    at a time."""
    b, s, _ = y.shape
    nh, kv, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    q = F.linear(y, w["mixer.q_proj.weight"]).view(b, s, nh, d)
    k, v = (F.linear(y, w[f"mixer.{n}_proj.weight"]).view(b, s, kv, d).repeat_interleave(nh // kv, dim=2)
            for n in "kv")
    att = y.new_empty(b, s, nh, d)
    for lo in range(0, s, QUERY_BLOCK):
        hi = min(s, lo + QUERY_BLOCK)
        scores = torch.einsum("bshd,bthd->bhst", q[:, lo:hi], k[:, :hi]) / math.sqrt(d)
        visible = torch.arange(hi, device=y.device)[None, :] <= torch.arange(lo, hi, device=y.device)[:, None]
        probs = torch.softmax(scores.masked_fill(~visible, float("-inf")), dim=-1)
        att[:, lo:hi] = torch.einsum("bhst,bthd->bshd", probs, v[:, :hi])
    return F.linear(att.reshape(b, s, nh * d), w["mixer.o_proj.weight"])


def relu2(w: Params, prefix: str, y: torch.Tensor) -> torch.Tensor:
    return F.linear(F.relu(F.linear(y, w[f"{prefix}.up_proj.weight"])).square(), w[f"{prefix}.down_proj.weight"])


def moe(w: Params, cfg: dict, y: torch.Tensor, routes: Optional[list] = None,
        forced: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The held routed experts, one at a time on the tokens routed to it,
    plus the shared expert. The router scores every expert; `forced` [N, k]
    (router ids): compute with those experts; `routes` receives (own
    choices [N, k], gap [N]) of `lm_mla_moe.route`."""
    t = y.reshape(-1, y.shape[-1])
    gate = {f"mlp.gate.{n}": w[f"mixer.gate.{n}"] for n in ("weight", "e_score_correction_bias")}
    chosen, weights, own, gap = ref_mla.route(gate, cfg, t, forced)
    if routes is not None:
        routes.append((own, gap))
    first, n = held(cfg)
    out = torch.zeros_like(t)
    for e in range(first, first + n):
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        if tok.numel():
            up = F.relu(F.linear(t[tok], w["mixer.experts.up_proj"][e - first])).square()
            out[tok] += F.linear(up, w["mixer.experts.down_proj"][e - first]) * weights[tok, slot, None]
    return (out + relu2(w, "mixer.shared_experts", t)).view(y.shape)


def decoder(p: Params, cfg: dict, x: torch.Tensor, cast: Callable = ref_mla._float, routes: Optional[list] = None,
            forced: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The slow decoder over embeddings x [B, S, H], causal, float32 ->
    final-normed hidden; each layer's tensors `cast` as the layer starts.
    `forced` [MoE layers, B * S, k]: each MoE layer computes with those
    experts; `routes` receives each MoE layer's (own choices, gap)."""
    eps = cfg["layer_norm_epsilon"]
    x = x.float()
    moe_layer = 0
    for i, kind in enumerate(cfg["hybrid_override_pattern"]):
        prefix = f"slow_decoder.layers.{i}."
        w = {k[len(prefix):]: cast(v) for k, v in p.items() if k.startswith(prefix)}
        y = ref_lm.rms_norm(x, w["norm.weight"], eps)
        if kind == "M":
            x = x + mamba(w, cfg, y)
        elif kind == "*":
            x = x + attention(w, cfg, y)
        else:
            x = x + moe(w, cfg, y, routes, None if forced is None else forced[moe_layer])
            moe_layer += 1
        del w
    return ref_lm.rms_norm(x, cast(p["slow_decoder.norm.weight"]), eps)


outer = ref_mla.outer
