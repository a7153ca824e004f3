"""Plain reference of the slow-fast LM: Qwen2-style decoders (pre-RMSNorm,
RoPE theta 1e6 in the half-duplicated layout, grouped-query attention with
q / k / v biases, SiLU-gated MLP), the multimodal embedding, the fast depth
decoder and the training loss; and a plain AdamW with gradient
accumulation and clipping by the global norm.

Stands for `dmel_codec_tpu_torch/models/transformer.py` (`Decoder`, with
attention written out: FA on the card), `models/lm.py` (`ChatMusicLM`:
`embed_inputs`, `forward`), `train/lm_trainer.py` (`_LossModule`,
`_decay_mask`), `train/optim.py` (`AccumulatingAdamW`) and
`train/schedule.py`; the JAX package's modules of the same names. Parameters
by the Hugging Face Qwen2 names the port uses.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
IGNORE = -100


def _decoder_shapes(prefix: str, d: dict) -> List[Tuple[str, tuple]]:
    h, i, hd = d["hidden_size"], d["intermediate_size"], d["hidden_size"] // d["num_heads"]
    out = []
    for n in range(d["num_layers"]):
        p = f"{prefix}.layers.{n}"
        out += [(f"{p}.self_attn.q_proj.weight", (d["num_heads"] * hd, h)), (f"{p}.self_attn.q_proj.bias", (d["num_heads"] * hd,)),
                (f"{p}.self_attn.k_proj.weight", (d["num_kv_heads"] * hd, h)), (f"{p}.self_attn.k_proj.bias", (d["num_kv_heads"] * hd,)),
                (f"{p}.self_attn.v_proj.weight", (d["num_kv_heads"] * hd, h)), (f"{p}.self_attn.v_proj.bias", (d["num_kv_heads"] * hd,)),
                (f"{p}.self_attn.o_proj.weight", (h, d["num_heads"] * hd)),
                (f"{p}.mlp.gate_proj.weight", (i, h)), (f"{p}.mlp.up_proj.weight", (i, h)), (f"{p}.mlp.down_proj.weight", (h, i)),
                (f"{p}.input_layernorm.weight", (h,)), (f"{p}.post_attention_layernorm.weight", (h,))]
    return out + [(f"{prefix}.norm.weight", (h,))]


def param_shapes(cfg: dict) -> "OrderedDict[str, tuple]":
    """Every parameter of the slow-fast LM, by name, in a fixed order."""
    s, f = cfg["slow"], cfg["fast"]
    hs, hf = s["hidden_size"], f["hidden_size"]
    av = cfg["audio_codebook_count"] * cfg["audio_codebook_size"]
    out = [("text_embed.weight", (s["vocab_size"], hs)), ("slow_audio_embed.weight", (av, hs)),
           ("audio_projector.weight", (hs, cfg["audio_codebook_count"] * hs))]
    out += _decoder_shapes("slow_decoder", s)
    out += [("fast_pre_norm.weight", (hs,)), ("fast_projector.weight", (hf, hs)), ("fast_projector.bias", (hf,)),
            ("fast_audio_embed.weight", (av, hf))]
    out += _decoder_shapes("fast_decoder", f)
    out += [("text_head.weight", (s["vocab_size"], hs)), ("audio_head.weight", (av, hf))]
    return OrderedDict(out)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return w * (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, hd], positions [B, S]; the half-duplicated layout."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, device=x.device, dtype=torch.float32) / hd))
    ang = positions[..., None].float() * inv
    ang = torch.cat([ang, ang], dim=-1)[:, :, None, :]
    rot = torch.cat([-x[..., hd // 2:], x[..., :hd // 2]], dim=-1)
    return x * torch.cos(ang) + rot * torch.sin(ang)


def decoder(p: Params, prefix: str, d: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal decoder over embeddings x [B, S, H] -> final-normed hidden,
    float32, attention materialised with a float32 softmax."""
    b, s, h = x.shape
    nh, kh = d["num_heads"], d["num_kv_heads"]
    hd, eps = h // nh, d.get("rms_norm_eps", 1e-6)
    pos = torch.arange(s, device=x.device).expand(b, s)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    x = x.float()
    for n in range(d["num_layers"]):
        lp = f"{prefix}.layers.{n}"
        y = rms_norm(x, p[f"{lp}.input_layernorm.weight"], eps)
        q = F.linear(y, p[f"{lp}.self_attn.q_proj.weight"], p[f"{lp}.self_attn.q_proj.bias"]).view(b, s, nh, hd)
        k = F.linear(y, p[f"{lp}.self_attn.k_proj.weight"], p[f"{lp}.self_attn.k_proj.bias"]).view(b, s, kh, hd)
        v = F.linear(y, p[f"{lp}.self_attn.v_proj.weight"], p[f"{lp}.self_attn.v_proj.bias"]).view(b, s, kh, hd)
        q, k = rope(q, pos, d.get("rope_theta", 1e6)), rope(k, pos, d.get("rope_theta", 1e6))
        qg = q.view(b, s, kh, nh // kh, hd)
        scores = torch.einsum("bskgh,btkh->bkgst", qg, k) / math.sqrt(hd)
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        att = torch.einsum("bkgst,btkh->bskgh", probs, v).reshape(b, s, nh * hd)
        x = x + F.linear(att, p[f"{lp}.self_attn.o_proj.weight"])
        y = rms_norm(x, p[f"{lp}.post_attention_layernorm.weight"], eps)
        x = x + F.linear(F.silu(F.linear(y, p[f"{lp}.mlp.gate_proj.weight"])) * F.linear(y, p[f"{lp}.mlp.up_proj.weight"]),
                         p[f"{lp}.mlp.down_proj.weight"])
    return rms_norm(x, p[f"{prefix}.norm.weight"], eps)


def embed(p: Params, cfg: dict, text: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
    """text [B, S], audio [B, S, C] (shifted ids) -> [B, S, H]: the text
    embedding plus the bias-free projection of the concatenated codebook
    embeddings; pad ids embed to zeros."""
    t = F.embedding(text, p["text_embed.weight"]).float() * (text != cfg["text_pad_id"])[..., None]
    a = F.embedding(audio, p["slow_audio_embed.weight"]).float() * (audio != cfg["slow_audio_pad_id"])[..., None]
    return t + F.linear(a.flatten(-2), p["audio_projector.weight"])


def losses(p: Params, cfg: dict, batch: Dict[str, torch.Tensor], counts: Tuple[float, float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(text CE sum / counts[0], audio CE sum / counts[1]) of the rows of
    `batch` (ChatMusicLM.forward with the trainer's embedding mask); counts
    are the whole batch's numbers of valid labels, so that rows can be
    taken one at a time."""
    c = cfg["audio_codebook_count"]
    x = embed(p, cfg, batch["text_tokens"], batch["audio_tokens"]) * batch["valid"][..., None]
    b, s, _ = x.shape
    hid = decoder(p, "slow_decoder", cfg["slow"], x)
    text_logits = F.linear(hid, p["text_head.weight"].float())
    text_sum = F.cross_entropy(text_logits[:, :-1].reshape(-1, text_logits.shape[-1]), batch["text_labels"][:, 1:].reshape(-1),
                               ignore_index=IGNORE, reduction="sum")
    del text_logits
    frame_labels = batch["audio_labels"][:, 1:, :]
    fast_ids = frame_labels.masked_fill(frame_labels == IGNORE, cfg["fast_audio_pad_id"])
    h = F.linear(rms_norm(hid[:, :-1], p["fast_pre_norm.weight"], cfg["fast"].get("rms_norm_eps", 1e-6)),
                 p["fast_projector.weight"], p["fast_projector.bias"])
    emb = F.embedding(fast_ids, p["fast_audio_embed.weight"]).float() * (fast_ids != cfg["fast_audio_pad_id"])[..., None]
    fast_in = torch.cat([h[:, :, None, :], emb], dim=2).reshape(b * (s - 1), c + 1, -1)
    audio_logits = F.linear(decoder(p, "fast_decoder", cfg["fast"], fast_in), p["audio_head.weight"].float())
    depth = torch.cat([batch["text_labels"][:, 1:].reshape(b * (s - 1), 1), frame_labels.reshape(b * (s - 1), c)], dim=1)
    audio_sum = F.cross_entropy(audio_logits[:, :-1].reshape(-1, audio_logits.shape[-1]), depth[:, 1:].reshape(-1),
                                ignore_index=IGNORE, reduction="sum")
    return text_sum / counts[0], audio_sum / counts[1]


def label_counts(batch: Dict[str, torch.Tensor]) -> Tuple[float, float]:
    """The numbers of valid text and depth labels of a whole batch."""
    text = float((batch["text_labels"][:, 1:] != IGNORE).sum())
    depth = torch.cat([batch["text_labels"][:, 1:, None], batch["audio_labels"][:, 1:, :]], dim=2)[..., 1:]
    return max(1.0, text), max(1.0, float((depth != IGNORE).sum()))


def loss_and_grads(p: Params, cfg: dict, batch: Dict[str, torch.Tensor], rows=None) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The weighted loss of `batch` and its gradients, row by row (the
    means over the whole batch's valid labels). `rows` keeps only those
    rows (the mean then taken over theirs)."""
    if rows is not None:
        batch = {k: v[rows] for k, v in batch.items()}
    counts = label_counts(batch)
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    total = 0.0
    for r in range(batch["text_tokens"].shape[0]):
        t, a = losses(leaves, cfg, {k: v[r:r + 1] for k, v in batch.items()}, counts)
        loss = cfg["text_weight"] * t + cfg["audio_weight"] * a
        loss.backward()
        total += float(loss.detach())
    return total, {k: v.grad if v.grad is not None else torch.zeros_like(v) for k, v in leaves.items()}


def decayed(name: str) -> bool:
    """AdamW's weight decay: not on biases and norm weights."""
    parts = name.split(".")
    return parts[-1] != "bias" and not (parts[-1] == "weight" and any("norm" in q.lower() for q in parts))


def lr_at(train: dict, update: int) -> float:
    """Linear warmup, then a cosine down to final_lr_ratio of the rate."""
    base, warm, total = train["learning_rate"], train["num_warmup_steps"], train["num_training_steps"]
    if update < warm:
        return base * update / max(1, warm)
    progress = (update - warm) / max(1, total - warm)
    return base * max(train["final_lr_ratio"], 0.5 * (1.0 + math.cos(math.pi * progress)))


@torch.no_grad()
def adamw_update(p: Params, grads: Params, state: dict, train: dict) -> None:
    """One clipped AdamW update of p in place from `grads` (the micro-steps'
    mean): clip by the global norm, decay decoupled, bias-corrected moments,
    eps outside the root."""
    norm = math.sqrt(sum(float(g.float().square().sum()) for g in grads.values()))
    scale = train["grad_clip"] / norm if not norm < train["grad_clip"] else 1.0
    t = state["t"] = state.get("t", 0) + 1
    lr = lr_at(train, t - 1)
    b1, b2 = train["betas"]
    for name, w in p.items():
        g = grads[name] * scale
        m = state.setdefault(("m", name), torch.zeros_like(w))
        v = state.setdefault(("v", name), torch.zeros_like(w))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        if decayed(name):
            w.mul_(1 - lr * train["weight_decay"])
        denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(train["eps"])
        w.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))
