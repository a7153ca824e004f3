"""Model operations and bytes of the slow-fast LM with a DeepSeek-V3 slow
decoder (configuration keys as HF's config.json names them, at the top
level): the operations a position takes through its active parameters
(latent attention's projections, the dense first blocks, the router, the
chosen experts and the shared experts), attention over the visible keys,
and the routed experts' work from the program's pair counter (2 flops a
multiply-add)."""

from __future__ import annotations

from benchmark.counts import lm


def _attention_macs(cfg: dict) -> float:
    """Multiply-adds of one position through MLA's projections (the
    expanded form: kv_b_proj once a position)."""
    h, nh, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return h * nh * (nope + rope) + h * (r + rope) + r * nh * (nope + v) + nh * v * h


def expert_macs(cfg: dict) -> float:
    """Multiply-adds of one (token, expert) pair: gate, up and down."""
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def decoder_macs(cfg: dict) -> float:
    """Multiply-adds of one position through the slow decoder's active
    parameters: every layer's attention projections, the dense blocks, and
    in each MoE block the router, num_experts_per_tok experts and the
    shared experts."""
    h, layers, dense = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    moe = (h * cfg["n_routed_experts"] + cfg["num_experts_per_tok"] * expert_macs(cfg)
           + 3 * h * cfg["moe_intermediate_size"] * cfg["n_shared_experts"])
    return layers * _attention_macs(cfg) + dense * 3 * h * cfg["intermediate_size"] + (layers - dense) * moe


def attention_flops(cfg: dict, pairs: float) -> float:
    """Attention's two products over `pairs` visible (query, key) pairs,
    every layer: q.k over the whole query head, then the weighted values."""
    nh = cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return 2.0 * nh * (qk + cfg["v_head_dim"]) * pairs * cfg["num_hidden_layers"]


def generation_flops(cfg: dict, batch: int, prompt: int, frames: int) -> float:
    """`counts/lm.py` generation_flops with this slow decoder: each slow
    position once through its active parameters, the audio projector and
    the text head (attention to the positions before it), and each frame's
    codebooks + 1 depth positions once through the fast decoder with the
    projector and the audio head."""
    f, c = cfg["fast"], cfg["audio_codebook_count"]
    h, hf = cfg["hidden_size"], f["hidden_size"]
    av = c * cfg["audio_codebook_size"]
    positions = prompt + frames - 1
    slow = 2.0 * positions * (decoder_macs(cfg) + c * h * h + h * cfg["vocab_size"])
    slow += attention_flops(cfg, lm.attention_pairs(positions))
    fast = 2.0 * frames * (h * hf + (c + 1) * lm._decoder_macs(f) + c * hf * av)
    fast += frames * 2 * 2 * hf * lm.attention_pairs(c + 1) * f["num_layers"]
    return batch * (slow + fast)


def experts_work(cfg: dict, pairs, itemsize: int) -> tuple:
    """(flops, bytes) of the routed experts over a pair count [moe layers,
    experts] (the program's counter): each pair's three products; each
    chosen expert's weights read once, each pair's token read and its
    output written once."""
    flops = bytes_ = 0.0
    h = cfg["hidden_size"]
    for layer in pairs:
        for n in layer:
            n = int(n)
            if n:
                flops += 2.0 * n * expert_macs(cfg)
                bytes_ += (expert_macs(cfg) + 2 * n * h) * itemsize
    return flops, bytes_
