"""Model operations and bytes of the slow-fast LM with a Kimi Linear slow
decoder (configuration keys as HF's config.json names them, at the top
level), and of its KDA layers' chunked scan (2 flops a multiply-add).

The generation counts only the work this chip does: the routed experts'
pairs of the experts it holds (the program's counter), not
num_experts_per_token a token; everything else (KDA, latent attention,
the dense layer, the router, the shared expert, embeddings, the text head
once a frame, the fast side) whole."""

from __future__ import annotations

from benchmark.counts import lm

CHUNK = 64  # the chunked form's chunk, whose operations `scan_work` counts


def _kda(cfg: dict) -> tuple:
    lin = cfg["linear_attn_config"]
    return lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]


def kda_layer_macs(cfg: dict) -> float:
    """Multiply-adds of one position through a KDA layer's projections and
    convolutions: q, k, v, the forget gate's two, beta, the output gate's
    two, the output; three depthwise convolutions."""
    h = cfg["hidden_size"]
    nh, d, taps = _kda(cfg)
    w = nh * d
    return 3 * h * w + 2 * (h * d + d * w) + h * nh + w * h + 3 * w * taps


def mla_layer_macs(cfg: dict) -> float:
    """Multiply-adds of one position through a latent attention layer's
    projections (the expanded form: kv_b_proj once a position)."""
    h, nh, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return h * nh * (nope + rope) + h * (r + rope) + r * nh * (nope + v) + nh * v * h


def expert_macs(cfg: dict) -> float:
    """Multiply-adds of one (token, expert) pair: gate, up and down."""
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def decoder_macs(cfg: dict) -> float:
    """Multiply-adds of one position through the slow decoder's layers
    without the routed experts: the attention layers' projections, the
    dense layers, and in each MoE layer the router (every published
    expert's score) and the shared expert."""
    h, layers, dense = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    kda = len(cfg["linear_attn_config"]["kda_layers"])
    moe = h * cfg["published_num_experts"] + 3 * h * cfg["moe_intermediate_size"] * cfg["num_shared_experts"]
    return (kda * kda_layer_macs(cfg) + (layers - kda) * mla_layer_macs(cfg)
            + dense * 3 * h * cfg["intermediate_size"] + (layers - dense) * moe)


def recurrence_flops(cfg: dict, positions: float) -> float:
    """The KDA recurrence's model operations over `positions`, every KDA
    layer: a head's S^T k, its rank-one update and S^T q, d x d each."""
    nh, d, _ = _kda(cfg)
    return 2.0 * 3 * nh * d * d * positions * len(cfg["linear_attn_config"]["kda_layers"])


def attention_flops(cfg: dict, pairs: float) -> float:
    """Latent attention's two products over `pairs` visible (query, key)
    pairs, every latent attention layer."""
    mla = cfg["num_hidden_layers"] - len(cfg["linear_attn_config"]["kda_layers"])
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return 2.0 * cfg["num_attention_heads"] * (qk + cfg["v_head_dim"]) * pairs * mla


def generation_flops(cfg: dict, batch: int, prompt: int, frames: int, held_pairs: float) -> float:
    """Model operations of one batch's generation of `frames` frames after
    a `prompt`-position prefill, with `held_pairs` (token, expert) pairs
    routed to this chip's experts over it: each slow position once through
    the decoder without its routed experts and the audio projector, KDA's
    recurrence and latent attention to the positions before it; the text
    head once a frame (the prefill's at its last position); each held pair
    once; and `counts/lm.py`'s fast side a frame."""
    f, c = cfg["fast"], cfg["audio_codebook_count"]
    h, hf = cfg["hidden_size"], f["hidden_size"]
    av = c * cfg["audio_codebook_size"]
    positions = prompt + frames - 1
    slow = 2.0 * positions * (decoder_macs(cfg) + c * h * h) + 2.0 * frames * h * cfg["vocab_size"]
    slow += recurrence_flops(cfg, positions) + attention_flops(cfg, lm.attention_pairs(positions))
    fast = 2.0 * frames * (h * hf + (c + 1) * lm._decoder_macs(f) + c * hf * av)
    fast += frames * 2 * 2 * hf * lm.attention_pairs(c + 1) * f["num_layers"]
    return batch * (slow + fast) + 2.0 * held_pairs * expert_macs(cfg)


def scan_work(cfg: dict, positions: float, calls: float, itemsize: int) -> tuple:
    """(flops, bytes) of the chunked KDA scan over `positions` rows x
    positions (every layer's counted) in `calls` (row, layer) scans. A
    chunk of C = CHUNK positions a head, d = head_dim (keys and values):
      A = (K e^G)(K e^-G)^T and Aq = (Q e^G)(K e^-G)^T   2 C^2 d
      (I + diag(beta) A)^-1 against [C, 2d]            C^2 d
      u = U - W S                                       C d^2
      o = (Q e^G) S + Aq u                              C d^2 + C^2 d
      S' = e^G_end S + (K e^(G_end - G))^T u            C d^2
    multiply-adds: 4 C^2 d + 3 C d^2, so (4 C d + 3 d^2) a position and
    head. Bytes: q, k, v at the cell's `itemsize` and a (d a head) and beta
    (one) in float32 read once, o at `itemsize` written once, and each
    scan's final state (d x d a head, float32) written once."""
    nh, d, _ = _kda(cfg)
    flops = 2.0 * (4 * CHUNK * d + 3 * d * d) * nh * positions
    nbytes = positions * nh * (4 * d * itemsize + (d + 1) * 4) + calls * nh * d * d * 4
    return flops, nbytes
