"""Model operations and bytes of the slow-fast LM with a Nemotron-H slow
decoder (configuration keys as HF's config.json names them, at the top
level), of its Mamba layers' chunked SSD, and of its attention layers'
causal forward on FA (2 flops a multiply-add).

The generation counts only the work this chip does: the routed experts'
pairs of the experts it holds (the program's counter), not
num_experts_per_tok a token; everything else (Mamba-2, attention, the
router, the shared expert, embeddings, the text head once a frame, the
fast side) whole."""

from __future__ import annotations

from benchmark.counts import lm

CHUNK = 128  # the chunked form's chunk, whose operations `scan_work` counts


def _mamba(cfg: dict) -> tuple:
    return cfg["mamba_num_heads"], cfg["mamba_head_dim"], cfg["n_groups"], cfg["ssm_state_size"]


def _layers(cfg: dict, kind: str) -> int:
    return cfg["hybrid_override_pattern"].count(kind)


def mamba_layer_macs(cfg: dict) -> float:
    """Multiply-adds of one position through a Mamba layer's projections
    and convolution: in_proj (z, xBC, dt), out_proj, the depthwise
    convolution over xBC."""
    h = cfg["hidden_size"]
    nh, p, g, n = _mamba(cfg)
    conv = nh * p + 2 * g * n
    return h * (nh * p + conv + nh) + nh * p * h + conv * cfg["conv_kernel"]


def attention_layer_macs(cfg: dict) -> float:
    """Multiply-adds of one position through an attention layer's q, k, v
    and o projections."""
    h, nh, kv, d = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    return 2 * h * nh * d + 2 * h * kv * d


def expert_macs(cfg: dict) -> float:
    """Multiply-adds of one (token, expert) pair: up and down."""
    return 2 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def decoder_macs(cfg: dict) -> float:
    """Multiply-adds of one position through the slow decoder's layers
    without the routed experts: the Mamba and attention layers'
    projections, and in each MoE layer the router (every published
    expert's score) and the shared expert."""
    h = cfg["hidden_size"]
    moe = h * cfg["published_n_routed_experts"] + 2 * h * cfg["moe_shared_expert_intermediate_size"]
    return (_layers(cfg, "M") * mamba_layer_macs(cfg) + _layers(cfg, "*") * attention_layer_macs(cfg)
            + _layers(cfg, "E") * moe)


def recurrence_flops(cfg: dict, positions: float) -> float:
    """The Mamba-2 recurrence's model operations over `positions`, every
    Mamba layer: a head's update dt x B^T and its read h C, P x N each."""
    nh, p, _, n = _mamba(cfg)
    return 2.0 * 2 * nh * p * n * positions * _layers(cfg, "M")


def attention_flops(cfg: dict, pairs: float) -> float:
    """Attention's two products over `pairs` visible (query, key) pairs,
    every attention layer."""
    return 2.0 * cfg["num_attention_heads"] * 2 * cfg["head_dim"] * pairs * _layers(cfg, "*")


def generation_flops(cfg: dict, batch: int, prompt: int, frames: int, held_pairs: float) -> float:
    """Model operations of one batch's generation of `frames` frames after
    a `prompt`-position prefill, with `held_pairs` (token, expert) pairs
    routed to this chip's experts over it: each slow position once through
    the decoder without its routed experts and the audio projector, the
    Mamba recurrence and attention to the positions before it; the text
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
    """(flops, bytes) of the chunked SSD over `positions` rows x positions
    (every layer's counted) in `calls` (row, layer) scans. A chunk of C =
    CHUNK positions, heads of P, a state of N, H heads a group of B / C:
      G = C B^T, once a group                 C^2 N / H a head
      y = (L * G) X                           C^2 P
      the chunk's own state (X L_end)^T B      C P N
      y += (C h_in) e^cum                     C P N
    multiply-adds: (C N / H + C P + 2 P N) a position and head (the
    states' hand-over between chunks, P N a chunk, left out). Bytes: x
    (P a head), B and C (N a group each) at the cell's `itemsize` and dt
    (one a head) in float32 read once, y at `itemsize` written once, and
    each scan's final state (P x N a head, float32) written once."""
    nh, p, g, n = _mamba(cfg)
    flops = 2.0 * (CHUNK * n * g / nh + CHUNK * p + 2 * p * n) * nh * positions
    nbytes = positions * ((2 * nh * p + 2 * g * n) * itemsize + nh * 4) + calls * nh * p * n * 4
    return flops, nbytes


def fa_work(cfg: dict, batch: int, seq: int, itemsize: int) -> tuple:
    """(flops, bytes) of the attention layers' causal GQA forward over
    `batch` rows of `seq` positions, every attention layer: two products
    of 2 head_dim flops a visible pair and head (`counts/lm.py`'s pairs);
    q, k, v read and the output written once (no row statistics: no
    gradient is taken)."""
    nh, kv, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    flops = 2 * 2 * d * batch * nh * lm.attention_pairs(seq)
    nbytes = (2 * batch * seq * nh * d + 2 * batch * seq * kv * d) * itemsize
    return _layers(cfg, "*") * flops, _layers(cfg, "*") * nbytes
