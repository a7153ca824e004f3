"""Model operations and bytes of the slow-fast LM's work, from its shapes
(2 flops a multiply-add; training is three times the forward's products)."""

from __future__ import annotations


def _decoder_macs(d: dict) -> float:
    """Multiply-adds of one token through a decoder's projections."""
    h, i, hd = d["hidden_size"], d["intermediate_size"], d["hidden_size"] // d["num_heads"]
    qkvo = h * (2 * d["num_heads"] * hd + 2 * d["num_kv_heads"] * hd)
    return d["num_layers"] * (qkvo + 3 * h * i)


def attention_pairs(seq: int) -> float:
    """Visible (query, key) pairs of one causal sequence."""
    return seq * (seq + 1) / 2


def forward_flops(cfg: dict, batch: int, seq: int) -> float:
    """One teacher-forced forward of `batch` grids of `seq` positions: the
    slow decoder, the audio projector, the text head, and the fast decoder
    over the codebooks + 1 depth positions of every frame with its
    projector and audio head; causal attention in both decoders."""
    s, f, c = cfg["slow"], cfg["fast"], cfg["audio_codebook_count"]
    hs, hf = s["hidden_size"], f["hidden_size"]
    av = c * cfg["audio_codebook_size"]
    per_pos = _decoder_macs(s) + c * hs * hs + hs * s["vocab_size"]
    per_frame = hs * hf + (c + 1) * (_decoder_macs(f) + hf * av)
    att_slow = 2 * 2 * s["num_heads"] * (hs // s["num_heads"]) * attention_pairs(seq) * s["num_layers"]
    att_fast = 2 * 2 * f["num_heads"] * (hf // f["num_heads"]) * attention_pairs(c + 1) * f["num_layers"]
    return batch * (2.0 * seq * per_pos + 2.0 * (seq - 1) * per_frame + att_slow + (seq - 1) * att_fast)


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    return 3.0 * forward_flops(cfg, batch, seq)


def attention_train_work(cfg: dict, batch: int, seq: int, itemsize: int):
    """(flops, bytes) of the slow decoder's causal GQA attention in a
    training micro-step, every layer: the forward's two products and the
    backward's four per visible pair (2 * head_dim flops each); bytes after
    chip_smoke.py's fa_bound_ms and bwd_bound_ms: q, k, v, the output and
    the row statistics once forward, q, k, v, the output, its gradient and
    the statistics read and dq, dk, dv written once backward."""
    s = cfg["slow"]
    h, kh, hd = s["num_heads"], s["num_kv_heads"], s["hidden_size"] // s["num_heads"]
    pairs = batch * h * attention_pairs(seq)
    flops = 6 * 2 * hd * pairs
    q, kv, stats = batch * seq * h * hd, batch * seq * kh * hd, batch * h * seq * 4
    fwd = (2 * q + 2 * kv) * itemsize + stats
    bwd = (4 * q + 4 * kv) * itemsize + 2 * stats
    return s["num_layers"] * flops, s["num_layers"] * (fwd + bwd)


def generation_flops(cfg: dict, batch: int, prompt: int, frames: int) -> float:
    """Model operations of one batch's generation of `frames` frames after
    a `prompt`-position prefill: each slow position once through the
    decoder, the audio projector and the text head (attention to the
    positions before it), and each frame's codebooks + 1 depth positions
    once through the fast decoder with the projector and the audio head;
    the fixed-shape depth decode's repeated passes are not model work."""
    s, f, c = cfg["slow"], cfg["fast"], cfg["audio_codebook_count"]
    hs, hf = s["hidden_size"], f["hidden_size"]
    av = c * cfg["audio_codebook_size"]
    positions = prompt + frames - 1
    slow = 2.0 * positions * (_decoder_macs(s) + c * hs * hs + hs * s["vocab_size"])
    slow += 2 * 2 * hs * attention_pairs(positions) * s["num_layers"]
    fast = 2.0 * frames * (hs * hf + (c + 1) * _decoder_macs(f) + c * hf * av)
    fast += frames * 2 * 2 * hf * attention_pairs(c + 1) * f["num_layers"]
    return batch * (slow + fast)
