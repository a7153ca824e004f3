"""The Nemotron-H slow decoder (one mixer a block: Mamba-2, squared-ReLU
experts of which this rank holds a share, NoPE grouped-query attention)
against the plain reference `benchmark/reference/lm_ssm.py`, on the CPU at
a small size: 6 layers of 64 by the pattern "MEM*EM", Mamba-2 8 heads of 8
in 2 groups of B / C with a state of 16 and 4-tap convolutions, attention
4 heads over 2 of 24 (not 64 / 4), a router of 16 experts of which rank 0
holds 4, 3 a token, a shared expert of 96, a vocabulary of 300. Weights
are the benchmark's draw from a seed
(`benchmark/drivers/lm_dialog_nemotron.params`).

Tolerances, relative to the reference's largest magnitude: float32 2e-5
(the same products summed in another order: the chunked SSD against the
reference's position-by-position recurrence, the routed experts' float32
sum by expert, the cache's one-position steps; measured 9.3e-7
teacher-forced, 8.9e-7 through the cache); the chunked SSD alone against
a float64 recurrence 1e-5 of max(1, the largest magnitude), at the draw's
decays and at decays down to -20 a step alike (each decay summed from its
own start: measured at most 2.2e-7; a difference of two running sums reads
up to 2.2e-5 at the steep decays). The program in bf16 misses the logits' 2e-5 by orders of
magnitude (the control), and so do four planted faults: a head reading
the B / C group h % groups in place of h // (heads / groups), the gated
norm taken before the gate, a decode that drops the convolution's inputs,
and an attention that rotates its queries and keys."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from benchmark.drivers import lm_dialog_nemotron as driver
from benchmark.drivers.lm_generate import penalized
from benchmark.reference import lm as ref_lm
from benchmark.reference import lm_ssm as ref
from dmel_codec_tpu_torch.lm.generate import InferenceConfig, SlowFastGenerator
from dmel_codec_tpu_torch.models import nemotron_h
from dmel_codec_tpu_torch.models.deepseek_v3 import MoE, SquaredReluMLP
from dmel_codec_tpu_torch.models.lm import ChatMusicLM
from dmel_codec_tpu_torch.models.transformer import MLP, TransformerConfig, apply_rope, init_kv_cache, rope_cos_sin

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "benchmark/configs/slowfast-nemotron-3-nano-30b-a3b-ep2.json"
TOL = 2e-5
SCAN_TOL = 1e-5
SEED = 2**31 + 93


def tiny_config(rank: int = 0) -> dict:
    cfg = json.loads(CONFIG.read_text())
    cfg.update(vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=6,
               hybrid_override_pattern="MEM*EM", num_attention_heads=4, num_key_value_heads=2, head_dim=24,
               mamba_num_heads=8, mamba_head_dim=8, n_groups=2, ssm_state_size=16, n_routed_experts=4,
               published_n_routed_experts=16, num_experts_per_tok=3, moe_intermediate_size=48,
               moe_shared_expert_intermediate_size=96, audio_codebook_count=4, audio_codebook_size=16,
               bos_token_id=256, eos_token_id=256, start_of_human_id=257, end_of_human_id=258,
               start_of_robot_id=259, end_of_robot_id=260, start_of_music_id=261, end_of_music_id=262,
               text_pad_id=263, slow_audio_pad_id=15, fast_audio_pad_id=12, audio_silence_id=[0, 1, 2, 3])
    cfg["expert_parallel"] = dict(cfg["expert_parallel"], rank=rank)
    cfg["fast"] = dict(cfg["fast"], hidden_size=16, intermediate_size=32, num_layers=2, num_heads=2, num_kv_heads=1)
    return cfg


CFG = tiny_config()


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def build(cfg=CFG, dtype=torch.float32):
    p = driver.params(cfg, SEED, torch.float32, "cpu")
    with torch.device("meta"):
        model = ChatMusicLM(driver.lm_config(cfg))
    model.load_state_dict({k: v.to(dtype) for k, v in p.items()}, strict=True, assign=True)
    return p, model.eval()


def grid(b: int, s: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    c, size = CFG["audio_codebook_count"], CFG["audio_codebook_size"]
    text = torch.as_tensor(rng.integers(0, CFG["bos_token_id"], (b, s)))
    audio = torch.as_tensor(rng.integers(0, size, (b, s, c)) + np.arange(c) * size)
    text[:, :2] = CFG["text_pad_id"]  # a left-padded start, as served batches have
    audio[:, :2] = CFG["slow_audio_pad_id"]
    return text, audio


def rel(got, want) -> float:
    return float((got.float() - want).abs().max() / max(1.0, float(want.abs().max())))


def layer_weights(p: dict, n: int) -> dict:
    prefix = f"slow_decoder.layers.{n}."
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def test_shapes_are_the_references():
    _, model = build()
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == dict(ref.param_shapes(CFG))
    kinds = [type(layer.mixer) for layer in model.slow_decoder.layers]
    assert kinds == [nemotron_h.Mamba2Mixer, MoE, nemotron_h.Mamba2Mixer, nemotron_h.NoPEAttention, MoE,
                     nemotron_h.Mamba2Mixer]
    moe = model.slow_decoder.layers[1].mixer
    assert moe.experts.up_proj.shape == (4, 48, 64) and moe.gate.weight.shape[0] == 16
    assert isinstance(moe.shared_experts, SquaredReluMLP) and moe.shared_experts.up_proj.weight.shape == (96, 64)
    assert model.slow_decoder.layers[3].mixer.q_proj.weight.shape == (4 * 24, 64)
    assert model.slow_decoder.slots == [(("state", "conv"), 0), ((), 0), (("state", "conv"), 1), (("k", "v"), 0),
                                        ((), 1), (("state", "conv"), 2)]


def test_full_size_is_the_share():
    """Rank 0's share at the published widths: the slow decoder with its
    text embedding and head 16.89 B parameters (the held experts 14.7 B),
    the whole slow-fast LM 17.03 B, 34.1 GB in bf16; the Mamba layers
    38.7 M and the attention layers 23.4 M each; the embedding and the
    head 0.70 B."""
    cfg = json.loads(CONFIG.read_text())
    shapes = ref.param_shapes(cfg)
    count = lambda pick: sum(int(np.prod(s)) for n, s in shapes.items() if pick(n))  # noqa: E731
    text = ("text_embed.weight", "text_head.weight")
    assert 16.88e9 < count(lambda n: n.startswith("slow_decoder.") or n in text) < 16.90e9
    assert 17.02e9 < count(lambda n: True) < 17.04e9 and 14.6e9 < count(lambda n: ".experts." in n) < 14.8e9
    pattern = cfg["hybrid_override_pattern"]
    assert (pattern.count("M"), pattern.count("E"), pattern.count("*"), len(pattern)) == (23, 23, 6, 52)
    for n, lo, hi in ((pattern.index("M"), 38.6e6, 38.8e6), (pattern.index("*"), 23.3e6, 23.5e6)):
        assert lo < count(lambda k: k.startswith(f"slow_decoder.layers.{n}.mixer.")) < hi
    assert 0.70e9 < count(lambda n: n in ("text_embed.weight", "text_head.weight")) < 0.71e9
    assert cfg["n_routed_experts"] * 2 == cfg["published_n_routed_experts"] == 128


def naive_ssd(x, a, b, c, state):
    """The recurrence position by position in float64: x [R, S, G, H, P],
    a [R, S, G, H], b, c [R, S, G, N], state [R, G, H, P, N]."""
    x, a, b, c, h = (t.double() for t in (x, a, b, c, state))
    y = torch.zeros_like(x)
    for t in range(x.shape[1]):
        h = h * a[:, t].exp()[..., None, None] + x[:, t, ..., None] * b[:, t, :, None, None, :]
        y[:, t] = (h * c[:, t, :, None, None, :]).sum(-1)
    return y, h


@pytest.mark.parametrize("steepest", [None, -20.0], ids=["drawn", "decays_to_-20"])
@pytest.mark.parametrize("s", [128, 300, 7, 1])
def test_chunked_ssd_is_the_recurrence(s, steepest):
    """`ssd` (chunks of 128, the tail padded) against the recurrence, from
    a state that is not zero, over whole and ragged chunks and a single
    position: at the decays of the weights' draw (dt A with A = -exp(log
    U(1, 16)) and dt = softplus(N(0, 1) + dt_bias)) and at decays down to
    -20 a step."""
    gen = torch.Generator().manual_seed(s)
    r, g, h, p, n = 3, 2, 4, 8, 16
    x, b, c = torch.randn(r, s, g, h, p, generator=gen), torch.randn(r, s, g, n, generator=gen), \
        torch.randn(r, s, g, n, generator=gen)
    if steepest is None:
        dt_bias = torch.empty(g, h).uniform_(np.log(1e-3), np.log(1e-1), generator=gen).exp()
        dt = F.softplus(torch.randn(r, s, g, h, generator=gen) + dt_bias + torch.log(-torch.expm1(-dt_bias)))
        a = dt * -torch.empty(g, h).uniform_(1.0, 16.0, generator=gen)
        x = x * dt[..., None]
    else:
        a = torch.rand(r, s, g, h, generator=gen) * steepest
    state = torch.randn(r, g, h, p, n, generator=gen)
    y, last = nemotron_h.ssd(x, a, b, c, state)
    want_y, want_s = naive_ssd(x, a, b, c, state)
    assert torch.isfinite(y).all() and torch.isfinite(last).all()
    assert rel(y, want_y.float()) <= SCAN_TOL and rel(last, want_s.float()) <= SCAN_TOL
    y0, _ = nemotron_h.ssd(x, a, b, c)
    assert rel(y0, naive_ssd(x, a, b, c, torch.zeros_like(state))[0].float()) <= SCAN_TOL


def test_segsum_sums_each_span_from_its_start():
    x = torch.tensor([-1.0, -2.0, -3.0, -4.0])
    want = torch.tensor([[0.0, -np.inf, -np.inf, -np.inf], [-2.0, 0.0, -np.inf, -np.inf],
                         [-5.0, -3.0, 0.0, -np.inf], [-9.0, -7.0, -4.0, 0.0]])
    assert torch.equal(nemotron_h.segsum(x), want)


def test_the_passes_group_heads_alike(monkeypatch):
    """A chunked call whose B / C groups go in passes of one (a small
    GROUP_BYTES) gives the result of one pass over both."""
    _, model = build()
    x = torch.randn(2, 150, CFG["hidden_size"], generator=torch.Generator().manual_seed(4))
    layer = model.slow_decoder.layers[0].mixer
    with torch.no_grad():
        assert nemotron_h.pass_groups(2, 150, 2, 4) == 2
        whole = layer(x)
        monkeypatch.setattr(nemotron_h, "GROUP_BYTES", 1)
        assert nemotron_h.pass_groups(2, 150, 2, 4) == 1
        assert rel(layer(x), whole) <= 1e-6


@torch.no_grad()
def teacher_forced_logits(model, p, text, audio, cfg=CFG):
    hid, _ = model.slow_decoder(model.embed_inputs(text, audio))
    q = ref.outer(p)
    want = ref.decoder(p, cfg, ref_lm.embed(q, cfg, text, audio))
    return model.text_head(hid), F.linear(want, q["text_head.weight"])


def test_teacher_forced_logits():
    p, model = build()
    got, want = teacher_forced_logits(model, p, *grid(2, 150))
    assert rel(got, want) <= TOL


def test_bf16_control_fails():
    """The same weights held in bf16 (activations too) miss the float32
    tolerance: the comparison tells the precisions apart."""
    p, model = build(dtype=torch.bfloat16)
    got, want = teacher_forced_logits(model, p, *grid(2, 150))
    assert rel(got, want) > 10 * TOL


def rotating_attention(real):
    """A planted fault: the attention rotates its queries and keys (RoPE
    at the call's positions 0 .. S-1, θ 1e4)."""
    def forward(self, x, mask, cache=None, cache_rows=None, mask_pos=None):
        b, s, _ = x.shape
        cos, sin = rope_cos_sin(torch.arange(s).expand(b, s), self.config.head_dim, 1e4)
        q_proj, k_proj = self.q_proj, self.k_proj

        class Rotated(torch.nn.Module):
            def __init__(self, proj, heads):
                super().__init__()
                self.proj, self.heads = proj, heads

            def forward(self, y):
                out = self.proj(y).view(b, s, self.heads, -1)
                return apply_rope(out, cos, sin).flatten(2)

        self.q_proj, self.k_proj = Rotated(q_proj, self.config.num_heads), Rotated(k_proj, self.config.num_kv_heads)
        try:
            return real(self, x, mask, cache, cache_rows, mask_pos)
        finally:
            self.q_proj, self.k_proj = q_proj, k_proj
    return forward


def modulo_groups(real):
    """A planted fault: head h reads the B / C group h % groups, not h //
    (heads / groups) (the chunked form's heads take the other groups'
    operands)."""
    def ssd(x, a, b, c, state=None):
        return real(x, a, b.roll(1, dims=2) if b.shape[2] > 1 else b, c.roll(1, dims=2) if c.shape[2] > 1 else c,
                    state)
    return ssd


def norm_before_gate(real):
    """A planted fault: the gated norm normalises y first, then multiplies
    by SiLU(z)."""
    def gated(self, y, z, channels):
        g = self.inner // self.config.mamba_n_groups
        v = y.unflatten(-1, (-1, g))
        v = (v * torch.rsqrt(v.square().mean(-1, keepdim=True) + self.norm.eps)).flatten(-2)
        return v * F.silu(z.float()) * self.norm.weight[channels].float()
    return gated


FAULTS = {"modulo_groups": (nemotron_h, "ssd", modulo_groups),
          "norm_before_gate": (nemotron_h.Mamba2Mixer, "_gated_norm", norm_before_gate),
          "rotating_attention": (nemotron_h.NoPEAttention, "forward", rotating_attention)}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_planted_fault_is_caught(fault, monkeypatch):
    p, model = build()
    owner, name, plant = FAULTS[fault]
    monkeypatch.setattr(owner, name, plant(getattr(owner, name)))
    got, want = teacher_forced_logits(model, p, *grid(2, 150))
    assert rel(got, want) > 100 * TOL


def stepped_logits(model, x, split, max_len: int = 160):
    cache = model.init_slow_cache(2, max_len)
    parts = []
    for lo, hi in split + [(i, i + 1) for i in range(split[-1][1], x.shape[1])]:
        h, cache = model.slow_decoder(x[:, lo:hi], cache=cache)
        parts.append(h)
    assert int(cache["index"]) == x.shape[1]
    return model.text_head(torch.cat(parts, 1))


@pytest.mark.parametrize("split", [[(0, 140)], [(0, 5), (5, 140)]], ids=["one_prefill", "two_prefills"])
@torch.no_grad()
def test_prefill_then_decode_through_the_hybrid_cache(split):
    """A prefill (or two: the second starts from the first's state,
    convolution inputs and keys), then one-position steps (Mamba's
    recurrent step, attention over the cache), against the full forward
    and the reference at every position, as logits; the cache holds the
    attention layer's keys and values at heads of 24 and the three Mamba
    layers' float32 state beside the convolution inputs."""
    p, model = build()
    text, audio = grid(2, 150, seed=1)
    x = model.embed_inputs(text, audio)
    cache = model.init_slow_cache(2, 160)
    assert set(cache) == {"k", "v", "state", "conv", "index"}
    assert cache["k"].shape == (1, 2, 160, 2, 24) and cache["state"].shape == (3, 2, 8, 8, 16)
    assert cache["conv"].shape == (3, 2, 3, 64 + 2 * 2 * 16) and cache["state"].dtype == torch.float32
    assert init_kv_cache(model.config.slow, 2, 160, torch.bfloat16)["state"].dtype == torch.float32
    stepped = stepped_logits(model, x, split)
    full, want = teacher_forced_logits(model, p, text, audio)
    assert rel(stepped, full) <= TOL and rel(stepped, want) <= TOL


@torch.no_grad()
def test_a_decode_without_the_conv_state_is_caught(monkeypatch):
    p, model = build()
    text, audio = grid(2, 150, seed=1)
    real = nemotron_h.Mamba2Mixer._step
    monkeypatch.setattr(nemotron_h.Mamba2Mixer, "_step", lambda self, x, state, conv: real(self, x, state, conv.zero_()))
    stepped = stepped_logits(model, model.embed_inputs(text, audio), [(0, 140)])
    _, want = teacher_forced_logits(model, p, text, audio)
    assert rel(stepped, want) > 100 * TOL


@torch.no_grad()
def test_the_attention_is_the_references_at_its_head_size():
    """The attention layer alone over 150 positions and then through a
    cache, against the reference's NoPE GQA at heads of 24: positions do
    not enter it."""
    p, model = build()
    layer = model.slow_decoder.layers[3].mixer
    assert layer.config.head_dim == 24 and layer.scale == pytest.approx(24 ** -0.5)
    w = layer_weights(p, 3)
    y = torch.randn(2, 150, CFG["hidden_size"], generator=torch.Generator().manual_seed(6))
    want = ref.attention(w, CFG, y)
    mask = torch.ones(150, 150, dtype=torch.bool).tril().expand(2, 150, 150)
    pos = torch.arange(150).expand(2, 150)
    assert rel(layer(y, mask, mask_pos=pos), want) <= TOL
    cache = (torch.zeros(2, 160, 2, 24), torch.zeros(2, 160, 2, 24))
    keys = torch.arange(160)[None, None]
    first = layer(y[:, :149], keys <= pos[:, :149, None], cache, torch.arange(149), pos[:, :149])
    last = layer(y[:, 149:], keys <= pos[:, 149:, None], cache, torch.tensor([149]), pos[:, 149:])
    assert rel(torch.cat([first, last], 1), want) <= TOL


def test_the_plain_core_takes_queries_in_chunks(monkeypatch):
    """`attend` with at most a few scores a chunk gives the one-chunk
    result."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = torch.randn(2, 40, 4, 24, generator=gen), torch.randn(2, 40, 2, 24, generator=gen), \
        torch.randn(2, 40, 2, 24, generator=gen)
    mask = torch.ones(40, 40, dtype=torch.bool).tril().expand(2, 40, 40)
    whole = nemotron_h.attend(q, k, v, mask, 24 ** -0.5)
    monkeypatch.setattr(nemotron_h, "SCORE_ELEMENTS", 2 * 4 * 40 * 7)
    assert rel(nemotron_h.attend(q, k, v, mask, 24 ** -0.5), whole) <= 1e-6


@torch.no_grad()
def test_the_shares_add_up_to_the_whole_layer():
    """Each of the 4 ranks' squared-ReLU MoE layer (its 4 experts of the
    router's 16) against the reference with every expert: the ranks' parts,
    with the shared expert counted once, add up to the uncut layer; routed
    (several positions) and dense (one) alike, and a rank's layer is the
    reference's share."""
    y = torch.randn(3, 20, CFG["hidden_size"], generator=torch.Generator().manual_seed(8))
    flat = y.reshape(-1, CFG["hidden_size"])
    whole_cfg = dict(CFG, n_routed_experts=16)
    w_whole = layer_weights(driver.params(whole_cfg, SEED, torch.float32, "cpu"), 1)
    want = ref.moe(w_whole, whole_cfg, y)
    routed, dense = torch.zeros_like(y), torch.zeros_like(flat)
    shared = None
    for rank in range(4):
        cfg = tiny_config(rank)
        w = dict(w_whole)
        for name in ("mixer.experts.up_proj", "mixer.experts.down_proj"):
            w[name] = w_whole[name][4 * rank:4 * rank + 4]
        moe = MoE(driver.lm_config(cfg).slow)
        moe.load_state_dict({k[len("mixer."):]: v for k, v in w.items() if k.startswith("mixer.")})
        assert (moe.experts.offset, moe.experts.down_proj.shape[0]) == (4 * rank, 4)
        part = moe(y)
        assert rel(part, ref.moe(w, cfg, y)) <= TOL
        shared = moe.shared_experts(flat).view_as(y)
        routed += part - shared
        chosen, weights = moe.gate(flat)
        dense += moe.experts.dense(flat, chosen, weights)
    assert rel(routed + shared, want) <= TOL
    assert rel((dense + moe.shared_experts(flat)).view_as(y), want) <= TOL


@torch.no_grad()
def test_a_swiglu_layer_keeps_its_form():
    """A SwiGLU configuration (Moonlight's) keeps its stacked gate_up_proj,
    its gated shared MLP and its parameter names, and its experts compute
    silu(gate) * up before down, as they did."""
    from tests.test_torch_mla_moe import build as build_moonlight

    _, model = build_moonlight()
    moe = model.slow_decoder.layers[1].mlp
    assert moe.experts.gated and not hasattr(moe.experts, "up_proj") and type(moe.shared_experts) is MLP
    names = {k for k in moe.state_dict()}
    assert names == {"gate.weight", "gate.e_score_correction_bias", "experts.gate_up_proj", "experts.down_proj",
                     "shared_experts.gate_proj.weight", "shared_experts.up_proj.weight",
                     "shared_experts.down_proj.weight"}
    x = torch.randn(12, 64, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    chosen = torch.stack([torch.randperm(8, generator=gen)[:3] for _ in range(12)])  # distinct, as a router's
    w = torch.rand(12, 3, generator=torch.Generator().manual_seed(3))
    e = moe.experts
    want = torch.zeros(12, 64)
    for n in range(12):
        for j in range(3):
            gate, up = F.linear(x[n], e.gate_up_proj[chosen[n, j]]).chunk(2)
            want[n] += w[n, j] * F.linear(F.silu(gate) * up, e.down_proj[chosen[n, j]])
    assert rel(e.routed(x, chosen, w), want) <= 1e-6 and rel(e.dense(x, chosen, w), want) <= 1e-6


@torch.no_grad()
def test_generate_batched_greedy_is_the_references_argmax():
    """Greedy generation (top_k 1) on the CPU, its step the one a graph
    captures on the card: each served token is the reference's best under
    the same repetition penalty, at every frame; the counters keep router
    ids and count the prefill's SSD positions, and no attention call ran
    on FA."""
    p, model = build()
    icfg = dict(temperature=0.7, top_k=1, top_p=0.8, windows_penalty=1.2, windows_length=4, max_new_tokens=6,
                max_seq_len=160)
    gen = SlowFastGenerator(model, InferenceConfig(**icfg))
    text, audio = grid(2, 140, seed=5)
    log = model.slow_decoder.track_routes(2, 160)
    audio_ids, text_ids = gen.generate_batched(text.numpy(), audio.numpy())
    k = CFG["num_experts_per_tok"]
    assert gen.stats["pairs_prefill"].shape == (2, 16)  # MoE layers, the router's experts
    assert (gen.stats["pairs_prefill"].sum(-1) == 2 * 140 * k).all()
    assert gen.stats["ssd_positions"] == 2 * 140 * 3 and gen.stats["attn_flash"] == 0.0
    assert nemotron_h.NoPEAttention.calls == {"flash": 0, "plain": 1}
    q = ref.outer(p)
    c = CFG["audio_codebook_count"]
    for row in range(2):
        t, a = text_ids[row], audio_ids[row]
        n = len(t)
        seq_t = torch.cat([text[row], torch.as_tensor(t[:-1])])[None]
        seq_a = torch.cat([audio[row], torch.as_tensor(a[:-1])])[None]
        forced = log[:, row, :140 + n - 1].long()
        hid = ref.decoder(p, CFG, ref_lm.embed(q, CFG, seq_t, seq_a), forced=forced)[0, 139:]
        text_logits = F.linear(hid, q["text_head.weight"])
        pos0 = F.linear(ref_lm.rms_norm(hid, q["fast_pre_norm.weight"], 1e-6), q["fast_projector.weight"],
                        q["fast_projector.bias"])
        served = torch.as_tensor(a)
        fast_in = torch.cat([pos0[:, None], F.embedding(served, q["fast_audio_embed.weight"])], 1)
        audio_logits = F.linear(ref_lm.decoder(q, "fast_decoder", CFG["fast"], fast_in)[:, :c], q["audio_head.weight"])
        window = torch.cat([audio[row], served])[-(n + icfg["windows_length"]):]
        audio_logits = penalized(audio_logits, window, icfg)
        assert torch.equal(text_logits.argmax(-1), torch.as_tensor(t))
        assert torch.equal(audio_logits.argmax(-1), served)


# FA's sizes in one attention layer small enough for `meta`: 4 heads over 2 of 128
FA_LAYER = TransformerConfig(vocab_size=64, hidden_size=256, intermediate_size=128, num_layers=1, num_heads=4,
                             num_kv_heads=2, rms_norm_eps=1e-5, kind="nemotron_h", layer_pattern="*",
                             attention_head_dim=128)


@pytest.mark.parametrize("case", ["meta_bf16", "cpu", "float32", "gradient", "head_dim_160", "filled_cache"])
def test_fa_takes(case, monkeypatch):
    """`fa_takes` holds for bf16 queries off the CPU with no gradient
    taken, heads of at most 128 and the positions 0 .. S-1; not on the
    CPU, in float32, under a gradient, at heads of 160, or over a filled
    cache's positions."""
    monkeypatch.setattr(nemotron_h, "causal_from_zero", lambda pos: case != "filled_cache")
    d = 160 if case == "head_dim_160" else 128
    device = "cpu" if case == "cpu" else "meta"
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    layer = nemotron_h.NoPEAttention(dataclasses.replace(FA_LAYER, attention_head_dim=d))
    q = torch.zeros((2, 70, 4, d), device=device, dtype=dtype)
    k = torch.zeros((2, 70, 2, d), device=device, dtype=dtype)
    pos = torch.arange(70, device=device).expand(2, 70)
    with torch.set_grad_enabled(case == "gradient"):
        assert layer.fa_takes(q, k, pos) == (case == "meta_bf16")
        assert not layer.fa_takes(q, k, None)


def test_causal_from_zero():
    assert nemotron_h.causal_from_zero(torch.arange(5).expand(2, 5))
    assert not nemotron_h.causal_from_zero(torch.arange(1, 6).expand(2, 5))
    assert not nemotron_h.causal_from_zero(torch.stack([torch.arange(5), torch.arange(5) + 3]))


@torch.no_grad()
def test_fa_dispatch(monkeypatch):
    """Off the CPU (`meta`, FA stood in for), a bf16 attention layer runs
    a call over several positions from the empty cache on FA, with the
    call's own queries, keys and values, and counts it; the one-position
    step over the cache takes the plain core and is not counted."""
    seen = []
    monkeypatch.setattr(nemotron_h, "causal_from_zero", lambda pos: True)
    monkeypatch.setattr(nemotron_h, "flash_attention", lambda q, k, v: seen.append((q.shape, k.shape, v.shape)) or q)
    with torch.device("meta"):
        layer = nemotron_h.NoPEAttention(FA_LAYER).to(torch.bfloat16)
    nemotron_h.NoPEAttention.calls.update(flash=0, plain=0)
    x = torch.empty((3, 37, 256), device="meta", dtype=torch.bfloat16)
    cache = tuple(torch.zeros((3, 64, 2, 128), device="meta", dtype=torch.bfloat16) for _ in range(2))
    pos = torch.arange(37, device="meta").expand(3, 37)
    mask = torch.ones((3, 37, 64), dtype=torch.bool, device="meta")
    assert layer(x, mask, cache, torch.arange(37, device="meta"), pos).shape == x.shape
    layer(x[:, :1], mask[:, :1], cache, torch.tensor([37], device="meta"), pos[:, :1])  # the decode step
    assert seen == [((3, 37, 4, 128), (3, 37, 2, 128), (3, 37, 2, 128))]
    assert nemotron_h.NoPEAttention.calls == {"flash": 1, "plain": 0}


def test_the_yaml_is_the_benchmarks_configuration():
    """configs/lm_infer_nemotron_h.yaml gives the slow decoder the
    benchmark runs, without building it."""
    from dmel_codec_tpu_torch.cli.common import build_lm_config
    from dmel_codec_tpu_torch.utils.config import load_yaml

    got = build_lm_config(load_yaml(str(ROOT / "configs/lm_infer_nemotron_h.yaml")))
    want = driver.lm_config(json.loads(CONFIG.read_text()))
    assert got.slow == want.slow and got.fast == want.fast
    assert got.slow.kind == "nemotron_h" and got.slow.head_dim == 128 and got.slow.mlp_hidden_act == "relu2"
    assert (got.slow.n_routed_experts, got.slow.experts_held, got.slow.expert_offset) == (128, 64, 0)
    for k in ("bos_token_id", "eos_token_id", "text_pad_id", "start_of_music_id", "end_of_music_id"):
        assert getattr(got, k) == getattr(want, k) < got.slow.vocab_size


def test_tensor_parallelism_refuses_the_block():
    from dmel_codec_tpu_torch.parallel.tensor import set_model_groups

    _, model = build()
    with pytest.raises(NotImplementedError, match="Mamba-2 state-space layers"):
        set_model_groups(model, {}, None)


@pytest.mark.parametrize("change, match", [(dict(layer_pattern="ME*X"), "pattern"),
                                           (dict(layer_pattern="MEM"), "pattern"),
                                           (dict(mamba_n_groups=3), "groups"),
                                           (dict(mlp_hidden_act="gelu"), "relu2")])
def test_a_configuration_it_cannot_build_is_refused(change, match):
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(driver.lm_config(CFG).slow, **change)


def test_load_lm_builds_the_kind():
    """`cli.common.load_lm` (the meta device, then the state_dict's tensors)
    builds the Nemotron-H decoder; its A_log, dt_bias and D keep their
    float32."""
    from dmel_codec_tpu_torch.cli.common import load_lm

    p = driver.params(CFG, SEED, torch.bfloat16, "cpu")
    model = load_lm(driver.lm_config(CFG), p, "cpu")
    layer = model.slow_decoder.layers[0].mixer
    assert isinstance(layer, nemotron_h.Mamba2Mixer)
    assert layer.A_log.dtype == layer.D.dtype == torch.float32 and layer.in_proj.weight.dtype == torch.bfloat16
    assert torch.equal(layer.D, torch.ones(8))


def test_reset_parameters_draws_the_ssm():
    """A model built without a checkpoint draws A_log in log [1, 16],
    dt_bias from softplus^-1 [1e-4, 0.1], D = 1 and a zero conv bias."""
    model = ChatMusicLM(driver.lm_config(CFG))
    layer = model.slow_decoder.layers[0].mixer
    assert (layer.A_log.exp() >= 1).all() and (layer.A_log.exp() <= 16).all()
    dt = F.softplus(layer.dt_bias)
    assert (dt >= 1e-4 - 1e-9).all() and (dt <= 0.1 + 1e-6).all()
    assert torch.equal(layer.D, torch.ones(8)) and torch.equal(layer.conv1d.bias, torch.zeros(64 + 64))


def test_infer_lm_runs_the_kind(tmp_path):
    """`cli.infer_lm` on the Nemotron-H YAML with its widths cut, a small
    codec and vocoder."""
    from scipy.io import wavfile

    from dmel_codec_tpu_torch.cli import infer_lm
    from dmel_codec_tpu_torch.cli.common import build_lm_config
    from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
    from tests.test_torch_cli_precision import _lm_files
    from tests.test_torch_mla_moe import _vocoder_kw

    files = _lm_files(tmp_path)
    cfg = yaml.safe_load((ROOT / "configs/lm_infer_nemotron_h.yaml").read_text())
    cfg["slow_lm"].update(hidden_size=64, intermediate_size=128, num_layers=4, layer_pattern="M*EM", num_heads=4,
                          num_kv_heads=2, attention_head_dim=24, mamba_num_heads=8, mamba_head_dim=8,
                          mamba_n_groups=2, ssm_state_size=16, n_routed_experts=16, experts_held=4,
                          num_experts_per_tok=3, moe_intermediate_size=48, shared_expert_intermediate_size=96)
    cfg["fast_lm"] = files["fast_lm"]
    torch.manual_seed(3)
    lm = ChatMusicLM(build_lm_config(cfg))
    CheckpointManager(str(tmp_path / "lm_ckpt")).save(0, {"params": lm.state_dict(), "step": 0})
    cfg.update(lm_ckpt_dir=str(tmp_path / "lm_ckpt"), codec_ckpt_dir=files["codec_ckpt_dir"],
               vocoder_ckpt=str(tmp_path / "vocoder.pt"), model=files["codec_kw"], vocoder=_vocoder_kw())
    cfg["inference"].update(max_new_tokens=3, max_seq_len=64, top_k=1)
    (tmp_path / "infer.yaml").write_text(yaml.safe_dump(cfg))
    out = tmp_path / "out.wav"
    infer_lm.main(["--config", str(tmp_path / "infer.yaml"), "--prompt", "hi", "--out", str(out), "--device", "cpu"])
    sr, wav = wavfile.read(out)
    assert sr == 24000 and wav.ndim == 1 and len(wav) > 0 and np.isfinite(wav).all()
