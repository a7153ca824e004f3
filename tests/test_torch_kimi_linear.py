"""The Kimi Linear slow decoder (KDA and NoPE latent attention 3:1, a dense
first block, then mixtures of experts of which this rank holds a share)
against the plain reference `benchmark/reference/lm_kda.py`, on the CPU at a
small size: 5 layers of 64 (KDA at 0, 1, 2 and 4, latent attention at 3),
KDA 2 heads of 16 with 4-tap convolutions, latent attention 4 heads of 32
+ 16 / 32 over a latent of 32, a router of 16 experts of which rank 0 holds
4, 3 a token, 1 shared, a vocabulary of 300. Weights are the benchmark's
draw from a seed (`benchmark/drivers/lm_dialog_kimi.params`).

Tolerances, relative to the reference's largest magnitude: float32 2e-5
(the same products summed in another order: the chunked scan's WY form
against the reference's position-by-position recurrence, the routed
experts' float32 sum by expert, the cache's absorbed decode; measured
6.3e-6 teacher-forced, 4.2e-6 through the cache); the chunked scan alone
against a float64 recurrence 1e-5 of max(1, the largest magnitude) at the
draw's gates (measured 2e-7) and 1e-4 at gates down to -20 a step
(measured 1.6e-5: the state's entries are sums of terms decayed by up to
e^-1280 whose float32 roundings no longer cancel). The program in bf16 misses the logits' 2e-5
by orders of magnitude (the control), and so do three planted faults: a
per-head scalar gate, a decode that drops the convolutions' state, and a
share that wraps absent experts onto held ones."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from benchmark.drivers import lm_dialog_kimi as driver
from benchmark.drivers.lm_generate import penalized
from benchmark.reference import lm as ref_lm
from benchmark.reference import lm_kda as ref
from dmel_codec_tpu_torch.lm.generate import InferenceConfig, SlowFastGenerator
from dmel_codec_tpu_torch.models import kimi_linear
from dmel_codec_tpu_torch.models.deepseek_v3 import Experts, LatentAttention, MoE
from dmel_codec_tpu_torch.models.lm import ChatMusicLM
from dmel_codec_tpu_torch.models.transformer import init_kv_cache

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5
SCAN_TOL = 1e-5
STEEP_TOL = 1e-4
SEED = 2**31 + 91


def tiny_config(rank: int = 0) -> dict:
    cfg = json.loads((ROOT / "benchmark/configs/slowfast-kimi-linear-48b-a3b-ep4.json").read_text())
    cfg.update(vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=5, num_attention_heads=4,
               num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
               num_experts=4, published_num_experts=16, num_experts_per_token=3, moe_intermediate_size=48,
               audio_codebook_count=4, audio_codebook_size=16, bos_token_id=256, eos_token_id=256,
               start_of_human_id=257, end_of_human_id=258, start_of_robot_id=259, end_of_robot_id=260,
               start_of_music_id=261, end_of_music_id=262, text_pad_id=263, slow_audio_pad_id=15,
               fast_audio_pad_id=12, audio_silence_id=[0, 1, 2, 3])
    cfg["linear_attn_config"] = dict(cfg["linear_attn_config"], kda_layers=[1, 2, 3, 5], full_attn_layers=[4],
                                     num_heads=2, head_dim=16)
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


def test_shapes_are_the_references():
    _, model = build()
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == dict(ref.param_shapes(CFG))
    kinds = [type(layer.self_attn) for layer in model.slow_decoder.layers]
    assert kinds == [kimi_linear.KimiDeltaAttention] * 3 + [LatentAttention, kimi_linear.KimiDeltaAttention]
    experts = model.slow_decoder.layers[1].mlp.experts
    assert experts.gate_up_proj.shape[0] == 4 and model.slow_decoder.layers[1].mlp.gate.weight.shape[0] == 16


def test_full_size_is_the_share():
    """Rank 0's share at the published widths: 13.9 B parameters, 27.8 GB
    in bf16 (the held experts 11.8 B); the KDA layers 39.5 M and the latent
    attention layers 29.1 M each."""
    cfg = json.loads((ROOT / "benchmark/configs/slowfast-kimi-linear-48b-a3b-ep4.json").read_text())
    shapes = ref.param_shapes(cfg)
    total = sum(int(np.prod(s)) for s in shapes.values())
    experts = sum(int(np.prod(s)) for n, s in shapes.items() if ".experts." in n)
    assert 13.8e9 < total < 14.0e9 and 11.7e9 < experts < 11.9e9
    attn = {n: sum(int(np.prod(s)) for k, s in shapes.items() if k.startswith(f"slow_decoder.layers.{n}.self_attn."))
            for n in (0, 3)}
    assert 39.4e6 < attn[0] < 39.6e6 and 29.0e6 < attn[3] < 29.2e6
    assert cfg["num_experts"] * 4 == cfg["published_num_experts"] == 256


def naive_kda(q, k, v, g, beta, state):
    """The recurrence position by position in float64."""
    q, k, v, g, beta, s = (t.double() for t in (q, k, v, g, beta, state))
    o = torch.zeros_like(v)
    for t in range(q.shape[1]):
        s = s * g[:, t].exp()[..., None]
        s = s + (beta[:, t, None] * k[:, t])[..., None] * (v[:, t] - torch.einsum("nk,nkv->nv", k[:, t], s))[:, None, :]
        o[:, t] = torch.einsum("nk,nkv->nv", q[:, t], s)
    return o, s


@pytest.mark.parametrize("steepest", [None, -20.0], ids=["drawn", "gates_to_-20"])
@pytest.mark.parametrize("s", [64, 70, 150, 7])
def test_chunked_scan_is_the_recurrence(s, steepest):
    """`chunk_kda` (chunks of 64, the tail padded) against the recurrence,
    from a state that is not zero: at the gates of the weights' draw
    (-exp(A_log) softplus(N(0, 1) + dt_bias)) and at gates down to -20 a
    step, where a factor of exp(+sum) would overflow float32 inside a
    chunk."""
    gen = torch.Generator().manual_seed(s)
    n, d = 6, 16
    q = torch.nn.functional.normalize(torch.randn(n, s, d, generator=gen), dim=-1) * d ** -0.5
    k = torch.nn.functional.normalize(torch.randn(n, s, d, generator=gen), dim=-1)
    v, beta = torch.randn(n, s, d, generator=gen), torch.rand(n, s, generator=gen)
    if steepest is None:
        dt = torch.empty(d).uniform_(np.log(1e-3), np.log(1e-1), generator=gen).exp()
        a_log = torch.empty(n, 1, 1).uniform_(1.0, 16.0, generator=gen).log()
        g = -a_log.exp() * torch.nn.functional.softplus(torch.randn(n, s, d, generator=gen) + dt + torch.log(-torch.expm1(-dt)))
    else:
        g = torch.rand(n, s, d, generator=gen) * steepest
    state = torch.randn(n, d, d, generator=gen)
    o, last = kimi_linear.chunk_kda(q, k, v, g, beta, state)
    want_o, want_s = naive_kda(q, k, v, g, beta, state)
    tol = SCAN_TOL if steepest is None else STEEP_TOL
    assert torch.isfinite(o).all() and torch.isfinite(last).all()
    assert rel(o, want_o.float()) <= tol and rel(last, want_s.float()) <= tol


def test_the_scan_groups_heads_alike(monkeypatch):
    """A chunked call whose heads go in groups (a small GROUP_BYTES) gives
    the bits of one group."""
    _, model = build()
    x = torch.randn(2, 70, CFG["hidden_size"], generator=torch.Generator().manual_seed(4))
    layer = model.slow_decoder.layers[0].self_attn
    with torch.no_grad():
        whole = layer(x)
        monkeypatch.setattr(kimi_linear, "GROUP_BYTES", 1)
        assert kimi_linear.head_group(2, 70, 2, 16) == 1
        assert torch.equal(layer(x), whole)


@torch.no_grad()
def teacher_forced_logits(model, p, text, audio, cfg=CFG):
    hid, _ = model.slow_decoder(model.embed_inputs(text, audio))
    q = ref.outer(p)
    want = ref.decoder(p, cfg, ref_lm.embed(q, cfg, text, audio))
    return model.text_head(hid), torch.nn.functional.linear(want, q["text_head.weight"])


def test_teacher_forced_logits():
    p, model = build()
    got, want = teacher_forced_logits(model, p, *grid(2, 80))
    assert rel(got, want) <= TOL


def test_bf16_control_fails():
    """The same weights held in bf16 (activations too) miss the float32
    tolerance: the comparison tells the precisions apart."""
    p, model = build(dtype=torch.bfloat16)
    got, want = teacher_forced_logits(model, p, *grid(2, 80))
    assert rel(got, want) > 10 * TOL


def test_a_per_head_gate_is_caught(monkeypatch):
    p, model = build()
    """A planted fault: one forget gate a head (its channels' mean) in place
    of one a channel."""
    real = kimi_linear.KimiDeltaAttention._gate
    monkeypatch.setattr(kimi_linear.KimiDeltaAttention, "_gate",
                        lambda self, pre, heads: real(self, pre, heads).mean(-1, keepdim=True).expand(
                            *real(self, pre, heads).shape))
    got, want = teacher_forced_logits(model, p, *grid(2, 80))
    assert rel(got, want) > 100 * TOL


@pytest.mark.parametrize("split", [[(0, 70)], [(0, 5), (5, 70)]], ids=["one_prefill", "two_prefills"])
@torch.no_grad()
def test_prefill_then_decode_through_the_hybrid_cache(split):
    """A prefill (or two: the second starts from the first's state and
    convolution inputs), then one-position steps (KDA's recurrent step,
    latent attention's absorbed form), against the full forward and the
    reference at every position, as logits; the cache holds the latent
    rows of the one latent attention layer and the four KDA layers' float32
    state beside the bf16 or float32 convolution inputs."""
    p, model = build()
    text, audio = grid(2, 78, seed=1)
    x = model.embed_inputs(text, audio)
    cache = model.init_slow_cache(2, 96)
    assert set(cache) == {"kv", "state", "conv", "index"}
    assert cache["kv"].shape == (1, 2, 96, 32 + 16) and cache["state"].shape == (4, 2, 2, 16, 16)
    assert cache["conv"].shape == (4, 2, 3, 3 * 32) and cache["state"].dtype == torch.float32
    assert init_kv_cache(model.config.slow, 2, 96, torch.bfloat16)["state"].dtype == torch.float32
    parts = []
    for lo, hi in split + [(i, i + 1) for i in range(70, 78)]:
        h, cache = model.slow_decoder(x[:, lo:hi], cache=cache)
        parts.append(h)
    assert int(cache["index"]) == 78
    stepped = model.text_head(torch.cat(parts, 1))
    full, want = teacher_forced_logits(model, p, text, audio)
    assert rel(stepped, full) <= TOL and rel(stepped, want) <= TOL


@torch.no_grad()
def test_a_decode_without_the_conv_state_is_caught(monkeypatch):
    p, model = build()
    text, audio = grid(2, 78, seed=1)
    x = model.embed_inputs(text, audio)
    real = kimi_linear.KimiDeltaAttention._step
    monkeypatch.setattr(kimi_linear.KimiDeltaAttention, "_step",
                        lambda self, x, state, conv: real(self, x, state, conv.zero_()))
    cache = model.init_slow_cache(2, 96)
    parts = []
    for lo, hi in [(0, 70)] + [(i, i + 1) for i in range(70, 78)]:
        h, cache = model.slow_decoder(x[:, lo:hi], cache=cache)
        parts.append(h)
    _, want = teacher_forced_logits(model, p, text, audio)
    assert rel(model.text_head(torch.cat(parts, 1)), want) > 100 * TOL


@torch.no_grad()
def test_nope_latent_attention_is_the_references():
    """The latent attention layer alone, expanded over 70 positions and
    absorbed over the cache, against the reference's NoPE attention: no
    rotation, kv_a_layernorm at rms_norm_eps, and the cache holds the rope
    part as it came."""
    p, model = build()
    layer = model.slow_decoder.layers[3].self_attn
    assert layer.config.kind == "kimi_linear" and layer.kv_a_layernorm.eps == CFG["rms_norm_eps"]
    w = {k[len("slow_decoder.layers.3."):]: v for k, v in p.items() if k.startswith("slow_decoder.layers.3.")}
    y = torch.randn(2, 70, CFG["hidden_size"], generator=torch.Generator().manual_seed(6))
    want = ref.attention(w, CFG, y)
    pos = torch.arange(70).expand(2, 70)
    cos, sin = torch.ones(2, 70, 16), torch.zeros(2, 70, 16)  # unused without rotation
    mask = torch.ones(70, 70, dtype=torch.bool).tril().expand(2, 70, 70)
    assert rel(layer(y, cos, sin, mask, mask_pos=pos), want) <= TOL
    scrambled = layer(y, torch.randn(2, 70, 16), torch.randn(2, 70, 16), mask, mask_pos=pos)
    assert torch.equal(scrambled, layer(y, cos, sin, mask, mask_pos=pos))
    cache = torch.zeros(2, 80, 48)
    first = layer(y[:, :69], cos[:, :69], sin[:, :69], (torch.arange(80)[None, None] <= pos[:, :69, None]),
                  cache, torch.arange(69), pos[:, :69])
    last = layer(y[:, 69:], cos[:, 69:], sin[:, 69:], (torch.arange(80)[None, None] <= pos[:, 69:, None]),
                 cache, torch.tensor([69]), pos[:, 69:])
    assert rel(torch.cat([first, last], 1), want) <= TOL
    assert rel(cache[:, :70, 32:], torch.nn.functional.linear(y, layer.kv_a_proj_with_mqa.weight)[..., 32:]) <= TOL


@torch.no_grad()
def test_the_shares_add_up_to_the_whole_layer():
    """Each of the 4 ranks' MoE layer (its 4 experts of the router's 16)
    against the reference with every expert: the ranks' parts, with the
    shared expert counted once, add up to the uncut layer; routed (several
    positions) and dense (one) alike, and a rank's layer is the reference's
    share."""
    y = torch.randn(3, 20, CFG["hidden_size"], generator=torch.Generator().manual_seed(8))
    flat = y.reshape(-1, CFG["hidden_size"])
    whole_cfg = dict(CFG, num_experts=16)
    whole_p = driver.params(whole_cfg, SEED, torch.float32, "cpu")
    prefix = "slow_decoder.layers.1."
    w_whole = {k[len(prefix):]: v for k, v in whole_p.items() if k.startswith(prefix)}
    want = ref.moe(w_whole, whole_cfg, y)
    routed, dense = torch.zeros_like(y), torch.zeros_like(flat)
    shared = None
    for rank in range(4):
        cfg = tiny_config(rank)
        w = dict(w_whole)
        w["mlp.experts.gate_up_proj"] = w_whole["mlp.experts.gate_up_proj"][4 * rank:4 * rank + 4]
        w["mlp.experts.down_proj"] = w_whole["mlp.experts.down_proj"][4 * rank:4 * rank + 4]
        moe = MoE(driver.lm_config(cfg).slow)
        moe.load_state_dict({k[len("mlp."):]: v for k, v in w.items() if k.startswith("mlp.")})
        assert (moe.experts.offset, moe.experts.gate_up_proj.shape[0]) == (4 * rank, 4)
        part = moe(y)
        assert rel(part, ref.moe(w, cfg, y)) <= TOL
        shared = moe.shared_experts(flat).view_as(y)
        routed += part - shared
        chosen, weights = moe.gate(flat)
        dense += moe.experts.dense(flat, chosen, weights)
    assert rel(routed + shared, want) <= TOL
    assert rel((dense + moe.shared_experts(flat)).view_as(y), want) <= TOL


@torch.no_grad()
def test_a_wrapped_share_is_caught(monkeypatch):
    """A planted fault: the routed form computes a pair routed to an absent
    expert with the held expert its id wraps onto."""
    y = torch.randn(3, 20, CFG["hidden_size"], generator=torch.Generator().manual_seed(8))
    p, model = build()
    moe = model.slow_decoder.layers[1].mlp
    w = {k[len("slow_decoder.layers.1."):]: v for k, v in p.items() if k.startswith("slow_decoder.layers.1.")}
    want = ref.moe(w, CFG, y)
    assert rel(moe(y), want) <= TOL
    real = Experts.routed
    monkeypatch.setattr(Experts, "routed", lambda self, x, chosen, wt: real(self, x, chosen % 4, wt))
    assert rel(moe(y), want) > 100 * TOL


def routed_before(self, x, chosen, w):
    """`Experts.routed` as it was before the share (whole layers only)."""
    k = chosen.shape[1]
    flat = chosen.flatten()
    order = torch.argsort(flat, stable=True)
    token = order // k
    weight = w.flatten()[order]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(torch.bincount(flat, minlength=self.gate_up_proj.shape[0]).tolist()):
        if n:
            rows = token[start:start + n]
            gate, up = torch.nn.functional.linear(x.index_select(0, rows), self.gate_up_proj[e]).chunk(2, dim=-1)
            y = torch.nn.functional.linear(torch.nn.functional.silu(gate) * up, self.down_proj[e])
            out.index_add_(0, rows, y.float() * weight[start:start + n, None])
            start += n
    return out


def dense_before(self, x, chosen, w):
    """`Experts.dense` as it was before the share."""
    e, two_i, h = self.gate_up_proj.shape
    weights = torch.zeros((x.shape[0], e), dtype=torch.float32, device=x.device).scatter_(1, chosen, w)
    gate, up = torch.nn.functional.linear(x, self.gate_up_proj.view(e * two_i, h)).view(-1, e, two_i).chunk(2, dim=-1)
    y = torch.bmm((torch.nn.functional.silu(gate) * up).transpose(0, 1), self.down_proj.transpose(1, 2))
    return torch.einsum("enh,ne->nh", y.float(), weights)


@torch.no_grad()
def test_a_whole_layer_runs_todays_kernels():
    """With every expert held (Moonlight's layer) the routed and dense forms
    launch the operators they launched before the share, in the same
    order, and give the same bits."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from tests.test_torch_mla_moe import build as build_moonlight

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    _, model = build_moonlight()
    experts = model.slow_decoder.layers[1].mlp.experts
    assert experts.whole
    x = torch.randn(12, 64, generator=torch.Generator().manual_seed(1))
    chosen = torch.randint(0, 8, (12, 3), generator=torch.Generator().manual_seed(2))
    w = torch.rand(12, 3, generator=torch.Generator().manual_seed(3))
    for now, before in ((Experts.routed, routed_before), (Experts.dense, dense_before)):
        with Ops() as got:
            y = now(experts, x, chosen, w)
        with Ops() as want:
            y_before = before(experts, x, chosen, w)
        assert got.ops == want.ops and torch.equal(y, y_before)


@torch.no_grad()
def test_generate_batched_greedy_is_the_references_argmax():
    """Greedy generation (top_k 1) on the CPU, its step the one a graph
    captures on the card: each served token is the reference's best under
    the same repetition penalty, at every frame; the counter keeps router
    ids and counts the prefill's scanned positions."""
    p, model = build()
    icfg = dict(temperature=0.7, top_k=1, top_p=0.8, windows_penalty=1.2, windows_length=4, max_new_tokens=6,
                max_seq_len=80)
    gen = SlowFastGenerator(model, InferenceConfig(**icfg))
    text, audio = grid(2, 70, seed=5)
    log = model.slow_decoder.track_routes(2, 80)
    audio_ids, text_ids = gen.generate_batched(text.numpy(), audio.numpy())
    k = CFG["num_experts_per_token"]
    assert gen.stats["pairs_prefill"].shape == (4, 16)  # MoE layers, the router's experts
    assert (gen.stats["pairs_prefill"].sum(-1) == 2 * 70 * k).all()
    assert gen.stats["kda_positions"] == 2 * 70 * 4 and gen.stats["mla_fused"] == 0.0
    q = ref.outer(p)
    c = CFG["audio_codebook_count"]
    for row in range(2):
        t, a = text_ids[row], audio_ids[row]
        n = len(t)
        seq_t = torch.cat([text[row], torch.as_tensor(t[:-1])])[None]
        seq_a = torch.cat([audio[row], torch.as_tensor(a[:-1])])[None]
        forced = log[:, row, :70 + n - 1].long()
        hid = ref.decoder(p, CFG, ref_lm.embed(q, CFG, seq_t, seq_a), forced=forced)[0, 69:]
        text_logits = torch.nn.functional.linear(hid, q["text_head.weight"])
        pos0 = torch.nn.functional.linear(ref_lm.rms_norm(hid, q["fast_pre_norm.weight"], 1e-6),
                                          q["fast_projector.weight"], q["fast_projector.bias"])
        served = torch.as_tensor(a)
        fast_in = torch.cat([pos0[:, None], torch.nn.functional.embedding(served, q["fast_audio_embed.weight"])], 1)
        audio_logits = torch.nn.functional.linear(ref_lm.decoder(q, "fast_decoder", CFG["fast"], fast_in)[:, :c],
                                                  q["audio_head.weight"])
        window = torch.cat([audio[row], served])[-(n + icfg["windows_length"]):]
        audio_logits = penalized(audio_logits, window, icfg)
        assert torch.equal(text_logits.argmax(-1), torch.as_tensor(t))
        assert torch.equal(audio_logits.argmax(-1), served)


def test_the_yaml_is_the_benchmarks_configuration():
    """configs/lm_infer_kimi_linear.yaml gives the slow decoder the
    benchmark runs, without building it."""
    from dmel_codec_tpu_torch.cli.common import build_lm_config
    from dmel_codec_tpu_torch.utils.config import load_yaml

    got = build_lm_config(load_yaml(str(ROOT / "configs/lm_infer_kimi_linear.yaml")))
    cfg = json.loads((ROOT / "benchmark/configs/slowfast-kimi-linear-48b-a3b-ep4.json").read_text())
    want = driver.lm_config(cfg)
    assert got.slow == want.slow and got.fast == want.fast
    assert got.slow.kind == "kimi_linear" and got.slow.kda_layers == (0, 1, 2, 4, 5, 6, 8, 9, 10, 12, 13, 14, 16, 17,
                                                                       18, 20, 21, 22, 24, 25)
    assert (got.slow.n_routed_experts, got.slow.experts_held, got.slow.expert_offset) == (256, 64, 0)


def test_tensor_parallelism_refuses_the_block():
    from dmel_codec_tpu_torch.parallel.tensor import set_model_groups

    _, model = build()
    with pytest.raises(NotImplementedError, match="Kimi delta attention"):
        set_model_groups(model, {}, None)


def test_a_share_outside_the_router_is_refused():
    with pytest.raises(ValueError, match="among the router"):
        dataclasses.replace(driver.lm_config(CFG).slow, expert_offset=13)


def test_load_lm_builds_the_kind():
    """`cli.common.load_lm` (the meta device, then the state_dict's tensors)
    builds the Kimi Linear decoder; its KDA gates keep their float32."""
    from dmel_codec_tpu_torch.cli.common import load_lm

    p = driver.params(CFG, SEED, torch.bfloat16, "cpu")
    model = load_lm(driver.lm_config(CFG), p, "cpu")
    layer = model.slow_decoder.layers[0].self_attn
    assert layer.A_log.dtype == torch.float32 and layer.q_proj.weight.dtype == torch.bfloat16
    assert isinstance(layer, kimi_linear.KimiDeltaAttention)


def test_infer_lm_runs_the_kind(tmp_path):
    """`cli.infer_lm` on the Kimi Linear YAML with its widths cut (the
    special ids need the 163840 vocabulary), a small codec and vocoder."""
    from scipy.io import wavfile

    from dmel_codec_tpu_torch.cli import infer_lm
    from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
    from dmel_codec_tpu_torch.cli.common import build_lm_config
    from tests.test_torch_cli_precision import _lm_files
    from tests.test_torch_mla_moe import _vocoder_kw

    files = _lm_files(tmp_path)
    cfg = yaml.safe_load((ROOT / "configs/lm_infer_kimi_linear.yaml").read_text())
    cfg["slow_lm"].update(hidden_size=64, intermediate_size=128, num_layers=4, num_heads=4, num_kv_heads=4,
                          kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
                          n_routed_experts=16, experts_held=4, num_experts_per_tok=3, moe_intermediate_size=48,
                          kda_layers=[0, 1, 2], kda_num_heads=2, kda_head_dim=16)
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
