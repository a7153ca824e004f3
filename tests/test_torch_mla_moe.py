"""The DeepSeek-V3 slow decoder (multi-head latent attention, a dense first
block, then mixtures of experts) against the plain reference
`benchmark/reference/lm_mla_moe.py`, on the CPU at a small size: 3 layers
(1 dense, 2 MoE) of 64, 4 heads, latent 32, rope 16, nope 32, value 32, 8
experts of which 3 a token, 1 shared, a vocabulary of 300. Weights are the
benchmark's draw from a seed (`benchmark/drivers/lm_dialog.params`).

Tolerances, relative to the reference's largest magnitude: float32 2e-5
(the same products summed in another order: the program's routed experts
add into a float32 sum by expert, its cache's decode takes the absorbed
form; measured 1e-6); gradients 1e-4 of each leaf's largest (the backward
adds the experts' and the heads' contributions in another order). The
program in bf16 against the float32 reference misses the logits' 2e-5 by
two orders of magnitude (the control).

The expanded form's attention core (`ops/mla_attention.py`): its plain
version given the positions returns the bits of the core under the mask
`Decoder.forward` builds; off the CPU (`meta`, the library stood in for) a
bf16 decoder of Moonlight's head sizes asks K5 for the core of each call
over several positions, and a caller's mask, float32, a gradient, one
position or other head sizes keep the plain core; a CPU generation reports
stats["mla_fused"] 0. K5 itself on the card: tests/test_torch_card_lm.py."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from benchmark.drivers import lm_dialog
from benchmark.drivers.lm_generate import penalized
from benchmark.reference import lm as ref_lm
from benchmark.reference import lm_mla_moe as ref
from dmel_codec_tpu_torch.lm.generate import InferenceConfig, SlowFastGenerator
from dmel_codec_tpu_torch.models import deepseek_v3
from dmel_codec_tpu_torch.models.lm import ChatMusicLM
from dmel_codec_tpu_torch.models.transformer import Decoder, TransformerConfig

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5
GRAD_TOL = 1e-4
SEED = 2**31 + 77


def tiny_config() -> dict:
    cfg = json.loads((ROOT / "benchmark/configs/slowfast-moonlight-16b-a3b.json").read_text())
    cfg.update(vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=3, num_attention_heads=4,
               num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
               n_routed_experts=8, num_experts_per_tok=3, moe_intermediate_size=48, n_shared_experts=1,
               audio_codebook_count=4, audio_codebook_size=16, bos_token_id=256, eos_token_id=256,
               start_of_human_id=257, end_of_human_id=258, start_of_robot_id=259, end_of_robot_id=260,
               start_of_music_id=261, end_of_music_id=262, text_pad_id=263, slow_audio_pad_id=15,
               fast_audio_pad_id=12, audio_silence_id=[0, 1, 2, 3])
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
    p = lm_dialog.params(cfg, SEED, torch.float32, "cpu")
    with torch.device("meta"):
        model = ChatMusicLM(lm_dialog.lm_config(cfg))
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
    assert sum(v.numel() for v in model.parameters()) + CFG["n_routed_experts"] * 2 == sum(
        int(np.prod(s)) for s in ref.param_shapes(CFG).values())


def full_size_parameters() -> int:
    cfg = json.loads((ROOT / "benchmark/configs/slowfast-moonlight-16b-a3b.json").read_text())
    return sum(int(np.prod(s)) for s in ref.param_shapes(cfg).values())


def test_full_size_is_moonlight():
    """16.06 B at the published widths: the slow decoder, embeddings, heads
    and the fast side."""
    assert 16.0e9 < full_size_parameters() < 16.1e9


@torch.no_grad()
def teacher_forced_logits(model, p, text, audio):
    hid, _ = model.slow_decoder(model.embed_inputs(text, audio))
    q = ref.outer(p)
    want = ref.decoder(p, CFG, ref_lm.embed(q, CFG, text, audio))
    return model.text_head(hid), torch.nn.functional.linear(want, q["text_head.weight"])


def test_teacher_forced_logits():
    p, model = build()
    got, want = teacher_forced_logits(model, p, *grid(2, 12))
    assert rel(got, want) <= TOL


def test_bf16_control_fails():
    """The same weights held in bf16 (activations and cache too) miss the
    float32 tolerance: the comparison can tell the precisions apart."""
    p, model = build(dtype=torch.bfloat16)
    got, want = teacher_forced_logits(model, p, *grid(2, 12))
    assert rel(got, want) > 10 * TOL


@pytest.mark.parametrize("score_elements", [deepseek_v3.SCORE_ELEMENTS, 64], ids=["one_block", "query_chunks"])
@torch.no_grad()
def test_prefill_then_decode_through_the_latent_cache(score_elements, monkeypatch):
    """A prefill of 5 positions (the expanded form over the cache, its
    queries in chunks of 1 with a small block), then 7 one-position steps
    (the absorbed form), against the full forward at every position and
    against the reference; the routing log, asked for, holds the experts
    the full forward routed each position to, and the cache holds the
    latents alone."""
    monkeypatch.setattr(deepseek_v3, "SCORE_ELEMENTS", score_elements)
    p, model = build()
    text, audio = grid(2, 12)
    x = model.embed_inputs(text, audio)
    routed = []
    hooks = [m.register_forward_hook(lambda mod, args, out: routed.append(out[0]))
             for m in model.modules() if isinstance(m, deepseek_v3.TopkRouter)]
    full, _ = model.slow_decoder(x)
    for h in hooks:
        h.remove()
    cache = model.init_slow_cache(2, 16)
    assert set(cache) == {"kv", "index"} and cache["kv"].shape == (3, 2, 16, 32 + 16)
    log = model.slow_decoder.track_routes(2, 16)
    assert log.shape == (2, 2, 16, 3) and log.dtype == torch.int16
    parts = []
    for lo, hi in [(0, 5)] + [(i, i + 1) for i in range(5, 12)]:
        h, cache = model.slow_decoder(x[:, lo:hi], cache=cache)
        parts.append(h)
    assert int(cache["index"]) == 12
    for layer, chosen in zip(log[:, :, :12], routed):
        assert torch.equal(layer.long().sort(-1).values, chosen.view(2, 12, 3).sort(-1).values)
    assert not log[:, :, 12:].any()
    stepped = torch.cat(parts, 1)
    assert rel(stepped, full) <= TOL
    q = ref.outer(p)
    assert rel(stepped, ref.decoder(p, CFG, ref_lm.embed(q, CFG, text, audio))) <= TOL


@torch.no_grad()
def test_the_routing_log_is_made_only_when_asked():
    """A cache's call logs no routing until someone asks; the log is made
    once (a captured graph keeps writing to it); a Qwen2 decoder has none."""
    _, model = build()
    decoder = model.slow_decoder
    x = model.embed_inputs(*grid(2, 6))
    decoder(x, cache=model.init_slow_cache(2, 8))
    assert decoder.route_log is None and all(getattr(l.mlp, "route_log", None) is None for l in decoder.layers)
    log = decoder.track_routes(2, 8)
    assert decoder.track_routes(2, 8) is log
    with pytest.raises(ValueError, match="routing log"):
        decoder.track_routes(4, 8)
    qwen2 = TransformerConfig(vocab_size=32, hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2,
                              num_kv_heads=1)
    assert Decoder(qwen2).track_routes(2, 8) is None


def test_loss_and_gradients():
    p, model = build()
    b, s, c = 2, 10, CFG["audio_codebook_count"]
    text, audio = grid(b, s, seed=3)
    text_labels = text.clone()
    audio_labels = audio.clone()
    text_labels[:, :3] = ref_lm.IGNORE
    audio_labels[:, :3] = ref_lm.IGNORE
    valid = torch.ones(b, s)
    valid[1, -2:] = 0.0
    batch = {"text_tokens": text, "audio_tokens": audio, "text_labels": text_labels, "audio_labels": audio_labels,
             "valid": valid}
    out = model(model.embed_inputs(text, audio) * valid[..., None], text_labels, audio_labels)
    out["loss"].backward()
    leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    t, a = ref.losses(leaves, CFG, batch, ref_lm.label_counts(batch))
    loss = CFG["text_weight"] * t + CFG["audio_weight"] * a
    loss.backward()
    got, want = float(out["loss"].detach()), float(loss.detach())
    assert abs(got - want) <= TOL * max(1.0, abs(want))
    named = dict(model.named_parameters())
    assert set(named) == set(leaves) - {k for k in leaves if k.endswith("e_score_correction_bias")}
    for name, param in named.items():
        want = leaves[name].grad
        assert float((param.grad - want).abs().max()) <= GRAD_TOL * max(1e-6, float(want.abs().max())), name


def moe_layer():
    _, model = build()
    return model.slow_decoder.layers[1].mlp


def test_the_bias_selects_and_does_not_weight():
    moe = moe_layer()
    x = torch.randn(20, CFG["hidden_size"], generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        moe.gate.e_score_correction_bias.zero_()
        moe.gate.e_score_correction_bias[[1, 4, 6]] = 10.0
        chosen, w = moe.gate(x)
    assert (chosen.sort(-1).values == torch.tensor([1, 4, 6])).all()
    scores = torch.sigmoid(x @ moe.gate.weight.detach().T)[:, [1, 4, 6]]
    want = CFG["routed_scaling_factor"] * scores / scores.sum(-1, keepdim=True)
    assert torch.allclose(w.gather(1, chosen.argsort(-1)), want, atol=1e-6)


@torch.no_grad()
def test_a_batch_routed_to_one_expert_drops_nothing():
    """Every token of a batch chooses expert 5 (a large bias): the routed
    path computes all of them there, the same sum as the decode's dense
    path and as the reference's loop, and the counter says so."""
    _, model = build()
    decoder = model.slow_decoder
    counts = decoder.track_pairs()
    moe = decoder.layers[1].mlp
    moe.gate.e_score_correction_bias[5] = 100.0
    x = torch.randn(3, 40, CFG["hidden_size"], generator=torch.Generator().manual_seed(2))
    flat = x.reshape(-1, CFG["hidden_size"])
    chosen, w = moe.gate(flat)
    assert (chosen == 5).any(-1).all()
    routed = moe(x)
    assert int(counts[0, 0, 5]) == 120 and int(counts[0, 0].sum()) == 120 * CFG["num_experts_per_tok"]
    dense = moe.experts.dense(flat, chosen, w) + moe.shared_experts(flat)
    w_ref = {k[len("slow_decoder.layers.1."):]: v.float() for k, v in model.state_dict().items()
             if k.startswith("slow_decoder.layers.1.")}
    want = ref.moe(w_ref, CFG, x)
    assert rel(routed, want) <= TOL and rel(dense.view_as(x), want) <= TOL
    moe(x[:, :1])  # a one-position step counts under decode
    assert int(counts[0, 1].sum()) == 3 * CFG["num_experts_per_tok"]


@torch.no_grad()
def test_generate_batched_greedy_is_the_references_argmax():
    """Greedy generation (top_k 1) on the CPU, its step the one a graph
    captures on the card: each served token is the reference's best under
    the same repetition penalty, at every frame."""
    p, model = build()
    icfg = dict(temperature=0.7, top_k=1, top_p=0.8, windows_penalty=1.2, windows_length=4, max_new_tokens=6,
                max_seq_len=24)
    gen = SlowFastGenerator(model, InferenceConfig(**icfg))
    text, audio = grid(2, 10, seed=5)
    log = model.slow_decoder.track_routes(2, 24)  # the served positions' experts, which the reference follows below
    audio_ids, text_ids = gen.generate_batched(text.numpy(), audio.numpy())
    assert gen.stats["pairs_prefill"].shape == (2, CFG["n_routed_experts"])
    assert (gen.stats["pairs_prefill"].sum(-1) == 2 * 10 * CFG["num_experts_per_tok"]).all()
    assert (gen.stats["pairs_decode"].sum(-1) == 2 * 5 * CFG["num_experts_per_tok"]).all()  # frames 1..5
    q = ref.outer(p)
    c = CFG["audio_codebook_count"]
    for row in range(2):
        t, a = text_ids[row], audio_ids[row]
        n = len(t)
        seq_t = torch.cat([text[row], torch.as_tensor(t[:-1])])[None]
        seq_a = torch.cat([audio[row], torch.as_tensor(a[:-1])])[None]
        routes = []
        forced = log[:, row, :10 + n - 1].long()
        hid = ref.decoder(p, CFG, ref_lm.embed(q, CFG, seq_t, seq_a), routes=routes, forced=forced)[0, 9:]
        for (own, gap), chosen in zip(routes, forced):  # in float32 the served routing is the reference's own
            assert torch.equal(own.sort(-1).values, chosen.sort(-1).values) and float(gap.max()) == 0.0
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
    """configs/lm_infer_moonlight.yaml gives the slow decoder the benchmark
    runs, without building it."""
    from dmel_codec_tpu_torch.cli.common import build_lm_config
    from dmel_codec_tpu_torch.utils.config import load_yaml

    got = build_lm_config(load_yaml(str(ROOT / "configs/lm_infer_moonlight.yaml")))
    cfg = json.loads((ROOT / "benchmark/configs/slowfast-moonlight-16b-a3b.json").read_text())
    want = lm_dialog.lm_config(cfg)
    assert got.slow == want.slow and got.fast == want.fast
    assert got.slow.kind == "deepseek_v3" and (got.slow.num_layers, got.slow.first_k_dense_replace) == (27, 1)
    with pytest.raises(TypeError):
        build_lm_config({"slow_lm": {"kind": "deepseek_v3", "q_lora_rank": 1536}})


def test_tensor_parallelism_refuses_the_block():
    from dmel_codec_tpu_torch.parallel.tensor import set_model_groups

    _, model = build()
    with pytest.raises(NotImplementedError, match="latent attention and experts"):
        set_model_groups(model, {}, None)


def test_infer_lm_runs_the_kind(tmp_path):
    """`cli.infer_lm` on the Moonlight YAML with its widths cut (the
    special ids need the 163840 vocabulary), a small codec and vocoder."""
    from scipy.io import wavfile

    from dmel_codec_tpu_torch.cli import infer_lm
    from dmel_codec_tpu_torch.cli.common import build_lm_config
    from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
    from tests.test_torch_cli_precision import _lm_files

    files = _lm_files(tmp_path)
    cfg = yaml.safe_load((ROOT / "configs/lm_infer_moonlight.yaml").read_text())
    cfg["slow_lm"].update(hidden_size=64, intermediate_size=128, num_layers=3, num_heads=4, num_kv_heads=4,
                          kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
                          n_routed_experts=8, num_experts_per_tok=3, moe_intermediate_size=48, n_shared_experts=1)
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


def _vocoder_kw() -> dict:
    from tests.test_torch_support import VOCODER_KW

    return {k: list(v) if isinstance(v, tuple) else v for k, v in VOCODER_KW.items()}


# ---- the attention core of the expanded form: the plain version given positions, and K5's dispatch ----

def _core_inputs(b, s, t, dtype, seed=0, heads=4, nope=32, rope=16, v=32):
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen).to(dtype)

    return draw(b, s, heads, nope), draw(b, s, heads, rope), draw(b, t, heads, nope), draw(b, t, rope), draw(b, t, heads, v)


# (S, T, index): a cache-less causal call (T = S), cached calls over S > 1 at index 0 and past it; S is no
# multiple of 64 but the first
CORE_CASES = {"cache-less 64": (64, 64, None), "cache-less 70": (70, 70, None), "cached 70 at 0": (70, 96, 0),
              "cached 5 at 0": (5, 16, 0), "cached 37 at 50": (37, 96, 50)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CORE_CASES))
@pytest.mark.parametrize("score_elements", [deepseek_v3.SCORE_ELEMENTS, 2000], ids=["one_block", "query_chunks"])
def test_plain_core_given_positions_is_the_mask_path(case, dtype, score_elements):
    """`mla_attention_reference` (and `mla_attention` on a CPU tensor) given
    the positions returns the bits of the core under the mask
    `Decoder.forward` builds: tril for a cache-less causal call, key_pos <=
    positions over a cache."""
    from dmel_codec_tpu_torch.ops import mla_attention as k5

    s, t, index = CORE_CASES[case]
    b = 2
    args = _core_inputs(b, s, t, dtype, seed=s + t)
    if index is None:
        positions = torch.arange(s).expand(b, s)
        mask = torch.ones(s, s, dtype=torch.bool).tril().expand(b, s, s)
    else:
        positions = (torch.tensor(index) + torch.arange(s)).expand(b, s)
        mask = torch.arange(t)[None, None, :] <= positions[:, :, None]
    scale = 1 / 48**0.5
    want = k5.expanded_attention(*args, mask, scale, score_elements)
    got = k5.mla_attention_reference(*args, positions, scale, score_elements)
    assert got.shape == (b, s, 4, 32) and got.dtype == dtype
    assert torch.equal(got, want)
    if score_elements == k5.SCORE_ELEMENTS:
        assert torch.equal(k5.mla_attention(*args, positions, scale), want)


# Moonlight's head sizes (16 heads of 128 + 64 / 128, latent 512) in a two-layer dense decoder small enough for `meta`
K5_SLOW = TransformerConfig(vocab_size=64, hidden_size=256, intermediate_size=128, num_layers=2, num_heads=16,
                            num_kv_heads=16, kind="deepseek_v3", kv_lora_rank=512, qk_nope_head_dim=128,
                            qk_rope_head_dim=64, v_head_dim=128, first_k_dense_replace=2)


class _K5Lib:
    """Records each K5 call's arguments."""

    def __init__(self):
        self.calls = []

    def dmel_mla_attention(self, *args):
        self.calls.append(args)
        return 0


def _k5_stand_in(monkeypatch) -> _K5Lib:
    from dmel_codec_tpu_torch.ops import library
    from dmel_codec_tpu_torch.ops import mla_attention as k5

    lib = _K5Lib()
    real_check = k5._check

    def check(*args):  # every check but the device's (meta tensors stand in for CUDA ones)
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            real_check(*args)

    monkeypatch.setattr(k5, "_check", check)
    monkeypatch.setattr(library, "load", lambda: lib)
    monkeypatch.setattr(library, "stream", lambda x: 0)
    return lib


def _meta_decoder(cfg=K5_SLOW, dtype=torch.bfloat16) -> Decoder:
    with torch.device("meta"):
        return Decoder(cfg).to(dtype).eval()


@torch.no_grad()
def test_k5_dispatch(monkeypatch):
    """Off the CPU (`meta`, the library stood in for), a bf16 decoder of
    Moonlight's head sizes without gradients runs the core of every call
    over several positions as one K5 launch a layer, cached (at S = 37 over
    96 positions) or cache-less and causal, with the call's sizes and
    positions; the one-position decode keeps the absorbed form; a caller's
    mask, float32, a gradient, S = 1 without a cache and head sizes K5 does
    not take keep the plain core and call nothing."""
    from dmel_codec_tpu_torch.ops import mla_attention as k5

    lib = _k5_stand_in(monkeypatch)
    dec = _meta_decoder()
    calls = deepseek_v3.LatentAttention.calls
    calls.update(fused=0, plain=0)
    launches = k5.mla_attention.launches
    x = torch.empty((3, 37, 256), device="meta", dtype=torch.bfloat16)
    cache = {"kv": torch.zeros((2, 3, 96, 576), device="meta", dtype=torch.bfloat16),
             "index": torch.zeros((), dtype=torch.long, device="meta")}
    out, cache = dec(x, cache=cache)
    assert out.shape == x.shape and len(lib.calls) == 2 and calls == {"fused": 2, "plain": 0}
    for args in lib.calls:
        assert len(args) == 17 and args[8:15] == (3, 37, 96, 16, 128, 64, 128)
        assert args[15] == pytest.approx(1 / 192**0.5)
        assert tuple(args[7]) == (37 * 16 * 192, 16 * 192, 192, 37 * 16 * 64, 16 * 64, 64, 96 * 16 * 256, 16 * 256,
                                  256, 96 * 576, 576, 96 * 16 * 256, 16 * 256, 256)
    assert k5.mla_attention.launches == launches + 2
    dec(x[:, :1], cache=cache)  # the decode: the absorbed form
    dec(x)  # cache-less and causal
    assert len(lib.calls) == 4 and calls == {"fused": 4, "plain": 0}
    assert lib.calls[-1][8:11] == (3, 37, 37)

    lib.calls.clear()
    calls.update(fused=0, plain=0)
    dec(x, attn_mask=torch.ones((3, 37, 37), dtype=torch.bool, device="meta"))  # a caller's mask
    dec(x[:, :1])  # one position without a cache
    with torch.enable_grad():
        dec(x)
    dec.float()(x.float())
    _meta_decoder(dataclasses.replace(K5_SLOW, qk_nope_head_dim=96, qk_rope_head_dim=32))(x)  # 128 deep
    assert lib.calls == [] and calls == {"fused": 0, "plain": 10}


def test_k5_check_refuses_what_it_does_not_take():
    """`_check` refuses (on `meta` tensors, before the device) float32
    operands, another head size, a mismatched key, a row that is not
    contiguous and float positions; a CPU tensor past those checks is not a
    CUDA one."""
    from dmel_codec_tpu_torch.ops import mla_attention as k5

    def args(dtype=torch.bfloat16, nope=128, device="meta"):
        q = torch.empty((2, 5, 16, nope + 64), device=device, dtype=dtype)
        kvb = torch.empty((2, 9, 16, nope + 128), device=device, dtype=dtype)
        kv = torch.empty((2, 9, 576), device=device, dtype=dtype)
        return [q[..., :nope], torch.empty((2, 5, 16, 64), device=device, dtype=dtype), kvb[..., :nope], kv[..., 512:],
                kvb[..., nope:], torch.zeros((2, 5), dtype=torch.long, device=device)]

    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        k5._check(*args())
    for bad, match in ((args(torch.float32), "must be bf16"), (args(nope=96), r"heads of 128 \+ 64"),
                       (args()[:3] + [torch.empty((2, 8, 64), device="meta", dtype=torch.bfloat16)] + args()[4:],
                        "k_pe must be"),
                       (args()[:4] + [torch.empty((2, 9, 16, 136), device="meta", dtype=torch.bfloat16)[..., 4:132]]
                        + args()[5:], "contiguous and start on 16 bytes"),
                       (args()[:5] + [torch.zeros((2, 5), device="meta")], "positions must be integer"),
                       (args(device="cpu"), "must be a CUDA tensor")):
        with pytest.raises(ValueError, match=match):
            k5._check(*bad)


def test_generation_reports_no_fused_latent_attention_on_the_cpu():
    """A CPU generation with the DeepSeek-V3 slow decoder reports
    stats["mla_fused"] 0: its prefill's latent attention ran the plain
    core."""
    _, model = build()
    gen = SlowFastGenerator(model, InferenceConfig(max_new_tokens=2, max_seq_len=16, top_k=1))
    text, audio = grid(2, 6, seed=4)
    with torch.no_grad():
        gen.generate_batched(text.numpy(), audio.numpy(), torch.Generator().manual_seed(0))
    assert gen.stats["mla_fused"] == 0.0
    assert deepseek_v3.LatentAttention.calls["plain"] == 3 and deepseek_v3.LatentAttention.calls["fused"] == 0
