"""On the card: Nemotron-H's serving attention on FA at the long-dialog
cell's prefill shape against the plain core, the chunked SSD at
Nemotron-3-Nano's published Mamba widths against the float64 recurrence,
a bf16 Mamba-2 layer's prefill and steps against one chunked call, and a
bf16 slow decoder of Nemotron-3-Nano's published widths (four layers: two
Mamba-2, one attention, one of rank 0's 64 of the router's 128 experts)
through `generate_batched`: its attention prefill on FA (attn_flash 1.0),
its captured frames the eager step's tokens at B = 16. Imports nothing of
JAX (the suite runs without the tests' conftest).

Tolerances: FA against the plain core in float32 from the same bf16
inputs, `tests/card.py`'s `fa_rel` (one bf16 ulp of the output and the
kernel's rounding of P to bf16); the chunked SSD in float32 (TF32 off)
against the float64 recurrence, of max(1, the largest magnitude): 1e-5 at
the decays of the weights' draw and at decays down to -20 a step, as on
the CPU (tests/test_torch_nemotron_h.py, measured there at most 2.2e-7);
the Mamba layer's prefill
then decode in bf16 against its own chunked call over every position,
2^-5 of max(1, its largest output) (bf16 projections and convolution
inputs through the two forms' different orders of summation)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dmel_codec_tpu_torch.lm.generate import InferenceConfig, SlowFastGenerator
from dmel_codec_tpu_torch.models import nemotron_h
from dmel_codec_tpu_torch.models.lm import ChatMusicLM, SlowFastLMConfig
from dmel_codec_tpu_torch.models.transformer import TransformerConfig
from dmel_codec_tpu_torch.ops import flash_attention as fa_ops
from tests.card import fa_rel, on_card, rel_err

pytestmark = pytest.mark.card

SCAN_TOL, LAYER_TOL = 1e-5, 2.0**-5
# NVIDIA-Nemotron-3-Nano-30B-A3B's slow decoder at its published widths, cut to four layers (Mamba-2,
# attention, experts, Mamba-2), rank 0's share of the experts
NEMOTRON = TransformerConfig(
    vocab_size=131072, hidden_size=2688, intermediate_size=1856, num_layers=4, num_heads=32, num_kv_heads=2,
    rms_norm_eps=1e-5, rope_theta=10000.0, kind="nemotron_h", layer_pattern="M*EM", mamba_num_heads=64,
    mamba_head_dim=64, ssm_state_size=128, mamba_n_groups=8, mamba_conv_kernel=4, attention_head_dim=128,
    n_routed_experts=128, num_experts_per_tok=6, moe_intermediate_size=1856, n_shared_experts=1,
    shared_expert_intermediate_size=3712, mlp_hidden_act="relu2", routed_scaling_factor=2.5, experts_held=64)
# the text special ids inside its vocabulary (benchmark/configs/slowfast-nemotron-3-nano-30b-a3b-ep2.json)
IDS = dict(zip(("bos_token_id", "start_of_human_id", "end_of_human_id", "start_of_robot_id", "end_of_robot_id",
                "start_of_music_id", "end_of_music_id", "text_pad_id"), range(131064, 131072)), eos_token_id=131064)
LONG_DIALOG = (16, 12343)  # the long-dialog cell's prefill: rows, positions


@torch.no_grad()
def test_fa_at_the_cells_prefill_is_the_plain_core():
    """FA over the cell's prefill (16 rows of 12,343 positions, 32 query
    heads over 2 of 128, bf16) against the plain core in float32 from the
    same inputs; a layer call from the empty cache launches it once."""
    dev = on_card()
    b, s = LONG_DIALOG
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((b, s, 32, 128), device=dev, generator=gen).bfloat16()
    k, v = (torch.randn((b, s, 2, 128), device=dev, generator=gen).bfloat16() for _ in range(2))
    got = fa_ops.flash_attention(q, k, v)
    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril().expand(b, s, s)
    want = nemotron_h.attend(q.float(), k.float(), v.float(), causal, 128 ** -0.5)
    assert rel_err(got, want) <= fa_rel(torch.bfloat16, v, want)
    del q, k, v, causal, got, want
    with torch.device(dev):
        layer = nemotron_h.NoPEAttention(dataclasses.replace(NEMOTRON, layer_pattern="*", num_layers=1))
    layer = layer.to(torch.bfloat16)
    x = torch.randn((b, s, 2688), device=dev, generator=gen).bfloat16()
    cache = tuple(torch.zeros((b, 12544, 2, 128), device=dev, dtype=torch.bfloat16) for _ in range(2))
    pos = torch.arange(s, device=dev).expand(b, s)
    nemotron_h.NoPEAttention.calls.update(flash=0, plain=0)
    before = fa_ops.flash_attention.launches
    out = layer(x, None, cache, torch.arange(s, device=dev), pos)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert fa_ops.flash_attention.launches == before + 1 and nemotron_h.NoPEAttention.calls == {"flash": 1, "plain": 0}


def _naive(x, a, b, c, state):
    x, a, b, c, h = (t.double() for t in (x, a, b, c, state))
    y = torch.zeros_like(x)
    for t in range(x.shape[1]):
        h = h * a[:, t].exp()[..., None, None] + x[:, t, ..., None] * b[:, t, :, None, None, :]
        y[:, t] = (h * c[:, t, :, None, None, :]).sum(-1)
    return y, h


@torch.no_grad()
@pytest.mark.parametrize("steepest", [None, -20.0], ids=["drawn", "decays_to_-20"])
def test_the_ssd_at_published_widths_is_the_recurrence(steepest):
    """`ssd` at 8 groups of 8 heads of 64 and a state of 128, over 300
    positions (two whole chunks and a ragged one) from a state that is not
    zero, against the float64 recurrence."""
    dev = on_card()
    gen = torch.Generator(device=dev).manual_seed(2)
    r, s, g, h, p, n = 2, 300, 8, 8, 64, 128

    def draw(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    x, b, c = draw(r, s, g, h, p), draw(r, s, g, n), draw(r, s, g, n)
    if steepest is None:
        dt_bias = torch.empty((g, h), device=dev).uniform_(math.log(1e-3), math.log(1e-1), generator=gen).exp_()
        dt = F.softplus(draw(r, s, g, h) + dt_bias + torch.log(-torch.expm1(-dt_bias)))
        a = dt * -torch.empty((g, h), device=dev).uniform_(1.0, 16.0, generator=gen)
        x = x * dt[..., None]
    else:
        a = torch.rand((r, s, g, h), device=dev, generator=gen) * steepest
    state = draw(r, g, h, p, n)
    y, last = nemotron_h.ssd(x, a, b, c, state)
    want_y, want_s = _naive(x, a, b, c, state)
    assert rel_err(y, want_y.float()) <= SCAN_TOL and rel_err(last, want_s.float()) <= SCAN_TOL


@pytest.fixture(scope="module")
def nemotron():
    dev = on_card()
    torch.manual_seed(0)
    with torch.device(dev):
        model = ChatMusicLM(dataclasses.replace(SlowFastLMConfig(), slow=NEMOTRON, **IDS))
    yield model.to(torch.bfloat16).eval()
    del model
    torch.cuda.empty_cache()


@torch.no_grad()
def test_mamba_prefill_then_steps_is_one_chunked_call(nemotron):
    """A bf16 Mamba-2 layer at its published widths: a prefill of 300
    positions then 20 one-position steps through its cache against one
    chunked call over all 320."""
    dev = on_card()
    layer = nemotron.slow_decoder.layers[0].mixer
    x = torch.randn((16, 320, 2688), device=dev).bfloat16()
    whole = layer(x)
    state = torch.zeros((16, 64, 64, 128), device=dev)
    conv = torch.zeros((16, 3, 4096 + 2 * 8 * 128), device=dev, dtype=torch.bfloat16)
    parts = [layer(x[:, :300], (state, conv))] + [layer(x[:, t:t + 1], (state, conv)) for t in range(300, 320)]
    assert rel_err(torch.cat(parts, 1), whole) <= LAYER_TOL


@torch.no_grad()
def test_generation_captures_the_eager_step(nemotron):
    """generate_batched at B = 16 over 600-position prompts, bf16 weights
    and cache: the attention layer's prefill on FA (attn_flash 1.0, one
    launch), the Mamba prefill's positions counted, and the captured
    graph's frames the eager step's tokens."""
    dev = on_card()
    gen = SlowFastGenerator(nemotron, InferenceConfig(max_new_tokens=24, max_seq_len=640, cache_dtype="bfloat16"))
    rng = np.random.default_rng(3)
    text = rng.integers(0, 131064, (16, 600))
    audio = rng.integers(0, 180, (16, 600, 10)) + np.arange(10) * 180
    before = fa_ops.flash_attention.launches
    graph = list(zip(*gen.generate_batched(text, audio, torch.Generator(device=dev).manual_seed(5))))
    assert gen.stats["graphed"] and gen.stats["attn_flash"] == 1.0
    assert nemotron_h.NoPEAttention.calls == {"flash": 1, "plain": 0} and fa_ops.flash_attention.launches == before + 1
    assert gen.stats["ssd_positions"] == 16 * 600 * 2
    texts, audios, lengths = gen._generate(text, audio, torch.Generator(device=dev).manual_seed(5),
                                           gen._fast_decode_fixed, gen._fast_decode_fixed, graphed=False)
    eager = [(audios[i, : lengths[i]], texts[i, : lengths[i]]) for i in range(16)]
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) for x, y in zip(graph, eager))
