"""On the card: Kimi Linear's KDA scan at its published head size against
the recurrence, and a bf16 slow decoder of Kimi Linear's published widths
(four layers: three KDA and one NoPE latent attention; rank 0's share of
64 of the router's 256 experts) through `generate_batched`: its expanded
latent attention on K5, its captured frames the eager step's tokens at B =
16. Imports nothing of JAX (the suite runs without the tests' conftest).

Tolerances: the chunked scan in float32 (TF32 off) against the float64
recurrence, of max(1, the largest magnitude): 1e-5 at the gates of the
weights' draw and 1e-4 at gates down to -20 a step, as on the CPU
(tests/test_torch_kimi_linear.py); the KDA layer's prefill then decode in
bf16 against its own chunked call over every position, 2^-5 of max(1,
its largest output) (bf16 projections and convolution inputs through the
two forms' different orders of summation)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from dmel_codec_tpu_torch.lm.generate import InferenceConfig, SlowFastGenerator
from dmel_codec_tpu_torch.models import kimi_linear
from dmel_codec_tpu_torch.models.deepseek_v3 import LatentAttention
from dmel_codec_tpu_torch.models.lm import ChatMusicLM, SlowFastLMConfig
from dmel_codec_tpu_torch.models.transformer import TransformerConfig
from dmel_codec_tpu_torch.ops.mla_attention import mla_attention
from tests.card import on_card, rel_err

pytestmark = pytest.mark.card

SCAN_TOL, STEEP_TOL, LAYER_TOL = 1e-5, 1e-4, 2.0**-5
# Kimi-Linear-48B-A3B's slow decoder at its published widths, cut to four layers (KDA at 0, 1, 2, latent
# attention at 3), rank 0's share of the experts
KIMI = TransformerConfig(
    vocab_size=163840, hidden_size=2304, intermediate_size=9216, num_layers=4, num_heads=32, num_kv_heads=32,
    rms_norm_eps=1e-5, rope_theta=10000.0, kind="kimi_linear", kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=256, num_experts_per_tok=8, moe_intermediate_size=1024,
    n_shared_experts=1, first_k_dense_replace=1, routed_scaling_factor=2.446, experts_held=64, expert_offset=0,
    kda_layers=(0, 1, 2), kda_num_heads=32, kda_head_dim=128, kda_conv_size=4)


def _recurrence(q, k, v, g, beta, state):
    q, k, v, g, beta, s = (t.double() for t in (q, k, v, g, beta, state))
    o = torch.zeros_like(v)
    for t in range(q.shape[1]):
        s = s * g[:, t].exp()[..., None]
        err = v[:, t] - torch.einsum("nk,nkv->nv", k[:, t], s)
        s = s + torch.einsum("nk,nv->nkv", beta[:, t, None] * k[:, t], err)
        o[:, t] = torch.einsum("nk,nkv->nv", q[:, t], s)
    return o, s


@pytest.mark.parametrize("steepest", [None, -20.0], ids=["drawn", "gates_to_-20"])
def test_the_scan_at_published_heads_is_the_recurrence(steepest):
    """`chunk_kda` over 700 positions (ten chunks and a padded tail) of 2
    rows x 32 heads of 128, from a state that is not zero."""
    dev = on_card()
    gen = torch.Generator(device=dev).manual_seed(11)
    n, s, d = 64, 700, 128

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q = torch.nn.functional.normalize(draw(n, s, d), dim=-1) / math.sqrt(d)
    k = torch.nn.functional.normalize(draw(n, s, d), dim=-1)
    v, beta = draw(n, s, d), torch.rand((n, s), generator=gen, device=dev)
    if steepest is None:
        dt = torch.empty(d, device=dev).uniform_(math.log(1e-3), math.log(1e-1), generator=gen).exp()
        a = torch.empty((n, 1, 1), device=dev).uniform_(1.0, 16.0, generator=gen)
        g = -a * torch.nn.functional.softplus(draw(n, s, d) + dt + torch.log(-torch.expm1(-dt)))
    else:
        g = torch.rand((n, s, d), generator=gen, device=dev) * steepest
    state = draw(n, d, d)
    o, last = kimi_linear.chunk_kda(q, k, v, g, beta, state)
    want_o, want_s = _recurrence(q, k, v, g, beta, state)
    tol = SCAN_TOL if steepest is None else STEEP_TOL
    assert bool(torch.isfinite(o).all()) and rel_err(o, want_o) <= tol and rel_err(last, want_s) <= tol


@pytest.fixture(scope="module")
def kimi():
    dev = on_card()
    torch.manual_seed(0)
    with torch.device(dev):
        model = ChatMusicLM(dataclasses.replace(SlowFastLMConfig(), slow=KIMI))
    yield model.to(torch.bfloat16).eval()
    del model
    torch.cuda.empty_cache()


@torch.no_grad()
def test_kda_prefill_then_steps_is_one_chunked_call(kimi):
    """A bf16 KDA layer at its published widths: a prefill of 300 positions
    then 20 one-position steps through its cache against one chunked call
    over all 320."""
    dev = on_card()
    layer = kimi.slow_decoder.layers[0].self_attn
    x = torch.randn((16, 320, 2304), device=dev).bfloat16()
    whole = layer(x)
    state = torch.zeros((16, 32, 128, 128), device=dev)
    conv = torch.zeros((16, 3, 3 * 4096), device=dev, dtype=torch.bfloat16)
    parts = [layer(x[:, :300], (state, conv))] + [layer(x[:, t:t + 1], (state, conv)) for t in range(300, 320)]
    assert rel_err(torch.cat(parts, 1), whole) <= LAYER_TOL


def _prompts(b: int, s: int):
    rng = np.random.default_rng(3)
    text = rng.integers(0, 151643, (b, s))
    audio = rng.integers(0, 180, (b, s, 10)) + np.arange(10) * 180
    return text, audio


@torch.no_grad()
def test_generation_captures_the_eager_step(kimi):
    """generate_batched at B = 16 over 600-position prompts, bf16 weights
    and cache: every expanded latent attention call on K5 (mla_fused 1.0,
    one launch a prefill), the KDA prefill's positions counted, and the
    captured graph's frames the eager step's tokens."""
    dev = on_card()
    gen = SlowFastGenerator(kimi, InferenceConfig(max_new_tokens=24, max_seq_len=640, cache_dtype="bfloat16"))
    text, audio = _prompts(16, 600)
    before = mla_attention.launches
    graph = list(zip(*gen.generate_batched(text, audio, torch.Generator(device=dev).manual_seed(5))))
    assert gen.stats["graphed"] and gen.stats["mla_fused"] == 1.0 and LatentAttention.calls == {"fused": 1, "plain": 0}
    assert mla_attention.launches == before + 1 and gen.stats["kda_positions"] == 16 * 600 * 3
    texts, audios, lengths = gen._generate(text, audio, torch.Generator(device=dev).manual_seed(5),
                                           gen._fast_decode_fixed, gen._fast_decode_fixed, graphed=False)
    eager = [(audios[i, : lengths[i]], texts[i, : lengths[i]]) for i in range(16)]
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) for x, y in zip(graph, eager))
