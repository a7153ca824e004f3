"""On the card: Kimi Linear's KDA scan at its published head size against
the recurrence, kernel K6 (the chunked core from the projections' outputs
to o, `ops/kda_scan.py`) against the float64 recurrence and against the
plain chunked path, and a bf16 slow decoder of Kimi Linear's published
widths (four layers: three KDA and one NoPE latent attention; rank 0's
share of 64 of the router's 256 experts) through `generate_batched`: its
expanded latent attention on K5, its KDA prefill on K6, its captured
frames the eager step's tokens at B = 16. Imports nothing of JAX (the
suite runs without the tests' conftest).

Tolerances: the chunked scan in float32 (TF32 off) against the float64
recurrence, of max(1, the largest magnitude): 1e-5 at the gates of the
weights' draw and 1e-4 at gates down to -20 a step, as on the CPU
(tests/test_torch_kimi_linear.py); K6 (split-TF32 products, float32
sums) against the float64 recurrence from the same bf16 inputs, the same
1e-5 / 1e-4; K6 against the plain chunked path, whose convolutions round
their outputs to bf16 (2^-9 relative) where K6 keeps float32, and the
KDA layer's prefill then decode in bf16 against its own chunked call over
every position, 2^-5 of max(1, its largest output) (bf16 projections and
convolution inputs through the two forms' different orders of
summation)."""

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
from dmel_codec_tpu_torch.ops import kda_scan as k6
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


def _k6_inputs(b: int, s: int, steepest, dev, seed: int = 13):
    """K6's inputs at 32 heads of 128 (bf16 projections N(0, 1), conv
    weights N(0, 1/4), carried convolution inputs and a state drawn too):
    the gates of the weights' draw, or -exp(A_log) softplus(f + dt_bias)
    spread over [-steepest, 0] a step."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    heads, d = 32, 128
    width = heads * d

    def draw(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    q, k, v = (draw(b, s, width).bfloat16() for _ in range(3))
    weights = [draw(width, 1, 4, std=0.5).bfloat16() for _ in range(3)]
    if steepest is None:
        a_log = torch.empty(heads, device=dev).uniform_(1.0, 16.0, generator=gen).log_()
        dt = torch.empty(width, device=dev).uniform_(math.log(1e-3), math.log(1e-1), generator=gen).exp_()
        dt_bias = dt + torch.log(-torch.expm1(-dt))
        f = draw(b, s, width).bfloat16()
    else:
        a_log, dt_bias = torch.zeros(heads, device=dev), torch.zeros(width, device=dev)
        u = torch.empty((b, s, width), device=dev).uniform_(1e-3, -steepest, generator=gen)
        f = (u + torch.log(-torch.expm1(-u))).bfloat16()  # softplus(f) = u
    beta = draw(b, s, heads).bfloat16()
    conv, state = draw(b, 3, 3 * width).bfloat16(), draw(b, heads, d, d)
    return (q, k, v, f, beta, weights, a_log, dt_bias, 1 / math.sqrt(d)), conv, state


def _k6_float64(args, conv, state):
    """K6's function in float64 from the same inputs: the convolutions,
    norms and gates, then the recurrence -> (o, last state, conv tails)."""
    q, k, v, f, beta, weights, a_log, dt_bias, scale = args
    b, s, width = q.shape
    heads, d = a_log.shape[0], width // a_log.shape[0]
    ops = []
    for j, (x, w) in enumerate(zip((q, k, v), weights)):
        full = torch.cat([conv[:, :, j * width:(j + 1) * width], x], 1).double()
        y = sum(full[:, m:m + s] * w[:, 0, m].double() for m in range(4))
        y = (y * torch.sigmoid(y)).view(b, s, heads, d)
        if j < 2:
            y = y / torch.sqrt((y * y).sum(-1, keepdim=True) + kimi_linear.L2NORM_EPS)
        ops.append(y * scale if j == 0 else y)
    g = -torch.exp(a_log.double())[:, None] * torch.nn.functional.softplus(
        f.double().view(b, s, heads, d) + dt_bias.double().view(heads, d))

    def rows(t):
        return t.transpose(1, 2).reshape(b * heads, s, *t.shape[3:])

    o, last = _recurrence(*(rows(t) for t in (*ops, g)), rows(torch.sigmoid(beta.double())),
                          state.reshape(b * heads, d, d))
    tails = torch.cat([torch.cat([conv[:, :, j * width:(j + 1) * width], x], 1)[:, s:] for j, x in enumerate((q, k, v))], -1)
    return o.view(b, heads, s, d).transpose(1, 2), last.view(b, heads, d, d), tails


@torch.no_grad()
@pytest.mark.parametrize("steepest", [None, -20.0], ids=["drawn", "gates_to_-20"])
def test_k6_is_the_recurrence(steepest):
    """K6 at 32 heads of 128 over 2 rows of 700 positions (ten chunks and a
    ragged tail), from a carried state and carried convolution inputs,
    against the float64 recurrence from the same bf16 inputs: o, the last
    state and the convolutions' last inputs (those exactly)."""
    dev = on_card()
    args, conv, state = _k6_inputs(2, 700, steepest, dev)
    want_o, want_s, want_tails = _k6_float64(args, conv, state)
    before = k6.kda_scan.launches
    o = k6.kda_scan(*args, conv, state)
    torch.cuda.synchronize()
    tol = SCAN_TOL if steepest is None else STEEP_TOL
    assert k6.kda_scan.launches == before + 1 and o.dtype == torch.float32 and bool(torch.isfinite(o).all())
    assert rel_err(o, want_o) <= tol and rel_err(state, want_s) <= tol
    assert torch.equal(conv, want_tails)


@torch.no_grad()
@pytest.mark.parametrize("s", [12343, 2], ids=["long_dialog", "shorter_than_the_halo"])
def test_k6_is_the_plain_chunked_path(s):
    """K6 against the plain chunked path (`kda_scan_reference`: the model's
    convolution and `chunk_kda`) at B = 2 from a carried state and carried
    convolution inputs: the long-dialog prompt's 12,343 positions (a ragged
    tail) and 2 positions (the tails then take carried inputs)."""
    dev = on_card()
    args, conv, state = _k6_inputs(2, s, None, dev, seed=s)
    conv_p, state_p = conv.clone(), state.clone()
    want = k6.kda_scan_reference(*args, conv_p, state_p)
    got = k6.kda_scan(*args, conv, state)
    assert rel_err(got, want) <= LAYER_TOL and rel_err(state, state_p) <= LAYER_TOL
    assert torch.equal(conv, conv_p)


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
    one launch a prefill), every KDA layer's prefill on K6 (kda_fused 1.0,
    one launch a layer), the KDA prefill's positions counted, and the
    captured graph's frames the eager step's tokens."""
    dev = on_card()
    gen = SlowFastGenerator(kimi, InferenceConfig(max_new_tokens=24, max_seq_len=640, cache_dtype="bfloat16"))
    text, audio = _prompts(16, 600)
    before, before_k6 = mla_attention.launches, k6.kda_scan.launches
    graph = list(zip(*gen.generate_batched(text, audio, torch.Generator(device=dev).manual_seed(5))))
    assert gen.stats["graphed"] and gen.stats["mla_fused"] == 1.0 and LatentAttention.calls == {"fused": 1, "plain": 0}
    assert mla_attention.launches == before + 1 and gen.stats["kda_positions"] == 16 * 600 * 3
    assert gen.stats["kda_fused"] == 1.0 and kimi_linear.KimiDeltaAttention.calls == {"fused": 3, "plain": 0}
    assert k6.kda_scan.launches == before_k6 + 3
    texts, audios, lengths = gen._generate(text, audio, torch.Generator(device=dev).manual_seed(5),
                                           gen._fast_decode_fixed, gen._fast_decode_fixed, graphed=False)
    eager = [(audios[i, : lengths[i]], texts[i, : lengths[i]]) for i in range(16)]
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) for x, y in zip(graph, eager))
