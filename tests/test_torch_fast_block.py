"""K4 (csrc/fast_block.cu, ops/fast_block.py): a block step of the fast depth
decoder in bf16 as one hand-written kernel of four launches.

On the CPU: K4's plain version returns the module's block output to the bit
at the flagship fast widths (12 x 480, 10 heads over 2, FFN 2,880), bf16 and
float32, B 1 and 16; `forward_generate_audio_fixed` keeps the module path
there (the same logits as the decoder's modules, no K4 call) and a
generation's `stats["fast_block_fused"]` reads 0, and a fused decoder call
returns the unfused one's bits; off the CPU (`meta`, the library stood in
for) a bf16 forward asks K4 for each block with the decoder's shapes, and
float32, a gradient, a block cut for tensor parallelism or sizes K4 does
not take keep the modules; `_check` refuses what K4 does not take.

On the card: tests/test_torch_card_lm.py (K4 against its plain version at
B 1, 16 and 64, inside and outside a captured graph; the launch count; the
refusals on CUDA tensors; `generate_batched` at B = 16 through K4, and on
the modules for a fast decoder K4 does not take; greedy tokens against the
module path). This file imports nothing of JAX: that one imports its
helpers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import dmel_codec_tpu_torch.ops.fast_block as k4_ops
from dmel_codec_tpu_torch.lm.generate import InferenceConfig, SlowFastGenerator
from dmel_codec_tpu_torch.models.lm import ChatMusicLM, SlowFastLMConfig
from dmel_codec_tpu_torch.models.transformer import FAST_LM_CONFIG, Block, TransformerConfig, rope_cos_sin
from dmel_codec_tpu_torch.ops import library
from dmel_codec_tpu_torch.ops.fast_block import K4_LAUNCHES, BlockWeights, fast_block, fast_block_reference

C = 10  # codebooks: a depth sequence is S = C + 1 = 11 positions
S = C + 1
FAST = FAST_LM_CONFIG
# a small slow decoder in front of the flagship fast one
TINY_SLOW = TransformerConfig(vocab_size=151936, hidden_size=64, intermediate_size=128, num_layers=1, num_heads=4,
                              num_kv_heads=2)
LM = SlowFastLMConfig(slow=TINY_SLOW, fast=FAST)


def _block(cfg: TransformerConfig = FAST, seed: int = 0, dtype=torch.float32, device="cpu") -> Block:
    """A block with seeded weights as the benchmark draws them: dense
    N(0, 1 / fan_in), biases N(0, 0.02^2), norms 1 + N(0, 0.02^2)."""
    gen = torch.Generator().manual_seed(seed)
    block = Block(cfg)
    with torch.no_grad():
        for name, p in block.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if p.dim() == 2:
                p.copy_(noise / p.shape[1] ** 0.5)
            elif name.endswith("layernorm.weight"):
                p.copy_(1.0 + 0.02 * noise)
            else:
                p.copy_(0.02 * noise)
    return block.to(device=device, dtype=dtype).eval()


def _module_out(block: Block, x: torch.Tensor) -> torch.Tensor:
    """The block as `Decoder.forward` calls it without a cache."""
    b, s, _ = x.shape
    cfg = block.self_attn.config
    positions = torch.arange(s, device=x.device).expand(b, s)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril().expand(b, s, s)
    return block(x, cos, sin, mask, None, None, True)


def _cos_sin(s: int, device="cpu", cfg: TransformerConfig = FAST):
    return rope_cos_sin(torch.arange(s, device=device), cfg.head_dim, cfg.rope_theta)


@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_version_is_the_module_to_the_bit(dtype, b):
    """fast_block on a CPU tensor (the plain version) returns
    `Block.forward`'s bits at the flagship fast widths."""
    block = _block(dtype=dtype)
    x = torch.randn((b, S, FAST.hidden_size), generator=torch.Generator().manual_seed(b)).to(dtype)
    with torch.no_grad():
        want = _module_out(block, x)
        got = fast_block(x, BlockWeights.of(block), *_cos_sin(S), FAST.rms_norm_eps)
        plain = fast_block_reference(x, BlockWeights.of(block), *_cos_sin(S), FAST.rms_norm_eps)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, want) and torch.equal(plain, want)


def test_block_weights_are_the_modules_parameters():
    """BlockWeights.of names the module's own tensors: no copies."""
    block = _block()
    w = BlockWeights.of(block)
    params = dict(block.named_parameters())
    assert len(w) == len(params) == 12
    assert {id(t) for t in w} == {id(p) for p in params.values()}


def _lm(dtype=torch.float32, device="cpu", seed: int = 0) -> ChatMusicLM:
    """The small-slow, flagship-fast LM; off `meta`, its matrices redrawn
    N(0, 1 / fan_in) and its embeddings N(0, 1), as the benchmark draws
    them (the default init's N(0, 0.02) leaves the logits nearly flat)."""
    torch.manual_seed(seed)
    with torch.device(device):
        model = ChatMusicLM(LM)
    if device != "meta":
        with torch.no_grad():
            for name, p in model.named_parameters():
                if p.dim() == 2:
                    p.normal_(0.0, 1.0 if "embed" in name else p.shape[1] ** -0.5)
    return model.to(dtype).eval()


def _fast_inputs(b: int, device="cpu", dtype=torch.float32, seed: int = 1):
    gen = torch.Generator().manual_seed(seed)
    hidden = torch.randn((b, 1, TINY_SLOW.hidden_size), generator=gen).to(device=device, dtype=dtype)
    ids = torch.randint(0, LM.audio_vocab, (b, C), generator=gen).to(device)
    return hidden, ids


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fixed_depth_decode_keeps_the_modules_on_the_cpu(dtype):
    """forward_generate_audio_fixed on the CPU gives the fast decoder's
    modules' logits, as before K4, and counts its 12 block calls as the
    modules'."""
    model = _lm(dtype)
    hidden, ids = _fast_inputs(3, dtype=dtype)
    with torch.no_grad():
        x = torch.cat([model.fast_depth_pos0(hidden), model.fast_audio_embed(ids)], dim=1)
        want = model.audio_head(model.fast_decoder(x)[0])
        assert not model.fast_decoder.fusable(S)
        model.fast_block_calls.update(fused=0, module=0)
        got = model.forward_generate_audio_fixed(hidden, ids)
    assert torch.equal(got, want)
    assert model.fast_block_calls == {"fused": 0, "module": FAST.num_layers}


def test_generation_reports_no_fused_blocks_on_the_cpu():
    """generate_batched on the CPU runs every fast block on the modules:
    stats["fast_block_fused"] is 0 over the eager frames' block calls."""
    model = _lm(torch.bfloat16)
    gen = SlowFastGenerator(model, InferenceConfig(max_new_tokens=3, max_seq_len=32, top_k=1))
    text = np.full((2, 6), LM.text_pad_id, np.int64)
    text[:, -3:] = [[5, 6, 7], [8, 9, 10]]
    audio = np.full((2, 6, C), LM.slow_audio_pad_id, np.int64)
    audio_ids, _ = gen.generate_batched(text, audio, torch.Generator().manual_seed(0))
    assert len(audio_ids) == 2 and gen.stats["fast_block_fused"] == 0.0
    assert model.fast_block_calls["fused"] == 0 and model.fast_block_calls["module"] >= 3 * C * FAST.num_layers


class _Lib:
    """Records each K4 call's arguments."""

    def __init__(self):
        self.calls = []

    def dmel_fast_block(self, *args):
        self.calls.append(args)
        return 0


def _stand_in(monkeypatch) -> _Lib:
    lib = _Lib()
    checked = []
    real_check = k4_ops._check

    def check(x, w, cos, sin):  # every check but the device's (meta tensors stand in for CUDA ones)
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            real_check(x, w, cos, sin)
        checked.append(x.shape)

    monkeypatch.setattr(k4_ops, "_check", check)
    monkeypatch.setattr(library, "load", lambda: lib)
    monkeypatch.setattr(library, "stream", lambda x: 0)
    lib.checked = checked
    return lib


def test_fixed_depth_decode_dispatch(monkeypatch):
    """Off the CPU (`meta`, the library stood in for), a bf16 model without
    gradients runs each of the 12 fast blocks as one K4 call with the
    decoder's shapes (B, S, H, heads, KV heads, head size, FFN) and eps,
    4 launches each; float32, a gradient, or a block cut for tensor
    parallelism keep the modules and call nothing."""
    lib = _stand_in(monkeypatch)
    model = _lm(torch.bfloat16, device="meta")
    hidden, ids = _fast_inputs(16, device="meta", dtype=torch.bfloat16)
    before = fast_block.launches
    with torch.no_grad():
        assert model.fast_decoder.fusable(S)
        logits = model.forward_generate_audio_fixed(hidden, ids)
    assert logits.shape == (16, S, LM.audio_vocab) and logits.dtype == torch.bfloat16
    assert len(lib.calls) == FAST.num_layers and lib.checked == [(16, S, FAST.hidden_size)] * FAST.num_layers
    for args in lib.calls:
        assert len(args) == 28
        assert args[19:26] == (16, S, 480, 10, 2, 48, 2880) and args[26] == pytest.approx(FAST.rms_norm_eps)
    assert fast_block.launches == before + K4_LAUNCHES * FAST.num_layers
    assert model.fast_block_calls["fused"] >= FAST.num_layers

    lib.calls.clear()
    with torch.enable_grad():
        assert not model.fast_decoder.fusable(S)
        model.forward_generate_audio_fixed(hidden, ids)
    f32 = _lm(torch.float32, device="meta")
    with torch.no_grad():
        assert not f32.fast_decoder.fusable(S)
        f32.forward_generate_audio_fixed(hidden.float(), ids)
        model.fast_decoder.layers[3].mlp.model_group = object()  # a rank's columns: the modules must run
        assert not model.fast_decoder.fusable(S)
    assert lib.calls == []


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_decoder_call_is_the_modules_on_the_cpu(dtype):
    """`Decoder.forward(fused=True)` on the CPU (each block through
    fast_block's plain version, the decoder's own RoPE table and final norm)
    returns the unfused call's bits; a fused call with a cache, positions or
    a mask is refused."""
    dec = _lm(dtype).fast_decoder
    x = torch.randn((3, S, FAST.hidden_size), generator=torch.Generator().manual_seed(2)).to(dtype)
    with torch.no_grad():
        want, _ = dec(x)
        got, _ = dec(x, fused=True)
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match="cache-less and causal"):
            dec(x, positions=torch.arange(S).expand(3, S), fused=True)


# fast decoders whose sizes K4 does not take: generation keeps their modules
UNFUSABLE = {
    "head size 40": dict(fast=dataclasses.replace(FAST, num_heads=12, num_kv_heads=2)),
    "24 heads": dict(fast=dataclasses.replace(FAST, hidden_size=768, num_heads=24, num_kv_heads=4)),
    "FFN 2,872": dict(fast=dataclasses.replace(FAST, intermediate_size=2872)),
    "17 depth positions": dict(audio_codebook_count=16),
}


@pytest.mark.parametrize("case", sorted(UNFUSABLE))
def test_fast_shapes_k4_does_not_take_keep_the_modules(monkeypatch, case):
    """Off the CPU (`meta`, the library stood in for), a bf16 model whose
    fast decoder K4 does not take (head size, head count, FFN width, depth
    positions) is not `fusable`: forward_generate_audio_fixed runs the
    modules, calls nothing and counts module calls; the flagship's sizes
    are fusable."""
    lib = _stand_in(monkeypatch)
    cfg = dataclasses.replace(LM, **UNFUSABLE[case])
    torch.manual_seed(0)
    with torch.device("meta"):
        model = ChatMusicLM(cfg).to(torch.bfloat16).eval()
    c = cfg.audio_codebook_count
    hidden = torch.empty((4, 1, TINY_SLOW.hidden_size), device="meta", dtype=torch.bfloat16)
    ids = torch.zeros((4, c), device="meta", dtype=torch.long)
    with torch.no_grad():
        assert _lm(torch.bfloat16, device="meta").fast_decoder.fusable(S)
        assert not model.fast_decoder.fusable(c + 1)
        logits = model.forward_generate_audio_fixed(hidden, ids)
    assert logits.shape == (4, c + 1, cfg.audio_vocab)
    assert lib.calls == [] and model.fast_block_calls == {"fused": 0, "module": cfg.fast.num_layers}


def _meta_case(**over):
    """x, weights, cos, sin of the flagship block on `meta`, with `over`
    replacing any of them."""
    block = _block(device="meta", dtype=torch.bfloat16)
    case = {"x": torch.empty((4, S, 480), device="meta", dtype=torch.bfloat16), "w": BlockWeights.of(block)}
    case["cos"], case["sin"] = _cos_sin(S, device="meta")
    case.update(over)
    return case


REFUSED = {
    "float32 x": lambda c: {"x": c["x"].float()},
    "S = 17": lambda c: {"x": torch.empty((4, 17, 480), device=c["x"].device, dtype=torch.bfloat16)},
    "head size 40": lambda c: {"cos": c["cos"][:, :40].contiguous(), "sin": c["sin"][:, :40].contiguous()},
    "cos of another length": lambda c: {"cos": torch.empty((12, 48), device=c["x"].device)},
    "float32 weight": lambda c: {"w": c["w"]._replace(gate=c["w"].gate.float())},
    "transposed weight": lambda c: {"w": c["w"]._replace(o=c["w"].o.t())},
    "missing bias": lambda c: {"w": c["w"]._replace(q_bias=None)},
    "odd FFN": lambda c: {"w": c["w"]._replace(gate=c["w"].gate[:2872], up=c["w"].up[:2872],
                                               down=c["w"].down[:, :2872])},
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_check_refuses_what_k4_does_not_take(case):
    """`_check` raises on each input K4 does not take, before the device;
    the flagship's shapes pass every check but the device's."""
    base = _meta_case()
    bad = _meta_case(**REFUSED[case](base))
    with pytest.raises(ValueError) as err:
        k4_ops._check(bad["x"], bad["w"], bad["cos"], bad["sin"])
    assert "CUDA" not in str(err.value)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        k4_ops._check(base["x"], base["w"], base["cos"], base["sin"])
