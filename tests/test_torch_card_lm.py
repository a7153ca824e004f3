"""The LM's serving side on the card: the forward with flash on and off,
`cli.infer_lm`, K4 against its plain version, the captured frame step
against the eager one, the generation forms (`card`: see tests/card.py)."""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from dmel_codec_tpu_torch.cli import infer_lm
from dmel_codec_tpu_torch.lm.generate import InferenceConfig, SlowFastGenerator
from dmel_codec_tpu_torch.lm.inputs import TokenGridBuilder, pad_grids_to_batch
from dmel_codec_tpu_torch.lm.tokenizer import ByteTokenizer
from dmel_codec_tpu_torch.models.lm import ChatMusicLM, SlowFastLMConfig
from dmel_codec_tpu_torch.models.transformer import rope_cos_sin
from dmel_codec_tpu_torch.ops.anti_alias import anti_alias_activation
from dmel_codec_tpu_torch.ops.fast_block import K4_LAUNCHES, BlockWeights, fast_block, fast_block_reference
from dmel_codec_tpu_torch.ops.flash_attention import flash_attention
from dmel_codec_tpu_torch.ops.stage_fused import amp_stage
from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
from tests.card import (
    HOP, SR, TOL_LM_MAX, TOL_LM_MEAN, codec_and_vocoder, free_card, on_card, rel_err, reset_launches, set_flash,
)
from tests.test_torch_fast_block import C, FAST, LM, REFUSED, S, TINY_SLOW, UNFUSABLE, _block, _cos_sin, _lm

pytestmark = pytest.mark.card

LM_BATCH, LM_SEQ, LM_FRAMES, SERVE_BATCH = 2, 2048, 128, 16
GEN_CHECK_FRAMES = 32  # where the captured graph is held to the eager step (the eager loop is the slow side)
PROMPT, SEED = "who are you?", 3
# bf16 against the module path on the card: K4 keeps float32 where the
# module rounds to bf16 inside a launch (q / k / v before RoPE, the
# projections before the residuals, the norms' scale before the products,
# the MLP's gate and up), a few bf16 ulps of the block's output
CARD_TOL = 3e-2  # of max(1, max |plain|)


@pytest.fixture(scope="module")
def lm():
    """The flagship LM (slow 24 x 896, fast 12 x 480, vocabulary 151936), seeded random bf16 weights."""
    dev = on_card()
    torch.manual_seed(0)
    with torch.device(dev):
        model = ChatMusicLM(SlowFastLMConfig())
    yield model.to(torch.bfloat16).eval()
    del model
    free_card()


@pytest.fixture(scope="module")
def lm32(lm):
    yield copy.deepcopy(lm).float()
    free_card()


@pytest.fixture(scope="module")
def grid(lm):
    return TokenGridBuilder(config=lm.config).build_infer_grid(text_ids=ByteTokenizer().encode(PROMPT))


@torch.no_grad()
def test_lm_forward_flash_on_vs_off(lm):
    """The teacher-forced forward at full width on 2 x 2048 grid positions:
    one FA launch a slow layer (the fast decoder's S = 11 stays on the
    einsum path), finite losses, logits with the kernel on against off."""
    dev = on_card()
    cfg = lm.config
    rng = np.random.default_rng(0)
    gridder = TokenGridBuilder(config=cfg)
    # a grid is text + audio + 14 positions long: one fills S, one is padded to it
    grids = [gridder.build_train_grid(rng.integers(0, 151643, size=lt), rng.integers(0, 175, size=(la, 10)))
             for lt, la in ((34, LM_SEQ - 48), (20, LM_SEQ - 148))]
    batch = {k: torch.as_tensor(v, device=dev) for k, v in pad_grids_to_batch(grids, cfg, pad_to=LM_SEQ).items()}
    assert batch["text_tokens"].shape == (LM_BATCH, LM_SEQ) and bool(batch["valid"][0].all())

    def forward():
        emb = lm.embed_inputs(batch["text_tokens"], batch["audio_tokens"])
        emb = emb * batch["valid"][..., None].to(emb.dtype)
        return lm(emb, batch["text_labels"], batch["audio_labels"])

    try:
        set_flash(lm, True)
        flash_attention.launches = 0
        out_on = forward()
        assert flash_attention.launches == cfg.slow.num_layers
        set_flash(lm, False)
        out_off = forward()
        assert flash_attention.launches == cfg.slow.num_layers  # the einsum path launches none
    finally:
        set_flash(lm, SlowFastLMConfig().slow.flash_attention)
    for out in (out_on, out_off):
        assert out["text_logits"].shape == (LM_BATCH, LM_SEQ, cfg.slow.vocab_size)
        assert out["audio_logits"].shape == (LM_BATCH * (LM_SEQ - 1), 11, cfg.audio_vocab)
        losses = [out[k].item() for k in ("loss", "text_loss", "audio_loss")]
        assert all(math.isfinite(x) and x > 0 for x in losses), losses
    for k in ("text_logits", "audio_logits"):
        diff = (out_on[k].float() - out_off[k].float()).abs()
        scale = max(1.0, out_off[k].float().abs().max().item())
        assert diff.max().item() <= TOL_LM_MAX * scale and diff.mean().item() <= TOL_LM_MEAN * scale, k
    assert abs(out_on["loss"].item() - out_off["loss"].item()) <= 1e-2 * out_off["loss"].item()


def test_infer_lm_entry_point(lm, grid, tmp_path):
    """`cli.infer_lm.main` on checkpoints written here: text prompt -> 128
    frames (replays of the captured frame step) -> codec decode -> bf16
    vocoder -> WAV; K1 37 and K2 72 launches, FA none (the prompt is
    shorter than flash_min_seq); the WAV holds the frames the same seed
    generates, less the last."""
    dev = on_card()
    codec, voc32 = codec_and_vocoder(dev)
    CheckpointManager(str(tmp_path / "lm")).save(0, {"step": 0, "params": lm.state_dict()})
    CheckpointManager(str(tmp_path / "codec")).save(0, {"gen_params": codec.state_dict()})
    torch.save({"generator": voc32.to(torch.bfloat16).state_dict()}, tmp_path / "vocoder.pt")
    del codec, voc32
    (tmp_path / "infer.yaml").write_text(
        f"lm_ckpt_dir: {tmp_path / 'lm'}\ncodec_ckpt_dir: {tmp_path / 'codec'}\n"
        f"vocoder_ckpt: {tmp_path / 'vocoder.pt'}\ntext_tokenizer_path: null\nsilence_length: 3\ninference:\n"
        "  temperature: 0.7\n  top_k: 50\n  top_p: 0.8\n  windows_penalty: 1.2\n  windows_length: 16\n"
        f"  max_new_tokens: {LM_FRAMES}\n  max_seq_len: 4096\n  cache_dtype: bfloat16\n")
    reset_launches(anti_alias_activation, amp_stage, flash_attention)
    infer_lm.main(["--config", str(tmp_path / "infer.yaml"), "--prompt", PROMPT, "--out", str(tmp_path / "out.wav"),
                   "--seed", str(SEED), "--device", "cuda:0"])
    torch.cuda.synchronize()
    launches = {"K1": anti_alias_activation.launches, "K2": amp_stage.launches, "FA": flash_attention.launches}
    wav_sr, wav = wavfile.read(tmp_path / "out.wav")
    gen = SlowFastGenerator(lm, InferenceConfig(max_new_tokens=LM_FRAMES, cache_dtype="bfloat16"))
    audio_ids, text_ids = gen.generate(*grid, torch.Generator(device=dev).manual_seed(SEED))
    n_frames = audio_ids.shape[0]
    assert wav_sr == SR and wav.dtype == np.float32 and np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    # infer_lm drops the last generated frame; a frame is 4 mel frames of 256 samples
    assert wav.shape == ((n_frames - 1) * 4 * HOP,), (wav.shape, n_frames)
    assert (audio_ids >= 0).all() and (audio_ids < lm.config.audio_vocab).all() and text_ids.shape == (n_frames,)
    assert launches == {"K1": 37, "K2": 72, "FA": 0}, launches


# ---- K4 -------------------------------------------------------------------------------


@torch.no_grad()
@pytest.mark.parametrize("b", [1, SERVE_BATCH, 64])
def test_k4_matches_plain_on_each_lm_block(lm, b):
    """The fast depth decoder's input as the main path makes it (the
    projected slow hidden state and 10 codebooks' embeddings, [B, 11, 480]
    bf16) through each of the LM's 12 fast blocks on K4 and on its plain
    version, each block fed the plain version's output: within CARD_TOL,
    4 launches a call; at B = 16 a captured graph of the 12 calls replays
    the eager calls' bits."""
    dev = on_card()
    cfg, dec = lm.config, lm.fast_decoder
    fcfg, c = cfg.fast, cfg.audio_codebook_count
    assert dec.fusable(c + 1), "the bf16 LM must run its fast blocks on K4"
    weights = [BlockWeights.of(layer) for layer in dec.layers]
    cos, sin = rope_cos_sin(torch.arange(c + 1, device=dev), fcfg.head_dim, fcfg.rope_theta)
    eps = fcfg.rms_norm_eps
    gen = torch.Generator(device=dev).manual_seed(9)
    slow_hidden = torch.randn((b, 1, cfg.slow.hidden_size), device=dev, generator=gen).to(torch.bfloat16)
    ids = torch.randint(0, cfg.audio_vocab, (b, c), device=dev, generator=gen)
    x0 = x = torch.cat([lm.fast_depth_pos0(slow_hidden), lm.fast_audio_embed(ids)], dim=1)
    before = fast_block.launches
    for w in weights:
        want = fast_block_reference(x, w, cos, sin, eps)
        assert rel_err(fast_block(x, w, cos, sin, eps), want) <= CARD_TOL
        x = want
    assert fast_block.launches - before == 4 * len(weights)
    if b == SERVE_BATCH:
        def chain(y):
            for w in weights:
                y = fast_block(y, w, cos, sin, eps)
            return y

        eager = chain(x0)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            chain(x0)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = chain(x0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager)


@pytest.mark.parametrize("b", [1, 16, 64])
def test_k4_matches_plain_on_the_card(b):
    """K4 against its plain version (the module's maths on the card) at the
    flagship fast widths, bf16, B 1, 16 and 64: within CARD_TOL of
    max(1, max |plain|), the same bits from a second call and from a replay
    of a captured graph, and 4 launches a call."""
    dev = on_card()
    block = _block(seed=b, dtype=torch.bfloat16, device=dev)
    w = BlockWeights.of(block)
    x = torch.randn((b, S, FAST.hidden_size), device=dev, generator=torch.Generator(dev).manual_seed(b))
    x = x.bfloat16()
    cos, sin = _cos_sin(S, dev)
    eps = FAST.rms_norm_eps
    with torch.no_grad():
        want = fast_block_reference(x, w, cos, sin, eps)
        before = fast_block.launches
        got = fast_block(x, w, cos, sin, eps)
        torch.cuda.synchronize()
        assert fast_block.launches == before + 4
        assert rel_err(got, want) <= CARD_TOL, rel_err(got, want)
        assert torch.equal(fast_block(x, w, cos, sin, eps), got)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fast_block(x, w, cos, sin, eps)  # warm-up on a side stream, as generation captures
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fast_block(fast_block(x, w, cos, sin, eps), w, cos, sin, eps)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fast_block(got, w, cos, sin, eps))
        with torch.no_grad():  # the graph reads the weights where they lie
            w.down.mul_(0.5)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fast_block(fast_block(x, w, cos, sin, eps), w, cos, sin, eps))


@pytest.mark.parametrize("case", sorted(REFUSED) + ["misaligned weight"])
def test_k4_refuses_on_the_card(case):
    """fast_block raises on a CUDA tensor K4 does not take, and launches
    nothing."""
    dev = on_card()
    block = _block(dtype=torch.bfloat16, device=dev)
    base = {"x": torch.randn((4, S, 480), device=dev).bfloat16(), "w": BlockWeights.of(block)}
    base["cos"], base["sin"] = _cos_sin(S, dev)
    if case == "misaligned weight":
        flat = torch.empty(480 * 480 + 1, device=dev, dtype=torch.bfloat16)
        bad = dict(base, w=base["w"]._replace(o=flat[1:].view(480, 480)))
    else:
        bad = dict(base, **REFUSED[case](base))
    before = fast_block.launches
    with pytest.raises(ValueError):
        fast_block(bad["x"], bad["w"], bad["cos"], bad["sin"], FAST.rms_norm_eps)
    assert fast_block.launches == before


def _serve_prompts(b: int):
    rng = np.random.default_rng(b)
    text = np.full((b, 12), LM.text_pad_id, np.int64)
    for i in range(b):
        n = 3 + i % 8
        text[i, -n:] = rng.integers(0, 1000, n)
    return text, np.full((b, 12, C), LM.slow_audio_pad_id, np.int64)


def test_a_fast_decoder_k4_does_not_take_keeps_the_modules_on_the_card():
    """generate_batched on a bf16 model on the card whose fast heads are of
    size 40 runs the modules (stats["fast_block_fused"] 0, no K4 launch)
    instead of raising."""
    dev = on_card()
    torch.manual_seed(0)
    with torch.device(dev):
        model = ChatMusicLM(dataclasses.replace(LM, **UNFUSABLE["head size 40"]))
    model = model.to(torch.bfloat16).eval()
    gen = SlowFastGenerator(model, InferenceConfig(max_new_tokens=6, max_seq_len=64, top_k=1, cache_dtype="bfloat16"))
    before = fast_block.launches
    audio_ids, _ = gen.generate_batched(*_serve_prompts(4), torch.Generator(device=dev).manual_seed(0))
    assert len(audio_ids) == 4 and gen.stats["graphed"] and gen.stats["fast_block_fused"] == 0.0
    assert fast_block.launches == before


def test_generate_batched_runs_k4_on_the_card():
    """generate_batched at B = 16 on a bf16 model runs every fast block
    through K4 in its eager and captured frames (stats["fast_block_fused"]
    1.0, 4 launches a block call), and a greedy batch's tokens match the
    module path's (the same model with K4 switched off) wherever the module
    path's top two logits are further apart than bf16's rounding."""
    dev = on_card()
    model = _lm(torch.bfloat16, device=dev)
    icfg = InferenceConfig(max_new_tokens=6, max_seq_len=64, top_k=1, cache_dtype="bfloat16")
    text, audio = _serve_prompts(16)
    gen = SlowFastGenerator(model, icfg)
    before = fast_block.launches
    seeded = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731  (bf16 logits tie at the top)
    audio_k4, text_k4 = gen.generate_batched(text, audio, seeded())
    assert gen.stats["graphed"] and gen.stats["fast_block_fused"] == 1.0
    assert fast_block.launches - before == 4 * model.fast_block_calls["fused"] > 0
    again = gen.generate_batched(text, audio, seeded())  # the captured graph, no new capture
    assert gen.stats["fast_block_fused"] == 1.0
    assert all(np.array_equal(a, b) for a, b in zip(again[0], audio_k4))

    # the module path on the same weights: the first frame's fast decode, codebook by codebook
    with torch.no_grad():
        hidden = torch.randn((16, 1, TINY_SLOW.hidden_size), device=dev, generator=torch.Generator(dev).manual_seed(3))
        hidden = hidden.bfloat16()
        tokens = torch.zeros((16, C), dtype=torch.long, device=dev)
        for i in range(C):
            fused = model.forward_generate_audio_fixed(hidden, tokens)[:, i].float()
            model.fast_decoder.fusable = lambda s: False  # the module path
            plain = model.forward_generate_audio_fixed(hidden, tokens)[:, i].float()
            del model.fast_decoder.fusable
            top2 = plain.topk(2, dim=-1).values
            decided = (top2[:, 0] - top2[:, 1]) > 2 ** -7 * top2[:, 0].abs().clamp(min=1.0) * 4
            assert torch.equal(fused.argmax(-1)[decided], plain.argmax(-1)[decided])
            assert decided.float().mean().item() > 0.5
            tokens[:, i] = plain.argmax(-1)
    assert len(audio_k4) == 16 and all(len(a) == len(t) for a, t in zip(audio_k4, text_k4))


# ---- generation -----------------------------------------------------------------------


@torch.no_grad()
@pytest.mark.parametrize("b,fast_kv_cache", [(SERVE_BATCH, False), (1, True)])
def test_frame_step_reads_nothing_on_the_host(lm, grid, b, fast_kv_cache):
    """One eager frame step (the fixed and the KV-cached fast decode) under
    set_sync_debug_mode("error"): no synchronizing call."""
    dev = on_card()
    gen = SlowFastGenerator(lm, InferenceConfig(cache_dtype="bfloat16", fast_kv_cache=fast_kv_cache))
    loop, g = gen._new_loop(b), torch.Generator(device=dev).manual_seed(0)
    text_b, audio_b = (torch.as_tensor(np.stack([x] * b), device=dev) for x in grid)
    gen._prefill(loop, text_b, audio_b, g, gen._fast_decode_growing)
    gen._step(loop, g, gen._fast_decode)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gen._step(loop, g, gen._fast_decode)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@torch.no_grad()
@pytest.mark.parametrize("b", [1, SERVE_BATCH])
@pytest.mark.parametrize("label", ["greedy float32", "seeded bf16"])
def test_captured_graph_gives_the_eager_tokens(lm, lm32, grid, label, b):
    """The captured frame step against the eager one over 32 frames: the
    same tokens, greedy in float32 and seeded in bf16, B = 1 and 16."""
    dev = on_card()
    model, kw, seed = (lm32, dict(top_k=1), None) if label == "greedy float32" else \
        (lm, dict(cache_dtype="bfloat16"), 5)
    gen = SlowFastGenerator(model, InferenceConfig(max_new_tokens=GEN_CHECK_FRAMES, **kw))

    def rng():
        return None if seed is None else torch.Generator(device=dev).manual_seed(seed)

    if b == 1:
        graph = [gen.generate(*grid, rng())]
        eager = [gen._generate_one(*grid, rng(), gen._fast_decode_growing, gen._fast_decode, graphed=False)]
    else:
        many = _serve_prompts(b)
        graph = list(zip(*gen.generate_batched(*many, rng())))
        texts, audios, lengths = gen._generate(*many, rng(), gen._fast_decode_fixed, gen._fast_decode_fixed,
                                               graphed=False)
        eager = [(audios[i, : lengths[i]], texts[i, : lengths[i]]) for i in range(b)]
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) for x, y in zip(graph, eager))


@torch.no_grad()
@pytest.mark.parametrize("b", [1, SERVE_BATCH, 64])
def test_generation_runs_k4(lm, grid, b):
    """128 frames at B = 1, 16 and 64 (bf16 weights and cache, the default
    sampler), graphed: K4 launches 4 for each fast block call whose host
    code ran (the prefill, the warm-up and the captured frames); generate's
    prefill (B = 1) takes the growing fast decode, on the modules, so the
    fused share is below 1 there and 1 at B = 16 and 64."""
    dev = on_card()
    gen = SlowFastGenerator(lm, InferenceConfig(max_new_tokens=LM_FRAMES, cache_dtype="bfloat16"))
    text_b, audio_b = np.stack([grid[0]] * b), np.stack([grid[1]] * b)
    g = torch.Generator(device=dev).manual_seed(3)

    def run():
        return gen.generate(*grid, g) if b == 1 else gen.generate_batched(text_b, audio_b, g)

    fast_block.launches = 0
    run()
    share = gen.stats["fast_block_fused"]
    assert fast_block.launches == K4_LAUNCHES * lm.fast_block_calls["fused"] > 0, lm.fast_block_calls
    assert share == 1.0 if b > 1 else 0 < share < 1, share
    out = run()
    n = out[0].shape[0] if b == 1 else max(len(a) for a in out[0])
    assert 2 <= n <= LM_FRAMES and gen.stats["graphed"], (n, gen.stats)


@torch.no_grad()
def test_generation_forms_agree_greedy(lm32, grid):
    """generate, generate_stepwise and generate_batched give the same
    greedy tokens (float32, so that batch shape cannot move an argmax among
    near-uniform logits)."""
    on_card()
    greedy = SlowFastGenerator(lm32, InferenceConfig(max_new_tokens=16, top_k=1))
    a1, t1 = greedy.generate(*grid, None)
    a2, t2 = greedy.generate_stepwise(*grid, None)
    a3, t3 = greedy.generate_batched(np.stack([grid[0]] * 2), np.stack([grid[1]] * 2), None)
    assert len(t1) == 16
    assert all(np.array_equal(a1, a) and np.array_equal(t1, t) for a, t in ((a2, t2), (a3[0], t3[0]), (a3[1], t3[1])))
