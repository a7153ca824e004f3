"""The port's generation over fixed-shape buffers against the JAX package.

On CUDA, `generate` and `generate_batched` replay a captured graph of
`FRAMES_PER_GRAPH` frame steps (`SlowFastGenerator._step`) after an eager
prefill; on the CPU the same step runs eagerly, frame by frame. These tests
hold that step to the JAX package's `lax.while_loop` on the CPU: the static
KV cache with its index on the device, greedy tokens when rows stop at
different frames, whole replays that run past max_new_tokens or past the
last row's <EOM> (emulated here as groups of steps with no host read
between them), seeded draws, and the fast KV cache. Greedy sampling
(`top_k = 1`) is deterministic in both frameworks, so tokens and lengths
must be equal; the decoder's values are held within the tolerances of
tests/test_torch_lm.py (float32 2e-5 abs + 1e-4 rel; a bf16 cache 2e-4 abs
+ 1e-3 rel, where a key's rounding may flip).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_codec_tpu.lm.generate import InferenceConfig as JaxInferenceConfig
from dmel_codec_tpu.lm.generate import SlowFastGenerator as JaxSlowFastGenerator
from dmel_codec_tpu.models.lm import ChatMusicLM as JaxChatMusicLM
from dmel_codec_tpu_torch.lm.generate import FRAMES_PER_GRAPH, InferenceConfig, SlowFastGenerator
from dmel_codec_tpu_torch.lm.inputs import TokenGridBuilder
from dmel_codec_tpu_torch.models.lm import ChatMusicLM
from tests.test_torch_lm import PORT_TINY, TOL, _apply, build_lm
from tests.test_torch_lm_generate import _boosted_params
from tests.test_torch_support import strict_f32, to_np  # noqa: F401  (strict_f32 is a fixture)

pytestmark = pytest.mark.usefixtures("strict_f32")
EOM = PORT_TINY.end_of_music_id
BF16_TOL = dict(atol=2e-4, rtol=1e-3)
# 9 frames after prompts of 10 positions fill a cache of 19 exactly
N_FRAMES, PROMPT, MAX_SEQ = 9, 10, 19
GREEDY = dict(max_new_tokens=N_FRAMES, max_seq_len=MAX_SEQ, top_k=1)
# the text head's <EOM> column scaled by 8: the four prompts stop after
# 5, 4 and 7 frames and one runs to the end; by 10: all stop, by frame 7
EOM_SCALES = (8.0, 10.0)


def _eom_params(scale: float):
    params = _boosted_params()
    kernel = np.array(params["text_head"]["kernel"])
    kernel[:, EOM] *= scale
    return dict(params, text_head=dict(params["text_head"], kernel=kernel))


def _prompts():
    """Four text prompts, left-padded to PROMPT positions with modality-pad rows."""
    gridder = TokenGridBuilder(config=PORT_TINY)
    grids = [gridder.build_infer_grid(text_ids=np.asarray(t)) for t in ([5, 6, 7], [9], [1, 2], [40, 41, 42])]
    text = np.full((len(grids), PROMPT), PORT_TINY.text_pad_id, np.int64)
    audio = np.full((len(grids), PROMPT, 10), PORT_TINY.slow_audio_pad_id, np.int64)
    for i, (t, a) in enumerate(grids):
        text[i, PROMPT - len(t) :] = t
        audio[i, PROMPT - len(t) :] = a
    return text, audio


@pytest.fixture(scope="module")
def staggered():
    """{scale: (jax model, params, port model, JAX batched greedy (audio, text))}."""
    text, audio = _prompts()
    out = {}
    for scale in EOM_SCALES:
        jm, params, pm = build_lm(params=_eom_params(scale))
        jgen = JaxSlowFastGenerator(jm, params, JaxInferenceConfig(**GREEDY))
        out[scale] = (jm, params, pm, jgen.generate_batched(text, audio, jax.random.PRNGKey(0)))
    return out


def _replayed(gen: SlowFastGenerator, text, audio, generator, per_replay: int, extra: int, decodes):
    """The CUDA path's frames on the CPU: the prefill, then whole replays of
    `per_replay` steps with no host read between them, as many as cover
    max_new_tokens and `extra` more -> per-row (audio, text) as the public
    forms return them."""
    prefill_decode, step_decode = decodes
    n = gen.icfg.max_new_tokens
    loop = gen._new_loop(text.shape[0])
    with torch.no_grad():
        gen._prefill(loop, torch.as_tensor(text), torch.as_tensor(audio), generator, prefill_decode)
        for _ in range((-(-(n - 1) // per_replay) + extra) * per_replay):
            gen._step(loop, generator, step_decode)
    out_text, out_audio, lengths = gen._fetch(loop)
    assert int(loop.i) == 1 + (-(-(n - 1) // per_replay) + extra) * per_replay
    return [out_audio[i, : lengths[i]] for i in range(len(lengths))], [out_text[i, : lengths[i]] for i in range(len(lengths))]


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_static_cache_decoder_matches_jax(cache_dtype):
    """`forward_generate_text` on `init_slow_cache` over a prefill of 6 and
    5 single steps, then the fast depth cache over its 10 positions, against
    the JAX cached calls: logits and hidden states within the tolerance, the
    index a 0-d int64 tensor on the cache's device that a call returns
    advanced and leaves as it was in the cache it was given."""
    jm, params, pm = build_lm(seed=5)
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((2, 11, 32)).astype(np.float32)
    dt = getattr(torch, cache_dtype)
    tol = TOL if cache_dtype == "float32" else BF16_TOL
    jcache, pcache = jm.init_slow_cache(2, 24, dtype=jnp.dtype(cache_dtype)), pm.init_slow_cache(2, 24, dtype=dt)
    assert pcache["index"].shape == () and pcache["index"].dtype == torch.int64
    for lo, hi in [(0, 6)] + [(t, t + 1) for t in range(6, 11)]:
        want_l, want_h, jcache = _apply(jm, params, jnp.asarray(emb[:, lo:hi]), jcache,
                                        method=JaxChatMusicLM.forward_generate_text)
        given = pcache["index"]
        with torch.no_grad():
            got_l, got_h, pcache = pm.forward_generate_text(torch.from_numpy(emb[:, lo:hi]), pcache)
        assert int(given) == lo and int(pcache["index"]) == int(jcache["index"]) == hi
        np.testing.assert_allclose(to_np(got_h), np.asarray(want_h), **tol)
        np.testing.assert_allclose(to_np(got_l), np.asarray(want_l), **tol)

    x = rng.standard_normal((2, 1, 24)).astype(np.float32)
    jfc, pfc = jm.init_fast_cache(2, dtype=jnp.dtype(cache_dtype)), pm.init_fast_cache(2, dtype=dt)
    for _ in range(PORT_TINY.audio_codebook_count):
        want, jfc = _apply(jm, params, jnp.asarray(x), jfc, method=JaxChatMusicLM.forward_generate_audio_cached)
        with torch.no_grad():
            got, pfc = pm.forward_generate_audio_cached(torch.from_numpy(x), pfc)
        np.testing.assert_allclose(to_np(got), np.asarray(want), **tol)
        x = np.tanh(x + 0.5)
    assert int(pfc["index"]) == int(jfc["index"]) == PORT_TINY.audio_codebook_count


@pytest.mark.parametrize("fast_kv_cache", [False, True])
def test_frame_step_reads_nothing_on_the_host(fast_kv_cache):
    """The prefill and three frame steps run on meta tensors, which hold no
    values: any read on the host (`.item()`, `bool()`, `int()`, a slice by
    the index) raises there. The eager CPU loop reads one flag a frame, and
    raises on them."""
    model = ChatMusicLM(PORT_TINY).to("meta")
    gen = SlowFastGenerator(model, InferenceConfig(max_new_tokens=5, max_seq_len=32, fast_kv_cache=fast_kv_cache))
    loop = gen._new_loop(3)
    text = torch.zeros((3, 4), dtype=torch.long, device="meta")
    audio = torch.zeros((3, 4, 10), dtype=torch.long, device="meta")
    with torch.no_grad():
        gen._prefill(loop, text, audio, None, gen._fast_decode_growing)
        for _ in range(3):
            gen._step(loop, None, gen._fast_decode)
        assert loop.out_audio.device.type == "meta" and loop.cache["index"].shape == ()
        with pytest.raises(RuntimeError, match="meta"):
            gen._run_eager(loop, None, gen._fast_decode)


@pytest.mark.parametrize("scale", EOM_SCALES)
def test_staggered_stops_equal_jax(staggered, scale):
    """Rows that sample <EOM> at different frames: the JAX batched loop's
    lengths and tokens, row for row, through the eager CPU loop."""
    _, _, pm, (want_a, want_t) = staggered[scale]
    text, audio = _prompts()
    gen = SlowFastGenerator(pm, InferenceConfig(**GREEDY))
    got_a, got_t = gen.generate_batched(text, audio, None)
    lengths = [len(t) for t in want_t]
    assert [len(t) for t in got_t] == [len(a) for a in got_a] == lengths
    assert len(set(lengths)) >= 3 and min(lengths) < N_FRAMES
    assert (max(lengths) == N_FRAMES) == (scale == 8.0)  # one row runs to the end, or all stop
    for i in range(len(lengths)):
        np.testing.assert_array_equal(got_t[i], want_t[i])
        np.testing.assert_array_equal(got_a[i], want_a[i])
        assert (got_t[i][-1] == EOM) == (lengths[i] < N_FRAMES)
    assert gen.stats["graphed"] is False and gen.stats["frames_per_replay"] == 1


@pytest.mark.parametrize("scale", EOM_SCALES)
@pytest.mark.parametrize("per_replay", [1, 3, FRAMES_PER_GRAPH, 8])
def test_replays_past_the_end_change_nothing(staggered, scale, per_replay):
    """Whole replays of 1, 3, FRAMES_PER_GRAPH and 8 frames (8 frames after
    the prefill is no multiple of 3), one replay more than max_new_tokens
    needs, with the prompt and max_new_tokens filling the cache to its last
    position: the JAX lengths and tokens, so frames past max_new_tokens and
    after every row has stopped change no output and no length."""
    _, _, pm, (want_a, want_t) = staggered[scale]
    text, audio = _prompts()
    gen = SlowFastGenerator(pm, InferenceConfig(**GREEDY))
    got_a, got_t = _replayed(gen, text, audio, None, per_replay, 1, (gen._fast_decode_fixed, gen._fast_decode_fixed))
    for i in range(len(want_t)):
        np.testing.assert_array_equal(got_t[i], want_t[i])
        np.testing.assert_array_equal(got_a[i], want_a[i])


@pytest.mark.parametrize("fast_kv_cache", [False, True])
def test_single_prompt_replays_equal_jax(fast_kv_cache):
    """`generate`'s decodes (the growing-shape prefill, then the fixed or
    the KV-cached fast decode) at s + n = max_seq_len: replays of
    FRAMES_PER_GRAPH frames and the eager loop give the JAX generator's
    tokens, and the fast KV cache gives the fixed decode's."""
    jm, params, pm = build_lm(params=_boosted_params())
    text, audio = (p[:1] for p in _prompts())
    want_a, want_t = JaxSlowFastGenerator(jm, params, JaxInferenceConfig(**GREEDY)).generate(
        text[0], audio[0], jax.random.PRNGKey(3)
    )
    gen = SlowFastGenerator(pm, InferenceConfig(**GREEDY, fast_kv_cache=fast_kv_cache))
    got_a, got_t = gen.generate(text[0], audio[0], None)
    rep_a, rep_t = _replayed(gen, text, audio, None, FRAMES_PER_GRAPH, 1, (gen._fast_decode_growing, gen._fast_decode))
    assert len(want_t) == N_FRAMES
    for a, t in ((got_a, got_t), (rep_a[0], rep_t[0])):
        np.testing.assert_array_equal(t, want_t)
        np.testing.assert_array_equal(a, want_a)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_seeded_replays_draw_as_the_eager_loop(cache_dtype):
    """A seeded sampler (the default temperature / top-k / top-p and the
    repetition penalty): replays of FRAMES_PER_GRAPH frames draw from the
    generator what the eager loop draws, frame by frame, so the tokens are
    the same; another seed gives other tokens."""
    _, _, pm = build_lm(params=_boosted_params())
    text, audio = _prompts()
    gen = SlowFastGenerator(pm, InferenceConfig(max_new_tokens=N_FRAMES, max_seq_len=MAX_SEQ, cache_dtype=cache_dtype))
    want_a, want_t = gen.generate_batched(text, audio, torch.Generator().manual_seed(11))
    got_a, got_t = _replayed(gen, text, audio, torch.Generator().manual_seed(11), FRAMES_PER_GRAPH, 1,
                             (gen._fast_decode_fixed, gen._fast_decode_fixed))
    for i in range(len(want_t)):
        np.testing.assert_array_equal(got_t[i], want_t[i])
        np.testing.assert_array_equal(got_a[i], want_a[i])
    other_a, _ = gen.generate_batched(text, audio, torch.Generator().manual_seed(12))
    assert not all(np.array_equal(a, b) for a, b in zip(other_a, want_a))
