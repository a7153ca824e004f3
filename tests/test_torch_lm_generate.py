"""The port's generation loop and the `infer_lm` slice against the JAX package.

Greedy sampling (`top_k = 1`) is deterministic in both frameworks, so every
form of the port's generator must give the JAX generator's tokens, token
for token, on the same weights (tests/test_torch_lm.py `build_lm`). The
audio head's columns for the last five ids of every codebook are scaled up,
so that de-shifted ids 175-179, which lie beyond the codec's 175 FSQ codes,
do occur, as they do with untrained weights.
"""

from __future__ import annotations

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from dmel_codec_tpu.eval.codecs import DMelCodecAdapter as JaxDMelCodecAdapter
from dmel_codec_tpu.lm.generate import InferenceConfig as JaxInferenceConfig
from dmel_codec_tpu.lm.generate import SlowFastGenerator as JaxSlowFastGenerator
from dmel_codec_tpu.lm.inputs import TokenGridBuilder as JaxTokenGridBuilder
from dmel_codec_tpu.lm.tokenizer import ByteTokenizer as JaxByteTokenizer
from dmel_codec_tpu.models.codec import DMelCodec as JaxDMelCodec
from dmel_codec_tpu_torch.cli import infer_lm
from dmel_codec_tpu_torch.eval.codecs import DMelCodecAdapter
from dmel_codec_tpu_torch.lm.generate import InferenceConfig, SlowFastGenerator
from dmel_codec_tpu_torch.lm.inputs import TokenGridBuilder
from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
from tests.test_torch_lm import FAST_KW, JAX_TINY, PORT_TINY, SLOW_KW, build_lm, lm_params
from tests.test_torch_support import (  # noqa: F401  (strict_f32 is a fixture)
    CODEC_KW,
    JaxBigVGANConfig,
    JaxDMelCodecConfig,
    VOCODER_KW,
    build_codec,
    build_vocoder,
    strict_f32,
    to_np,
)

pytestmark = pytest.mark.usefixtures("strict_f32")
GREEDY = dict(max_new_tokens=5, max_seq_len=64, top_k=1)


def _boosted_params(seed: int = 3):
    params = lm_params(seed)
    kernel = np.array(params["audio_head"]["kernel"])
    beyond = (np.arange(1800) % 180) >= 175
    kernel[:, beyond] *= 3.0
    params["audio_head"]["kernel"] = kernel
    return params


@pytest.fixture(scope="module")
def lm():
    return build_lm(params=_boosted_params())


@pytest.fixture(scope="module")
def prompt():
    return JaxTokenGridBuilder(config=JAX_TINY).build_infer_grid(text_ids=np.array([5, 6, 7]))


@pytest.fixture(scope="module")
def jax_tokens(lm, prompt):
    """The JAX generator's greedy tokens (on-device while_loop form)."""
    jm, params, _ = lm
    gen = JaxSlowFastGenerator(jm, params, JaxInferenceConfig(**GREEDY))
    return gen.generate(*prompt, jax.random.PRNGKey(1))


@pytest.mark.parametrize("form", ["generate", "generate_stepwise", "bf16 cache", "fast_kv_cache"])
def test_greedy_tokens_equal_jax(lm, prompt, jax_tokens, form):
    """Each single-prompt form against the same form of the JAX generator
    (whose forms agree among themselves: tests/test_lm.py)."""
    jm, params, pm = lm
    kw = dict(GREEDY)
    if form == "bf16 cache":
        kw["cache_dtype"] = "bfloat16"
    if form == "fast_kv_cache":
        kw["fast_kv_cache"] = True
    method = "generate_stepwise" if form == "generate_stepwise" else "generate"
    if form == "generate":
        want_a, want_t = jax_tokens
    else:
        jgen = JaxSlowFastGenerator(jm, params, JaxInferenceConfig(**kw))
        want_a, want_t = getattr(jgen, method)(*prompt, jax.random.PRNGKey(2))
    got_a, got_t = getattr(SlowFastGenerator(pm, InferenceConfig(**kw)), method)(
        *prompt, torch.Generator().manual_seed(0)
    )
    assert got_a.shape == (5, 10) and got_a.dtype == np.int64
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_array_equal(got_a, jax_tokens[0])


def test_batched_greedy_tokens_equal_jax(lm, jax_tokens):
    """B = 3 prompts of different lengths, left-padded with modality-pad
    rows (which embed to exact zeros): the JAX batched tokens row for row;
    the row without padding also equals the single-prompt tokens."""
    jm, params, pm = lm
    gridder = TokenGridBuilder(config=PORT_TINY)
    grids = [gridder.build_infer_grid(text_ids=np.asarray(t)) for t in ([5, 6, 7], [9], [1, 2])]
    s = max(len(t) for t, _ in grids)
    text = np.full((3, s), PORT_TINY.text_pad_id, np.int64)
    audio = np.full((3, s, 10), PORT_TINY.slow_audio_pad_id, np.int64)
    for i, (t, a) in enumerate(grids):
        text[i, s - len(t) :] = t
        audio[i, s - len(t) :] = a
    jgen = JaxSlowFastGenerator(jm, params, JaxInferenceConfig(**GREEDY))
    want_a, want_t = jgen.generate_batched(text, audio, jax.random.PRNGKey(7))
    got_a, got_t = SlowFastGenerator(pm, InferenceConfig(**GREEDY)).generate_batched(
        text, audio, torch.Generator().manual_seed(7)
    )
    assert len(got_a) == len(got_t) == 3
    for i in range(3):
        np.testing.assert_array_equal(got_t[i], want_t[i])
        np.testing.assert_array_equal(got_a[i], want_a[i])
    np.testing.assert_array_equal(got_a[0], jax_tokens[0])
    assert not np.array_equal(got_a[0], got_a[1])


def test_stop_on_end_of_music(lm, prompt, monkeypatch):
    """<EOM> forced into the text stream: a single prompt stops with the
    <EOM> frame as its last; in a batch every row is cut at its own <EOM>
    and the loop ends once all rows have stopped."""
    _, _, pm = lm
    eom = PORT_TINY.end_of_music_id
    stops = {"one": [3], "batch": [2, 4, 3]}
    for kind, at in stops.items():
        gen = SlowFastGenerator(pm, InferenceConfig(**dict(GREEDY, max_new_tokens=8)))
        frames = {"n": 0}
        plain = gen._sample

        def forced(generator, logits, window_col=None, window_valid=None, plain=plain, frames=frames, at=at):
            tokens = plain(generator, logits, window_col, window_valid)
            if window_col is None:  # a text token
                frames["n"] += 1
                hit = torch.tensor([frames["n"] == a for a in at])
                tokens = torch.where(hit, eom, tokens.masked_fill(tokens == eom, 0))
            return tokens

        monkeypatch.setattr(gen, "_sample", forced)
        if kind == "one":
            audio, text = gen.generate(*prompt, torch.Generator().manual_seed(0))
            assert len(text) == len(audio) == 3 and text[-1] == eom and frames["n"] == 3
        else:
            b = len(at)
            audio, text = gen.generate_batched(
                np.stack([prompt[0]] * b), np.stack([prompt[1]] * b), torch.Generator().manual_seed(0)
            )
            assert [len(t) for t in text] == [len(a) for a in audio] == at
            assert all(t[-1] == eom for t in text) and frames["n"] == max(at)


def test_sampled_generation_shapes_and_deshift(lm, prompt):
    _, _, pm = lm
    gen = SlowFastGenerator(pm, InferenceConfig(max_new_tokens=4, max_seq_len=64))
    audio, text = gen.generate(*prompt, torch.Generator().manual_seed(1))
    assert audio.shape[1] == 10 and 1 <= audio.shape[0] <= 4 and text.shape == (audio.shape[0],)
    assert (audio >= 0).all() and (audio < 1800).all()
    np.testing.assert_array_equal(gen.deshift(audio) + np.arange(10) * 180, audio)
    again, _ = gen.generate(*prompt, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(again, audio)  # the draw follows the generator's seed


# ---- ids beyond the codec's codes, and the slice -----------------------------


def _jax_noise(shape):
    """The noise the JAX adapter draws for its first decode (seed 0)."""
    _, k = jax.random.split(jax.random.PRNGKey(0))
    return np.array(jax.random.normal(k, shape, dtype=jnp.float32))


def test_codec_decodes_ids_beyond_its_codes():
    """FSQ levels (7, 5, 5) give 175 codes, the LM's codebooks 180 ids:
    ids 175-179 go through the index arithmetic of both decoders alike."""
    jmodel, params, port = build_codec()
    idx = np.array([[[175, 176, 177, 178, 179, 0, 174, 90], [179, 3, 175, 60, 178, 177, 176, 1]]])
    lengths = np.array([8], np.int32)
    noise = np.random.default_rng(1).standard_normal((1, 32, 12)).astype(np.float32)
    want = jmodel.apply({"params": params}, jnp.asarray(idx), jnp.asarray(lengths), jnp.asarray(noise),
                        method=JaxDMelCodec.decode)
    with torch.no_grad():
        got = port.decode(torch.from_numpy(idx), torch.from_numpy(lengths), torch.from_numpy(noise))
    assert np.isfinite(to_np(got)).all()
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5, rtol=1e-4)


def test_codec_adapter_and_audio_loading(tmp_path):
    """The prompt-audio path: a 16 kHz int16 WAV loads (resampled, peak
    0.95) as through the JAX package's loader, with the default backend
    (both the native C++ decode) and with the numpy backend, and the adapter
    tokenizes it, with and without per-sample lengths, to the JAX adapter's
    indices; `get_latent` within 1e-4 (two FFTs under a log, then 3 WaveNet layers)."""
    from dmel_codec_tpu.data.audio import load_audio as jax_load_audio
    from dmel_codec_tpu.data.audio import load_audio_python
    from dmel_codec_tpu_torch.data.audio import load_audio

    t = np.arange(16000) / 16000.0
    tone = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * np.sin(2 * np.pi * 1333.0 * t)
    tone += 0.05 * np.random.default_rng(0).standard_normal(t.shape)  # no mel bin at the log floor
    wavfile.write(tmp_path / "p.wav", 16000, (tone * 32767).astype(np.int16))
    audio = load_audio(str(tmp_path / "p.wav"), target_sr=24000)
    np.testing.assert_array_equal(audio, jax_load_audio(str(tmp_path / "p.wav"), target_sr=24000))
    np.testing.assert_array_equal(load_audio(str(tmp_path / "p.wav"), target_sr=24000, backend="python"),
                                  load_audio_python(str(tmp_path / "p.wav"), target_sr=24000))
    assert audio.shape == (24000,) and abs(np.abs(audio).max() - 0.95) < 1e-6

    _, cparams, cport = build_codec()
    jadapter = JaxDMelCodecAdapter(cparams, JaxDMelCodecConfig(**CODEC_KW))
    adapter = DMelCodecAdapter(cport)
    batch = np.stack([audio, np.roll(audio, 5000)])
    for lengths in (None, np.array([24000, 13000])):
        want_idx, want_len = jadapter.encode(batch, lengths)
        got_idx, got_len = adapter.encode(batch, lengths)
        np.testing.assert_array_equal(got_len, want_len)
        np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_allclose(adapter.get_latent(batch), jadapter.get_latent(batch), atol=1e-4, rtol=1e-4)
    wav, mel = adapter.decode(got_idx, got_len)
    assert wav.shape == (2, 0) and mel.shape == (2, got_idx.shape[2] * 4, CODEC_KW["n_mels"])


def test_infer_lm_slice(lm, tmp_path, monkeypatch):
    """`cli.infer_lm.main --device cpu` on small checkpoints against the JAX
    chain generate -> deshift -> clip -> DMelCodecAdapter.decode on the same
    weights, greedy, fed the JAX adapter's noise. 2e-4 abs on a waveform in
    [-1, 1]: the codec decode agrees to 1e-5 and the vocoder's two forms to
    1e-4 (tests/test_torch_slice.py)."""
    jm, params, pm = lm
    _, vparams, vport = build_vocoder()
    # the LM speaks 10 codebooks; give the small codec 10 dMel groups of 2 mels
    codec_kw = dict(CODEC_KW, dmel_groups=10)
    _, cparams, cport = _codec_with(codec_kw)
    CheckpointManager(str(tmp_path / "lm")).save(5, {"step": 5, "params": pm.state_dict()})
    CheckpointManager(str(tmp_path / "codec")).save(0, {"gen_params": cport.state_dict()})
    torch.save({"generator": vport.state_dict()}, tmp_path / "vocoder.pt")
    cfg = {
        "lm_ckpt_dir": str(tmp_path / "lm"),
        "codec_ckpt_dir": str(tmp_path / "codec"),
        "vocoder_ckpt": str(tmp_path / "vocoder.pt"),
        "text_tokenizer_path": None,
        "silence_length": 3,
        "text_weight": 0.01,
        "slow_lm": SLOW_KW,
        "fast_lm": FAST_KW,
        "model": codec_kw,
        "vocoder": {k: list(v) if isinstance(v, tuple) else v for k, v in VOCODER_KW.items()},
        "inference": dict(GREEDY, max_new_tokens=7),
    }
    (tmp_path / "infer.yaml").write_text(yaml.safe_dump(cfg))
    out = tmp_path / "out.wav"

    # the JAX chain
    text_t, audio_t = JaxTokenGridBuilder(config=JAX_TINY).build_infer_grid(text_ids=JaxByteTokenizer().encode("hi"))
    jgen = JaxSlowFastGenerator(jm, params, JaxInferenceConfig(**cfg["inference"]))
    audio_ids, _ = jgen.generate(text_t, audio_t, jax.random.PRNGKey(0))
    raw = np.clip(jgen.deshift(audio_ids[:-1]), 0, JAX_TINY.audio_codebook_size - 1)
    assert raw.shape == (6, 10) and (raw >= 175).any(), raw.max()
    jadapter = JaxDMelCodecAdapter(cparams, JaxDMelCodecConfig(**codec_kw), vparams, JaxBigVGANConfig(**VOCODER_KW))
    want, _ = jadapter.decode(raw.T[None])

    shape = (1, 6 * 4, JaxDMelCodecConfig(**codec_kw).concat_dim)
    monkeypatch.setattr(DMelCodecAdapter, "_noise", lambda self, s: torch.from_numpy(_jax_noise(shape)).reshape(s))
    infer_lm.main(["--config", str(tmp_path / "infer.yaml"), "--prompt", "hi", "--out", str(out), "--device", "cpu"])
    sr, got = wavfile.read(out)
    # 6 frames (the <EOM> frame dropped) x 4 mel frames x the small vocoder's 2 * 2 samples
    assert sr == 24000 and got.dtype == np.float32 and got.shape == (6 * 4 * 4,) == want[0].shape
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(got, want[0], atol=2e-4)

    with pytest.raises(FileNotFoundError):
        shutil.rmtree(tmp_path / "lm" / "step_5")
        infer_lm.main(["--config", str(tmp_path / "infer.yaml"), "--device", "cpu"])


def _codec_with(codec_kw):
    import tests.test_torch_support as support

    saved = support.CODEC_KW
    support.CODEC_KW = codec_kw
    try:
        return support.build_codec()
    finally:
        support.CODEC_KW = saved
