"""Chunked (streaming) inference of the port: equal to its own one-shot
calls and to the JAX package's `models/streaming.py` on the same weights,
inputs and noise, at a small size (WaveNet 4 layers x 12 channels, vocoder
at the flagship geometry with narrow channels); the windowing formula; and
the `stream_codec` entry point on the CPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from dmel_codec_tpu.models import streaming as jax_streaming
from dmel_codec_tpu_torch.cli import stream_codec
from dmel_codec_tpu_torch.convert import bigvgan_state_dict_from_jax, codec_state_dict_from_jax
from dmel_codec_tpu_torch.models import streaming
from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, FusedBigVGAN
from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
from tests.test_torch_support import (  # noqa: F401  (strict_f32 is a fixture)
    JaxBigVGAN,
    JaxBigVGANConfig,
    JaxDMelCodec,
    JaxDMelCodecConfig,
    init_params,
    strict_f32,
)

pytestmark = pytest.mark.usefixtures("strict_f32")

CODEC_KW = dict(encoder_residual_channels=12, encoder_layers=4, decoder_layers=4)
HALO = 64  # frames; 4 layers of dilations 1, 2, 4, 8 reach 15, the ConvNeXt blocks 18
VOCODER_KW = dict(num_mels=8, upsample_initial_channel=64)  # stage widths 32 .. 1


@pytest.fixture(scope="module")
def codec():
    """(jax model, jax params, port model) on the same weights."""
    jcfg = JaxDMelCodecConfig(**CODEC_KW)
    jmodel = JaxDMelCodec(config=jcfg)
    t = 32
    params = init_params(
        jmodel, 0, jnp.zeros((2, t, jcfg.n_mels)), jnp.ones((2, t, 1)), jnp.zeros((2, 1)),
        jnp.zeros((2, t, jcfg.concat_dim)),
    )
    port = DMelCodec(DMelCodecConfig(**CODEC_KW))
    port.load_state_dict(codec_state_dict_from_jax(params))
    return jmodel, params, port.eval()


@pytest.fixture(scope="module")
def vocoder():
    """Weight-norm gains halved: with unit gains the 6-stage random chain
    saturates the clamp (94 % of samples) and moves by 3e-4 for 1e-6 at its
    input, so that even the JAX chunked and one-shot runs part by 1.7e-4."""
    jmodel = JaxBigVGAN(config=JaxBigVGANConfig(**VOCODER_KW))
    params = init_params(jmodel, 1, jnp.zeros((1, 8, VOCODER_KW["num_mels"])))
    params = jax.tree_util.tree_map_with_path(lambda p, a: 0.5 * a if p[-1].key == "g" else a, params)
    cfg = BigVGANConfig(**VOCODER_KW)
    port = BigVGAN(cfg)
    port.load_state_dict(bigvgan_state_dict_from_jax(params, cfg))
    return jmodel, params, port.eval()


@pytest.fixture(scope="module")
def jax_vocoded(vocoder):
    """JAX `chunked_vocode` per clip length (T = 64 runs one-shot there too)."""
    jmodel, params, _ = vocoder
    out = {}
    for t in (300, 64):
        mel = np.random.default_rng(t).standard_normal((2, t, VOCODER_KW["num_mels"])).astype(np.float32)
        out[t] = mel, jax_streaming.chunked_vocode(jmodel, params, mel, chunk_frames=96, halo_frames=40)
    return out


@pytest.mark.parametrize("t", [1000, 128])  # a tail chunk; shorter than one window
def test_chunked_encode_equals_jax_and_one_shot(codec, t):
    """Token equality. The JAX function runs op by op (`disable_jit`): its
    fused program turns the same quantized codes into an index one lower
    for about 1 token in 1500 (float -> int truncation of a fused
    scale-and-shift), while op by op it gives the port's tokens exactly.
    The fused program, which is what the JAX package's users run, is held
    too: at most 1 token in 250 may differ (5 of 5000 do at T = 1000, none
    at T = 128), and each by exactly that one step down."""
    jmodel, params, port = codec
    mels = np.random.default_rng(t).standard_normal((2, t, 100)).astype(np.float32)
    with jax.disable_jit():
        want = jax_streaming.chunked_encode(jmodel, params, mels, chunk_frames=256, halo_frames=HALO)
    got = streaming.chunked_encode(port, mels, chunk_frames=256, halo_frames=HALO)
    with torch.no_grad():
        one_shot, _ = port.encode(torch.from_numpy(mels), torch.full((2,), t))
    assert got.shape == want.shape == (2, 10, t // 4)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, one_shot.numpy())
    jitted = jax_streaming.chunked_encode(jmodel, params, mels, chunk_frames=256, halo_frames=HALO)
    step = got.astype(np.int64) - np.asarray(jitted).astype(np.int64)
    assert set(np.unique(step)) <= {0, 1}
    assert np.count_nonzero(step) <= got.size // 250


def test_chunked_encode_crops_to_the_downsample_multiple(codec):
    _, _, port = codec
    mels = np.random.default_rng(5).standard_normal((1, 530, 100)).astype(np.float32)
    got = streaming.chunked_encode(port, mels, chunk_frames=128, halo_frames=HALO)
    want = streaming.chunked_encode(port, mels[:, :528], chunk_frames=128, halo_frames=HALO)
    assert got.shape == (1, 10, 132)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="multiples of 4"):
        streaming.chunked_encode(port, mels, chunk_frames=130, halo_frames=HALO)


@pytest.mark.parametrize("l", [256, 40])  # four chunks; shorter than one window
def test_chunked_decode_equals_jax_and_one_shot(codec, l):
    """Same indices and noise on both sides: 1e-5 abs / 1e-5 rel, as
    tests/test_streaming.py (float32 summation order over 4 WaveNet layers)."""
    jmodel, params, port = codec
    rng = np.random.default_rng(l)
    indices = rng.integers(0, 175, size=(2, 10, l))
    noise = rng.standard_normal((2, 4 * l, 120)).astype(np.float32)
    want = jax_streaming.chunked_decode(jmodel, params, indices, noise=noise, chunk_tokens=64, halo_tokens=HALO // 4)
    got = streaming.chunked_decode(port, indices, noise=noise, chunk_tokens=64, halo_tokens=HALO // 4)
    with torch.no_grad():
        one_shot = port.decode(torch.from_numpy(indices), torch.full((2,), l), torch.from_numpy(noise))
    assert got.shape == want.shape == (2, 4 * l, 100)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, one_shot.numpy(), atol=1e-5, rtol=1e-5)


def test_chunked_decode_draws_its_noise_from_the_seed(codec):
    _, _, port = codec
    indices = np.random.default_rng(0).integers(0, 175, size=(1, 10, 100))
    a = streaming.chunked_decode(port, indices, chunk_tokens=32, halo_tokens=16, seed=3)
    b = streaming.chunked_decode(port, indices, chunk_tokens=32, halo_tokens=16, seed=3)
    c = streaming.chunked_decode(port, indices, chunk_tokens=32, halo_tokens=16, seed=4)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-3


@pytest.mark.parametrize("t", [300, 64])  # a tail chunk; shorter than one window
@pytest.mark.parametrize("form", ["module", "fused_v2", "fused_v1"])
def test_chunked_vocode_equals_jax_and_one_shot(vocoder, jax_vocoded, form, t):
    """The module and both serving forms, chunked, against the JAX
    `chunked_vocode` and against the same form one-shot: 1e-5 abs / 1e-5
    rel as tests/test_streaming.py (waveforms within [-1, 1])."""
    _, _, port = vocoder
    mel, want = jax_vocoded[t]
    run = {"module": port, "fused_v2": FusedBigVGAN(port), "fused_v1": FusedBigVGAN(port, use_v2=False)}[form]
    if form != "module":
        assert set(run.routes) == {"K2" if form == "fused_v2" else "K2-v1"}
    got = streaming.chunked_vocode(run, mel, chunk_frames=96, halo_frames=40)
    with torch.no_grad():
        one_shot = run(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, t * 256)
    assert np.sqrt(np.square(want).mean()) > 0.01 and np.abs(want).max() < 1.0  # a live, unclipped signal
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, one_shot, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("t,chunk,halo", [(1000, 256, 64), (561, 480, 40), (56250, 480, 40), (385, 256, 64), (2048, 64, 16)])
def test_window_positions_follow_the_jax_formula(t, chunk, halo):
    """pos = min(max(start - halo, 0), t - window) (streaming.py:92, :150,
    :190); every window lies inside the signal and holds its chunk with a
    full halo wherever the signal has one."""
    window = chunk + 2 * halo
    got = list(streaming.window_positions(t, chunk, halo))
    assert got == [(s, min(max(s - halo, 0), t - window)) for s in range(0, t, chunk)]
    for start, pos in got:
        end = min(start + chunk, t)
        assert 0 <= pos and pos + window <= t
        assert pos <= max(start - halo, 0) and min(end + halo, t) <= pos + window


def test_stream_codec_cli_round_trips_a_wav_on_the_cpu(tmp_path):
    """WAV -> tokens -> WAV through `cli.stream_codec.main --device cpu`,
    small random-weight models; decoding the saved tokens again (same seed)
    writes the same samples."""
    sr = 24000
    t = np.arange(2 * sr) / sr
    wavfile.write(tmp_path / "in.wav", sr, (0.4 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32))
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump({
        "model": dict(n_mels=20, dmel_groups=2, encoder_residual_channels=6, encoder_layers=3, decoder_layers=3),
        "vocoder": dict(num_mels=20, upsample_initial_channel=64),
    }))
    common = ["--config", str(tmp_path / "cfg.yaml"), "--device", "cpu", "--chunk-frames", "64", "--halo-frames", "32"]
    stream_codec.main(["--in", str(tmp_path / "in.wav"), "--tokens-out", str(tmp_path / "tok.npy"),
                       "--out", str(tmp_path / "out.wav"), "--use-v1", *common])
    tokens = np.load(tmp_path / "tok.npy")
    frames = (2 * sr // 256 // 4) * 4
    assert tokens.shape == (1, 2, frames // 4) and tokens.min() >= 0 and tokens.max() < 175
    out_sr, wav = wavfile.read(tmp_path / "out.wav")
    assert out_sr == sr and wav.shape == (frames * 256,) and wav.dtype == np.float32
    assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    stream_codec.main(["--tokens-in", str(tmp_path / "tok.npy"), "--out", str(tmp_path / "again.wav"), *common])
    np.testing.assert_allclose(wavfile.read(tmp_path / "again.wav")[1], wav, atol=1e-5)
    with pytest.raises(SystemExit):
        stream_codec.main(["--out", str(tmp_path / "x.wav"), *common])
