"""The port's codec serving path against the JAX package at a small config.

waveform -> log-mel -> DMelCodec.encode -> indices must equal JAX's; the
decode side (indices -> mel -> serving vocoder -> waveform) starts from the
JAX indices, so an index flip could not propagate. Also: the codec and
vocoder modules one by one, and the port importing and running with jax and
flax blocked.
"""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_codec_tpu.dsp.spectrogram import LogMelSpectrogram as JaxLogMel
from dmel_codec_tpu.models.bigvgan import bigvgan_apply_fused as jax_apply_fused
from dmel_codec_tpu.models.codec import DMelCodec as JaxDMelCodec
from dmel_codec_tpu_torch.dsp.spectrogram import LogMelSpectrogram
from dmel_codec_tpu_torch.models.bigvgan import FusedBigVGAN
from tests.test_torch_support import (  # noqa: F401  (strict_f32 is a fixture)
    CODEC_KW,
    FRAMES,
    JaxBigVGANConfig,
    VOCODER_KW,
    build_codec,
    build_vocoder,
    strict_f32,
    to_np,
)

pytestmark = pytest.mark.usefixtures("strict_f32")
HOP = 256
CAP = VOCODER_KW["upsample_initial_channel"] // 4  # fuse the last stage (C = 8) only


@pytest.fixture(scope="module")
def models():
    return build_codec(), build_vocoder()


@pytest.fixture(scope="module")
def jax_codec(models):
    """Jitted JAX encode / decode (compiling once beats flax's op-by-op apply)."""
    (jmodel, params, _), _ = models
    p = {"params": params}
    encode = jax.jit(lambda *a: jmodel.apply(p, *a, method=JaxDMelCodec.encode))
    decode = jax.jit(lambda *a: jmodel.apply(p, *a, method=JaxDMelCodec.decode))
    return encode, decode


def _audio() -> np.ndarray:
    t = np.arange(FRAMES * HOP) / 24000.0
    tones = np.stack([np.sin(2 * np.pi * f * t) for f in (220.0, 530.0)])
    noise = 0.05 * np.random.default_rng(0).standard_normal(tones.shape)
    return (0.5 * tones + noise).astype(np.float32)


def _noise(seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((2, FRAMES, 2 * 6)).astype(np.float32)


def test_codec_encode_decode(models, jax_codec):
    """encode: indices equal. decode from the JAX indices with shared noise:
    1e-5 abs / 1e-4 rel (float32 summation order over 3+3 WaveNet layers)."""
    (_, _, port), _ = models
    encode, decode = jax_codec
    mels = np.random.default_rng(2).standard_normal((2, FRAMES, CODEC_KW["n_mels"])).astype(np.float32)
    lengths = np.array([FRAMES, FRAMES - 8], np.int32)
    idx_j, ilen_j = encode(jnp.asarray(mels), jnp.asarray(lengths))
    idx_p, ilen_p = port.encode(torch.from_numpy(mels), torch.from_numpy(lengths))
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(ilen_p.numpy(), np.asarray(ilen_j))
    noise = _noise()
    want = decode(idx_j, ilen_j, jnp.asarray(noise))
    got = port.decode(
        torch.from_numpy(np.array(idx_j)).long(), torch.from_numpy(np.array(ilen_j)), torch.from_numpy(noise)
    )
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5, rtol=1e-4)


def test_bigvgan_module_and_serving_forms(models):
    """Both forms against BigVGAN.apply (which bigvgan_apply_fused equals):
    the module form, and the serving form with stage 1 fused and stage 0
    per block. 1e-4 abs on waveforms whose pre-clamp values are O(1) after
    ~80 chained ops."""
    _, (jmodel, params, port) = models
    mel = np.random.default_rng(3).standard_normal((2, FRAMES, VOCODER_KW["num_mels"])).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(mel)))
    assert 0.01 < np.abs(want).mean() and np.abs(want).max() <= 1.0
    got = port(torch.from_numpy(mel))
    assert got.shape == want.shape == (2, FRAMES * 4)
    np.testing.assert_allclose(to_np(got), want, atol=1e-4)
    got_f = FusedBigVGAN(port, fuse_max_channels=CAP)(torch.from_numpy(mel))
    np.testing.assert_allclose(to_np(got_f), want, atol=1e-4)


def test_slice_end_to_end(models, jax_codec):
    """Waveform -> indices equal; JAX indices -> waveform within 10x the
    JAX chain's own sensitivity, measured here by moving its decoder noise
    by 1e-6."""
    (_, _, port), (_, vparams, vport) = models
    encode, decode = jax_codec
    audio = _audio()
    lengths = np.full((2,), FRAMES, np.int32)
    vcfg = JaxBigVGANConfig(**VOCODER_KW)

    mels_j = JaxLogMel(n_mels=CODEC_KW["n_mels"])(jnp.asarray(audio))[:, :FRAMES]
    idx_j, ilen_j = encode(mels_j, jnp.asarray(lengths))
    mels_p = LogMelSpectrogram(n_mels=CODEC_KW["n_mels"])(torch.from_numpy(audio))[:, :FRAMES]
    idx_p, _ = port.encode(mels_p, torch.from_numpy(lengths))
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))

    @jax.jit
    def jax_chain(noise):
        mel = decode(idx_j, ilen_j, noise)
        return jax_apply_fused(vparams, mel, vcfg, fuse_max_channels=CAP)

    noise = _noise()
    want = np.asarray(jax_chain(noise))
    moved = np.asarray(
        jax_chain(noise + 1e-6 * np.random.default_rng(9).standard_normal(noise.shape).astype(np.float32))
    )
    sensitivity = np.abs(moved - want).max()
    assert sensitivity > 0

    gen_mel = port.decode(
        torch.from_numpy(np.array(idx_j)).long(), torch.from_numpy(np.array(ilen_j)), torch.from_numpy(noise)
    )
    got = FusedBigVGAN(vport, fuse_max_channels=CAP)(gen_mel)
    assert got.shape == (2, FRAMES * 4)
    err = np.abs(to_np(got) - want).max()
    print(f"max err {err:.3e}, chain sensitivity {sensitivity:.3e}")
    assert err <= 10 * sensitivity, (err, sensitivity)


def test_port_runs_without_jax():
    """Every port module imports, and the small codec slice, a chunked
    vocode, a probe variant, an LM generation and an LM train step run, with
    jax and flax blocked."""
    root = Path(__file__).resolve().parents[1]
    script = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        sys.modules["jax"] = sys.modules["flax"] = sys.modules["dmel_codec_tpu"] = None
        import torch
        torch.set_num_threads(1)
        import dmel_codec_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        assert not any(n.split(".")[0] in ("jax", "flax", "dmel_codec_tpu") for n in sys.modules
                       if sys.modules[n] is not None)
        from dmel_codec_tpu_torch.dsp.spectrogram import LogMelSpectrogram
        from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, FusedBigVGAN
        from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
        torch.manual_seed(0)
        codec = DMelCodec(DMelCodecConfig(n_mels=20, dmel_groups=2, encoder_residual_channels=6,
                                          encoder_layers=2, decoder_layers=2)).eval()
        voc = BigVGAN(BigVGANConfig(num_mels=20, upsample_initial_channel=32, upsample_rates=(2, 2),
                                    upsample_kernel_sizes=(4, 4))).eval()
        with torch.no_grad():
            mels = LogMelSpectrogram(n_mels=20)(torch.randn(2, 8192) * 0.3)[:, :32]
            idx, ilen = codec.encode(mels, torch.tensor([32, 32]))
            mel = codec.decode(idx, ilen, generator=torch.Generator().manual_seed(0))
            wav = FusedBigVGAN(voc, fuse_max_channels=8)(mel)
        assert idx.shape == (2, 2, 8) and wav.shape == (2, 128) and torch.isfinite(wav).all()
        from dmel_codec_tpu_torch.cli import stream_codec
        from dmel_codec_tpu_torch.models import streaming
        from dmel_codec_tpu_torch.probes import act_variants
        fused_v1 = FusedBigVGAN(voc, fuse_max_channels=8, use_v2=False)
        chunked = streaming.chunked_vocode(fused_v1, mel.numpy(), chunk_frames=8, halo_frames=8)
        assert fused_v1.routes == ["block", "K2-v1"] and chunked.shape == (2, 128)
        assert act_variants.run_variant(mel, torch.zeros(32), None, "no_fir").shape == mel.shape
        assert callable(stream_codec.main)
        import numpy as np
        from dmel_codec_tpu_torch.lm.generate import InferenceConfig, SlowFastGenerator
        from dmel_codec_tpu_torch.lm.inputs import TokenGridBuilder
        from dmel_codec_tpu_torch.lm.tokenizer import ByteTokenizer
        from dmel_codec_tpu_torch.models.lm import ChatMusicLM, SlowFastLMConfig
        from dmel_codec_tpu_torch.models.transformer import TransformerConfig
        lm_cfg = SlowFastLMConfig(slow=TransformerConfig(151936, 32, 64, 2, 4, 2),
                                  fast=TransformerConfig(1800, 24, 48, 2, 4, 2))
        lm = ChatMusicLM(lm_cfg).eval()
        grid = TokenGridBuilder(config=lm_cfg).build_infer_grid(text_ids=ByteTokenizer().encode("hi"))
        gen = SlowFastGenerator(lm, InferenceConfig(max_new_tokens=3, max_seq_len=32))
        audio, text = gen.generate(*grid, torch.Generator().manual_seed(0))
        batch_audio, _ = gen.generate_batched(np.stack([grid[0]] * 2), np.stack([grid[1]] * 2),
                                              torch.Generator().manual_seed(0))
        assert audio.shape[1] == 10 and 1 <= len(audio) == len(text) <= 3 and len(batch_audio) == 2
        from dmel_codec_tpu_torch.cli import train_lm
        from dmel_codec_tpu_torch.lm.inputs import pad_grids_to_batch
        from dmel_codec_tpu_torch.train.lm_trainer import LMTrainConfig, LMTrainer
        train_cfg = SlowFastLMConfig(slow=TransformerConfig(151936, 32, 64, 2, 4, 2, flash_attention=True,
                                                            flash_min_seq=16, remat=True),
                                     fast=TransformerConfig(1800, 24, 48, 2, 4, 2))
        trainer = LMTrainer(train_cfg, LMTrainConfig(accumulate_grad=1, num_warmup_steps=0), device="cpu")
        state = trainer.init_state(0)
        rng = np.random.default_rng(0)
        grids = [TokenGridBuilder(config=train_cfg).build_train_grid(rng.integers(0, 1000, size=4),
                                                                     rng.integers(0, 175, size=(9, 10)))]
        before = state.params["audio_head.weight"].detach().clone()
        state, metrics = trainer.train_step(state, trainer.device_batch(pad_grids_to_batch(grids, train_cfg)))
        assert state.step == 1 and np.isfinite(float(metrics["train/loss"])) and float(metrics["train/grad_norm"]) > 0
        assert not torch.equal(before, state.params["audio_head.weight"]) and callable(train_lm.main)
        assert not any(n.split(".")[0] in ("jax", "flax", "dmel_codec_tpu") for n in sys.modules
                       if sys.modules[n] is not None)
        print("ok")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=root, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]
