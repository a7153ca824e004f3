"""The port's public attributes, helpers and loaders against the JAX package's
values (CPU, float32): the codec and FSQ configs' derived numbers, the
log-mel front end's fields and its functional form, `FSQResult.loss`,
`config_to_dict`, and BigVGAN's `from_pretrained` on a hub id that sits in a
local Hugging Face cache (nothing is downloaded: every call that names a hub
id passes `local_files_only=True`).
"""

from __future__ import annotations

import dataclasses
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_codec_tpu.dsp import spectrogram as jax_spec
from dmel_codec_tpu.models.codec import DMelCodecConfig as JaxDMelCodecConfig
from dmel_codec_tpu.models.firefly import FireflyArchitectureConfig as JaxFireflyArchitectureConfig
from dmel_codec_tpu.quantize import downsample_fsq as jax_dfsq
from dmel_codec_tpu.quantize import fsq as jax_fsq
from dmel_codec_tpu.utils.config import config_to_dict as jax_config_to_dict
from dmel_codec_tpu_torch.dsp import spectrogram as port_spec
from dmel_codec_tpu_torch.models import bigvgan
from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from dmel_codec_tpu_torch.models.codec import DMelCodecConfig
from dmel_codec_tpu_torch.models.firefly import FireflyArchitectureConfig
from dmel_codec_tpu_torch.quantize import downsample_fsq as port_dfsq
from dmel_codec_tpu_torch.quantize import fsq as port_fsq
from dmel_codec_tpu_torch.utils.config import config_to_dict
from tests.test_torch_support import VOCODER_KW, strict_f32  # noqa: F401  (strict_f32 is a fixture)

pytestmark = pytest.mark.usefixtures("strict_f32")

CODEC_CONFIGS = [dict(), dict(n_mels=128, dmel_groups=16, hop_length=512, sample_rate=44100,
                              n_codebooks=2, downsample_factor=(2, 2, 2), levels=(8, 5, 5, 5))]
CODEC_PROPERTIES = ["band_mels", "concat_dim", "downsample_total", "frame_rate", "num_codebook_rows",
                    "codebook_size"]


@pytest.mark.parametrize("kw", CODEC_CONFIGS, ids=["default", "44k"])
@pytest.mark.parametrize("prop", CODEC_PROPERTIES)
def test_codec_config_properties(kw, prop):
    assert getattr(DMelCodecConfig(**kw), prop) == getattr(JaxDMelCodecConfig(**kw), prop)


def test_codec_config_flagship_values():
    cfg = DMelCodecConfig()
    assert (cfg.frame_rate, cfg.num_codebook_rows) == (23.4375, 10)


MEL_CONFIGS = [dict(), dict(sample_rate=44100, n_fft=2048, win_length=2048, hop_length=512, n_mels=128,
                            f_min=30.0, f_max=None)]


@pytest.mark.parametrize("kw", MEL_CONFIGS, ids=["default", "44k"])
def test_log_mel_fields(kw):
    port, jax_mel = port_spec.LogMelSpectrogram(**kw), jax_spec.LogMelSpectrogram(**kw)
    for field in ("sample_rate", "n_fft", "win_length", "hop_length", "n_mels", "f_min", "f_max"):
        assert getattr(port, field) == getattr(jax_mel, field), field
    np.testing.assert_array_equal(port.mel_basis.numpy(), jax_mel.mel_basis)
    np.testing.assert_array_equal(port.window.numpy(), jax_mel.window)


@pytest.mark.parametrize("kw", MEL_CONFIGS, ids=["default", "44k"])
@pytest.mark.parametrize("num_samples", [0, 1, 255, 8192])
def test_log_mel_num_frames(kw, num_samples):
    port, jax_mel = port_spec.LogMelSpectrogram(**kw), jax_spec.LogMelSpectrogram(**kw)
    assert port.num_frames(num_samples) == jax_mel.num_frames(num_samples)


def test_log_mel_num_frames_counts_the_output():
    port = port_spec.LogMelSpectrogram()
    audio = torch.zeros(1, 8192)
    assert port(audio).shape[1] == port.num_frames(8192)


@pytest.mark.parametrize("kw", MEL_CONFIGS, ids=["default", "44k"])
def test_log_mel_spectrogram_function(kw):
    """The functional form on the module's constants, within `test_log_mel`'s 1e-4."""
    audio = (0.3 * np.random.default_rng(7).standard_normal((2, 1, 12000))).astype(np.float32)
    jax_mel = jax_spec.LogMelSpectrogram(**kw)
    port = port_spec.LogMelSpectrogram(**kw)
    common = dict(n_fft=jax_mel.n_fft, hop_length=jax_mel.hop_length)
    want = jax_spec.log_mel_spectrogram(jnp.asarray(audio), mel_basis=jnp.asarray(jax_mel.mel_basis),
                                        window=jnp.asarray(jax_mel.window), **common)
    got = port_spec.log_mel_spectrogram(torch.from_numpy(audio), mel_basis=port.mel_basis,
                                        window=port.window, **common)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    torch.testing.assert_close(port(torch.from_numpy(audio)), got, rtol=0, atol=0)


@pytest.mark.parametrize("levels", [(8, 5, 5, 5), (7, 5, 5)])
def test_fsq_codebook_size(levels):
    assert port_fsq.FSQ(levels).codebook_size == jax_fsq.FSQ(levels=levels).codebook_size
    if levels == (8, 5, 5, 5):
        assert port_fsq.FSQ(levels).codebook_size == 1000


@pytest.mark.parametrize("kw", [dict(dim=40, levels=(7, 5, 5)),
                                dict(dim=48, levels=(8, 5, 5, 5), num_quantizers=2, groups=4)])
def test_grouped_residual_fsq_attributes(kw):
    port, jax_q = port_fsq.GroupedResidualFSQ(**kw), jax_fsq.GroupedResidualFSQ(**kw)
    for name in ("dim", "levels", "num_quantizers", "groups", "dim_per_group"):
        assert getattr(port, name) == getattr(jax_q, name), name
    rvq = port.rvqs[0]
    assert (rvq.dim, rvq.levels, rvq.num_quantizers) == (port.dim_per_group, port.levels, port.num_quantizers)


def test_fsq_result_loss_default():
    jax_default = {f.name: f.default for f in dataclasses.fields(jax_dfsq.FSQResult)}["loss"]
    assert {f.name: f.default for f in dataclasses.fields(port_dfsq.FSQResult)}["loss"] == jax_default == 0.0
    q = port_dfsq.DownsampleFiniteScalarQuantize(input_dim=8, n_groups=2, levels=(5, 5), downsample_factor=(2,))
    with torch.no_grad():
        assert q(torch.randn(2, 8, 16)).loss == 0.0


@pytest.mark.parametrize("port_cfg,jax_cfg", [
    (DMelCodecConfig(), JaxDMelCodecConfig()),
    (DMelCodecConfig(n_mels=20, levels=(5, 5)), JaxDMelCodecConfig(n_mels=20, levels=(5, 5))),
    (FireflyArchitectureConfig(), JaxFireflyArchitectureConfig()),
], ids=["codec-default", "codec-small", "firefly-nested"])
def test_config_to_dict(port_cfg, jax_cfg):
    assert config_to_dict(port_cfg) == jax_config_to_dict(jax_cfg)


# ---- from_pretrained on a hub id in a local Hugging Face cache --------------------

REPO_ID = "org/bigvgan-small"
REVISION = "0123456789abcdef0123456789abcdef01234567"


def _release(cfg: BigVGANConfig) -> dict:
    return {
        "num_mels": cfg.num_mels, "upsample_rates": list(cfg.upsample_rates),
        "upsample_kernel_sizes": list(cfg.upsample_kernel_sizes),
        "upsample_initial_channel": cfg.upsample_initial_channel, "resblock": cfg.resblock,
        "resblock_kernel_sizes": list(cfg.resblock_kernel_sizes),
        "resblock_dilation_sizes": [list(d) for d in cfg.resblock_dilation_sizes],
        "activation": cfg.activation, "snake_logscale": cfg.snake_logscale,
        "use_bias_at_final": cfg.use_bias_at_final, "use_tanh_at_final": cfg.use_tanh_at_final,
        "sampling_rate": 24000,
    }


@pytest.fixture
def hub_cache(tmp_path):
    """A Hugging Face cache holding one small seeded generator:
    models--org--bigvgan-small/{refs/main, snapshots/<rev>/{config.json, bigvgan_generator.pt}}."""
    torch.manual_seed(3)
    cfg = BigVGANConfig(**VOCODER_KW)
    src = BigVGAN(cfg).eval()
    repo = tmp_path / "hub" / ("models--" + REPO_ID.replace("/", "--"))
    snapshot = repo / "snapshots" / REVISION
    snapshot.mkdir(parents=True)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text(REVISION)
    (snapshot / "config.json").write_text(json.dumps(_release(cfg)))
    torch.save({"generator": src.state_dict()}, snapshot / "bigvgan_generator.pt")
    return str(tmp_path / "hub"), src


@pytest.mark.parametrize("revision", [None, REVISION])
def test_from_pretrained_resolves_a_cached_hub_id(hub_cache, revision):
    cache_dir, src = hub_cache
    loaded = bigvgan.from_pretrained(REPO_ID, cache_dir=cache_dir, revision=revision, local_files_only=True)
    assert loaded.config == src.config and not loaded.training
    want = src.state_dict()
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    mel = torch.randn(1, 12, src.config.num_mels)
    with torch.no_grad():
        torch.testing.assert_close(loaded(mel), src(mel), rtol=0, atol=0)


def test_from_pretrained_missing_hub_id_raises_offline(hub_cache):
    cache_dir, _ = hub_cache
    with pytest.raises(FileNotFoundError):
        bigvgan.from_pretrained("org/absent", cache_dir=cache_dir, local_files_only=True)
    with pytest.raises(FileNotFoundError):
        bigvgan.from_pretrained(REPO_ID, cache_dir=cache_dir, revision="f" * 40, local_files_only=True)


def test_from_pretrained_without_huggingface_hub(hub_cache, tmp_path, monkeypatch):
    """A directory never touches the hub; a hub id without huggingface_hub
    raises ImportError that names the missing package."""
    cache_dir, src = hub_cache
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(ImportError, match="huggingface_hub"):
        bigvgan.from_pretrained(REPO_ID, cache_dir=cache_dir, local_files_only=True)
    local = tmp_path / "local"
    local.mkdir()
    (local / "config.json").write_text(json.dumps(_release(src.config)))
    torch.save(src.state_dict(), local / "bigvgan_generator.pt")
    assert bigvgan.from_pretrained(str(local)).config == src.config
