"""Shared set-up for the PyTorch port's tests, and the pins on its numpy copies.

The port (`dmel_codec_tpu_torch`) is held against the JAX package on the
same inputs and weights: inputs and noise come from numpy with a seed; the
JAX parameter tree takes its structure from the flax module (`init` traced
with `jax.eval_shape`, which skips flax's slow op-by-op init) and its values
from a numpy seed; the parameters reach the port through
`dmel_codec_tpu_torch.convert`. Everything runs on the CPU in float32 with
TF32 off.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_codec_tpu.dsp import mel as jax_mel
from dmel_codec_tpu.models.bigvgan import BigVGAN as JaxBigVGAN
from dmel_codec_tpu.models.bigvgan import BigVGANConfig as JaxBigVGANConfig
from dmel_codec_tpu.models.codec import DMelCodec as JaxDMelCodec
from dmel_codec_tpu.models.codec import DMelCodecConfig as JaxDMelCodecConfig
from dmel_codec_tpu.nn import resample as jax_resample
from dmel_codec_tpu.quantize import fsq as jax_fsq
from dmel_codec_tpu_torch.convert import bigvgan_state_dict_from_jax, codec_state_dict_from_jax
from dmel_codec_tpu_torch.dsp import mel as port_mel
from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
from dmel_codec_tpu_torch.nn import resample as port_resample
from dmel_codec_tpu_torch.quantize import fsq as port_fsq
from dmel_codec_tpu_torch.utils.precision import strict_float32

# Small widths: 2 dMel bands of 10 mels, 3-layer WaveNets, a 2-stage vocoder.
CODEC_KW = dict(
    n_mels=20, dmel_groups=2, encoder_residual_channels=6, encoder_layers=3, decoder_layers=3
)
VOCODER_KW = dict(
    num_mels=20, upsample_initial_channel=32, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4)
)
FRAMES = 32  # mel frames (a multiple of the codec's 4x downsample)


@pytest.fixture
def strict_f32():
    """Float32 without TF32, and one torch thread: at these tiny shapes
    thread hand-off dominates, and beside XLA's own pool 8 threads ran the
    small vocoder 60x slower than 1."""
    threads = torch.get_num_threads()
    strict_float32()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def init_params(module, seed: int, *args) -> dict:
    """The flax module's parameter tree filled from a numpy seed: kernels
    lecun-normal (std 1/sqrt(fan_in)); weight-norm gains, norm scales and
    layer-scale gammas 1 + 0.05 N(0, 1); biases and log-alpha/beta
    0.05 N(0, 1), so no code path sits at a degenerate value."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(seed), *args)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        shape = leaf.shape
        if len(shape) >= 2:
            std = 1.0 / np.sqrt(np.prod(shape[:-1]))
            return (std * rng.standard_normal(shape)).astype(np.float32)
        base = 1.0 if path[-1].key in ("g", "weight", "gamma") else 0.0
        return (base + 0.05 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def to_np(x) -> np.ndarray:
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, dtype=np.float64)


def build_codec(seed: int = 0):
    """(jax model, jax params, port model) on the same weights."""
    jcfg = JaxDMelCodecConfig(**CODEC_KW)
    jmodel = JaxDMelCodec(config=jcfg)
    b = 2
    params = init_params(
        jmodel,
        seed,
        jnp.zeros((b, FRAMES, jcfg.n_mels)),
        jnp.ones((b, FRAMES, 1)),
        jnp.zeros((b, 1)),
        jnp.zeros((b, FRAMES, jcfg.concat_dim)),
    )
    port = DMelCodec(DMelCodecConfig(**CODEC_KW))
    port.load_state_dict(codec_state_dict_from_jax(params))
    return jmodel, params, port.eval()


def build_vocoder(seed: int = 1):
    jcfg = JaxBigVGANConfig(**VOCODER_KW)
    jmodel = JaxBigVGAN(config=jcfg)
    params = init_params(jmodel, seed, jnp.zeros((1, 8, jcfg.num_mels)))
    cfg = BigVGANConfig(**VOCODER_KW)
    port = BigVGAN(cfg)
    port.load_state_dict(bigvgan_state_dict_from_jax(params, cfg))
    return jmodel, params, port.eval()


def test_configs_mirror_the_jax_defaults():
    """The port's config dataclasses carry the JAX package's defaults."""
    assert dataclasses.asdict(DMelCodecConfig()) == dataclasses.asdict(JaxDMelCodecConfig())
    jv = dataclasses.asdict(JaxBigVGANConfig())
    for k, v in dataclasses.asdict(BigVGANConfig()).items():
        assert jv[k] == v, k


# ---- the port's copies of numpy leaf functions must not drift -------------


@pytest.mark.parametrize("n", [1024, 1000, 7])
def test_hann_window_copy(n):
    np.testing.assert_array_equal(port_mel.hann_window(n), jax_mel.hann_window(n))


@pytest.mark.parametrize(
    "sr,n_fft,n_mels,fmax", [(24000, 1024, 100, 12000.0), (16000, 512, 40, None), (24000, 1024, 20, 8000.0)]
)
def test_mel_filterbank_copy(sr, n_fft, n_mels, fmax):
    np.testing.assert_array_equal(
        port_mel.mel_filterbank(sr, n_fft, n_mels, 0.0, fmax),
        jax_mel.mel_filterbank(sr, n_fft, n_mels, 0.0, fmax),
    )


@pytest.mark.parametrize("cutoff,hw,ks", [(0.25, 0.3, 12), (0.5, 0.6, 12), (0.125, 0.15, 24), (0.2, 0.2, 7)])
def test_kaiser_sinc_filter_copy(cutoff, hw, ks):
    np.testing.assert_array_equal(
        port_resample.kaiser_sinc_filter1d(cutoff, hw, ks),
        jax_resample.kaiser_sinc_filter1d(cutoff, hw, ks),
    )


@pytest.mark.parametrize("levels", [(7, 5, 5), (8, 5, 5, 5), (8, 6, 5)])
def test_fsq_level_basis_copies(levels):
    np.testing.assert_array_equal(port_fsq._levels_np(levels), jax_fsq._levels_np(levels))
    np.testing.assert_array_equal(port_fsq._basis_np(levels), jax_fsq._basis_np(levels))
