"""Per-module parity of the PyTorch port against the JAX package (CPU, float32).

Each case feeds the same seeded numpy input through a JAX module and its
port, with the JAX parameters carried over by `dmel_codec_tpu_torch.convert`.
Unless a test says otherwise the tolerance is 1e-5 abs / 1e-4 rel: the two
frameworks sum the same float32 products in different orders (~1e-7
relative per op), over a few layers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_codec_tpu.dsp.spectrogram import LogMelSpectrogram as JaxLogMel
from dmel_codec_tpu.models.bigvgan import params_from_torch_state_dict
from dmel_codec_tpu.models.codec_convert import codec_params_from_torch_state_dict
from dmel_codec_tpu.nn.convnext import ConvNeXtBlock as JaxConvNeXt
from dmel_codec_tpu.nn.wavenet import WaveNet as JaxWaveNet
from dmel_codec_tpu.quantize.downsample_fsq import DownsampleFiniteScalarQuantize as JaxDFSQ
from dmel_codec_tpu.quantize.fsq import FSQ as JaxFSQ
from dmel_codec_tpu.quantize.fsq import GroupedResidualFSQ as JaxGRFSQ
from dmel_codec_tpu_torch.dsp.spectrogram import LogMelSpectrogram
from dmel_codec_tpu_torch.quantize.fsq import FSQ
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
TOL = dict(atol=1e-5, rtol=1e-4)
G = CODEC_KW["dmel_groups"]
BAND = CODEC_KW["n_mels"] // G
RES = CODEC_KW["encoder_residual_channels"]
CONCAT = G * RES
LEVELS = (7, 5, 5)


@pytest.fixture(scope="module")
def codec():
    return build_codec()


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _cf(a: np.ndarray) -> torch.Tensor:
    """[B, T, C] numpy -> channels-first torch."""
    return _t(a).transpose(1, 2)


def test_log_mel():
    """rfft vs XLA's FFT (~1e-7 relative), then log: 1e-4 abs on log-mels."""
    audio = (0.3 * np.random.default_rng(0).standard_normal((2, 8192))).astype(np.float32)
    want = np.asarray(JaxLogMel()(jnp.asarray(audio)))
    got = LogMelSpectrogram()(_t(audio))
    assert got.shape == want.shape
    np.testing.assert_allclose(to_np(got), want, atol=1e-4)


def test_wavenet_encoder(codec):
    _, params, port = codec
    x = np.random.default_rng(1).standard_normal((2 * G, FRAMES, BAND)).astype(np.float32)
    jnet = JaxWaveNet(input_channels=BAND, residual_channels=RES, residual_layers=3)
    want = jnet.apply({"params": params["encoder"]}, jnp.asarray(x))
    got = port.encoder(_cf(x)).transpose(1, 2)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_wavenet_decoder_with_condition(codec):
    _, params, port = codec
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, FRAMES, CONCAT)).astype(np.float32)
    cond = rng.standard_normal((2, FRAMES, CONCAT)).astype(np.float32)
    jnet = JaxWaveNet(
        input_channels=CONCAT, output_channels=CODEC_KW["n_mels"], residual_channels=CONCAT,
        residual_layers=3, condition_channels=CONCAT,
    )
    want = jnet.apply({"params": params["decoder"]}, jnp.asarray(x), condition=jnp.asarray(cond))
    got = port.decoder(_cf(x), _cf(cond)).transpose(1, 2)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_convnext(codec):
    _, params, port = codec
    x = np.random.default_rng(3).standard_normal((3, 16, RES)).astype(np.float32)
    want = JaxConvNeXt(dim=RES).apply(
        {"params": params["quantizer"]["downsample_0_block"]}, jnp.asarray(x)
    )
    got = port.quantizer.downsample[0][1](_cf(x)).transpose(1, 2)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_fsq_bit_identical():
    """Bound, round-half-even and the float mixed-radix sum: same float32
    ops on both sides, so codes and indices are identical."""
    z = (2.0 * np.random.default_rng(4).standard_normal((4096, 3))).astype(np.float32)
    codes_j, idx_j = JaxFSQ(levels=LEVELS).apply({}, jnp.asarray(z))
    codes_p, idx_p = FSQ(LEVELS)(_t(z))
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(codes_p.numpy(), np.asarray(codes_j))
    back = FSQ(LEVELS).indices_to_codes(idx_p.long())
    np.testing.assert_array_equal(back.numpy(), np.asarray(codes_j))


def test_grouped_residual_fsq(codec):
    """Through the per-group projections. An index flips only when the two
    frameworks' projections straddle a rounding boundary (~1e-7 apart):
    none at this size."""
    _, params, port = codec
    x = np.random.default_rng(5).standard_normal((2, 8, CONCAT)).astype(np.float32)
    jq = JaxGRFSQ(dim=CONCAT, levels=LEVELS, num_quantizers=1, groups=G)
    p = {"params": params["quantizer"]["residual_fsq"]}
    q_j, idx_j = jq.apply(p, jnp.asarray(x))
    q_p, idx_p = port.quantizer.residual_fsq(_t(x))
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(to_np(q_p), np.asarray(q_j), **TOL)
    dec_j = jq.apply(p, idx_j, method=jq.decode)
    dec_p = port.quantizer.residual_fsq.decode(torch.from_numpy(np.array(idx_j)).long())
    np.testing.assert_allclose(to_np(dec_p), np.asarray(dec_j), **TOL)


def _jax_dfsq():
    return JaxDFSQ(
        input_dim=CONCAT, n_codebooks=1, n_groups=G, levels=LEVELS,
        downsample_factor=(2, 2), is_dmel=True,
    )


def test_downsample_fsq_encode_decode(codec):
    """encode: indices equal (no flip at this size, see above); decode from
    the JAX indices: features within TOL."""
    _, params, port = codec
    z = np.random.default_rng(6).standard_normal((2 * G, FRAMES, RES)).astype(np.float32)
    q = _jax_dfsq()
    p = {"params": params["quantizer"]}
    idx_j = np.array(q.apply(p, jnp.asarray(z), method=q.encode))
    idx_p = port.quantizer.encode(_cf(z))
    assert idx_p.shape == idx_j.shape == (2, G, FRAMES // 4)
    np.testing.assert_array_equal(idx_p.numpy(), idx_j)
    want = q.apply(p, jnp.asarray(idx_j), method=q.decode)
    got = port.quantizer.decode(torch.from_numpy(idx_j).long()).transpose(1, 2)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_quality_from_gt_mels():
    """Occupancy count of mel bins whose time-mean exceeds -8: exact."""
    from dmel_codec_tpu.models.codec import quality_from_gt_mels as jax_quality
    from dmel_codec_tpu_torch.models.codec import quality_from_gt_mels

    mels = (np.random.default_rng(7).standard_normal((3, 40, 100)) - 8.0).astype(np.float32)
    want = np.asarray(jax_quality(jnp.asarray(mels)))
    got = quality_from_gt_mels(_t(mels))
    assert got.shape == want.shape == (3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def _flat(tree) -> dict:
    return {
        jax.tree_util.keystr(path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].reshape(want[k].shape), want[k], err_msg=k)


def test_codec_bridge_round_trip(codec):
    """port state_dict -> the JAX package's torch-checkpoint converter ->
    the JAX tree it came from, exactly."""
    from dmel_codec_tpu.models.codec import DMelCodecConfig as JaxCfg

    _, params, port = codec
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    _assert_same_tree(codec_params_from_torch_state_dict(sd, JaxCfg(**CODEC_KW)), params)


def test_bigvgan_bridge_round_trip():
    _, params, port = build_vocoder()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    _assert_same_tree(params_from_torch_state_dict(sd, JaxBigVGANConfig(**VOCODER_KW)), params)
