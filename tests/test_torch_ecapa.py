"""The PyTorch port's speaker encoders against the JAX package: ECAPA-TDNN
(`eval/ecapa.py`, speechbrain's names, loaded strictly) with its fbank front
end and the speaker-similarity column (`eval/external.py`), and the
`ReferenceEncoder` (`models/reference_encoder.py`, through
`convert.reference_encoder_state_dict_from_jax`). Float32 on the CPU.
"""

from __future__ import annotations

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_codec_tpu.eval import ecapa as jecapa
from dmel_codec_tpu.eval import external as jexternal
from dmel_codec_tpu.models.reference_encoder import ReferenceEncoder as JaxReferenceEncoder
from dmel_codec_tpu_torch.convert import reference_encoder_state_dict_from_jax
from dmel_codec_tpu_torch.eval import ecapa, external
from dmel_codec_tpu_torch.models.reference_encoder import ReferenceEncoder
from tests.test_ecapa import _synthetic_speechbrain_sd
from tests.test_torch_support import init_params, strict_f32  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("strict_f32")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def sd():
    """A random state dict in speechbrain ECAPA_TDNN's layout (C = 32, scale 4)."""
    return _synthetic_speechbrain_sd(np.random.default_rng(0))


def _clips(batch: int, seconds: float = 0.6, seed: int = 1) -> np.ndarray:
    """Tones over noise at 16 kHz, each clip 10x quieter than the one before,
    so that the batch-wide top-db clamp reaches the quiet ones."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    out = [(np.sin(2 * np.pi * (150 + 60 * i) * t) + 0.3 * rng.standard_normal(t.size)) * 10.0**-i
           for i in range(batch)]
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("batch", [1, 3])
def test_fbank_matches_jax(batch):
    """Within 1e-5 of max |JAX| (~100 dB: float32 FFTs and log10 in another
    order); at B = 3 the quietest clip sits on the batch-wide clamp, so its
    features are those of its batch, as in the JAX package."""
    audio = _clips(batch)
    got = ecapa.ecapa_fbank(torch.from_numpy(audio))
    want = np.asarray(jecapa.ecapa_fbank(jnp.asarray(audio)))
    assert got.shape == want.shape == (batch, 61, 80)
    assert _rel(got, want) <= 1e-5
    if batch == 3:
        alone = ecapa.ecapa_fbank(torch.from_numpy(audio[2:]))
        assert not torch.allclose(alone[0], got[2], atol=1e-3)  # the clamp depends on the batch


@pytest.mark.parametrize("with_lengths", [False, True])
def test_embed_matches_jax(sd, with_lengths):
    """The speechbrain-layout state dict through the JAX converter + `embed`
    and through the port's strict load + `embed`: within 1e-4 relative."""
    model = ecapa.ecapa_from_state_dict(sd, device="cpu")
    params = jecapa.ecapa_params_from_torch_state_dict(sd)
    fb = np.random.default_rng(2).standard_normal((3, 50, 80)).astype(np.float32)
    lengths = np.array([50, 31, 12], np.int32) if with_lengths else None
    got = ecapa.embed(model, torch.from_numpy(fb), None if lengths is None else torch.from_numpy(lengths))
    want = jecapa.embed(params, jnp.asarray(fb), None if lengths is None else jnp.asarray(lengths))
    assert got.shape == (3, 16)
    assert _rel(got, want) <= 1e-4


def test_checkpoint_loads_strictly_and_scores_like_jax(sd, tmp_path):
    """`embedding_model.ckpt` read by both packages' loaders: the same
    embeddings and similarity; a missing key is refused."""
    path = tmp_path / "embedding_model.ckpt"
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}, path)
    model = ecapa.load_ecapa_checkpoint(str(path), device="cpu")
    assert not model.training
    audio = _clips(2, seconds=0.5, seed=3)
    want = jecapa.embed_audio(jecapa.load_ecapa_checkpoint(str(path)), audio)
    assert _rel(ecapa.embed_audio(model, audio), want) <= 1e-4
    sim = external.speaker_similarity(audio[0], audio[1], weights_path=str(path), device="cpu")
    jsim = jexternal.speaker_similarity(audio[0], audio[1], weights_path=str(path))
    assert abs(sim - jsim) <= 1e-4 and -1.0 <= sim <= 1.0
    assert external.speaker_similarity(audio[0], audio[1], native_params=model) == sim
    broken = {k: v for k, v in torch.load(path).items() if k != "fc.conv.bias"}
    torch.save(broken, tmp_path / "broken.ckpt")
    with pytest.raises(RuntimeError, match="Missing key"):
        ecapa.load_ecapa_checkpoint(str(tmp_path / "broken.ckpt"), device="cpu")


def test_batchnorm_uses_running_statistics(sd):
    """The encoder normalises with its running statistics in training mode too."""
    model = ecapa.ecapa_from_state_dict(sd, device="cpu")
    fb = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 40, 80)).astype(np.float32))
    want = model(fb)
    assert torch.equal(model.train()(fb), want)


def test_speaker_similarity_without_weights_needs_speechbrain(monkeypatch):
    monkeypatch.setitem(sys.modules, "speechbrain", None)
    monkeypatch.setitem(sys.modules, "speechbrain.inference", None)
    monkeypatch.setitem(sys.modules, "speechbrain.inference.speaker", None)
    audio = _clips(2, seconds=0.2)
    with pytest.raises(ImportError, match="speaker similarity needs ECAPA weights"):
        external.speaker_similarity(audio[0], audio[1])


@pytest.mark.parametrize("masked", [False, True])
def test_reference_encoder_matches_jax(masked):
    """JAX init -> `reference_encoder_state_dict_from_jax` -> the port: within
    1e-5 of max(1, max |JAX|), with and without an attention mask."""
    kw = dict(input_channels=6, output_channels=10, residual_channels=16, residual_layers=3, dilation_cycle=2,
              num_heads=4, latent_len=3)
    x = np.random.default_rng(5).standard_normal((2, 19, 6)).astype(np.float32)
    mask = np.arange(19)[None, :] < np.array([[19], [11]]) if masked else None
    jmodel = JaxReferenceEncoder(**kw)
    params = init_params(jmodel, 0, jnp.zeros((1, 19, 6)))
    port = ReferenceEncoder(**kw).eval()
    port.load_state_dict(reference_encoder_state_dict_from_jax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), None if mask is None else jnp.asarray(mask)))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
    assert np.abs(want).max() > 1e-2
