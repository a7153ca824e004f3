"""The PyTorch port's evaluation against the JAX package: the copied numpy
metrics and native PESQ (bit for bit), the torch mel L1, the `Evaluation`
harness on a small dMel codec + BigVGAN (weights carried over through
`convert.py`, the decoder noise patched to the JAX adapter's draws), and
`cli.evaluate.main` on the CPU.
"""

from __future__ import annotations

import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile
from scipy.signal import butter, sosfilt

from dmel_codec_tpu.eval import ecapa as jecapa
from dmel_codec_tpu.eval import metrics as jmetrics
from dmel_codec_tpu.eval import pesq_native as jpesq
from dmel_codec_tpu.eval.codecs import DMelCodecAdapter as JaxDMelCodecAdapter
from dmel_codec_tpu.eval.evaluation import Evaluation as JaxEvaluation
from dmel_codec_tpu.models.bigvgan import BigVGANConfig as JaxBigVGANConfig
from dmel_codec_tpu.models.codec import DMelCodecConfig as JaxDMelCodecConfig
from dmel_codec_tpu_torch.cli import evaluate
from dmel_codec_tpu_torch.eval import ecapa, metrics, pesq_native
from dmel_codec_tpu_torch.eval.codecs import DMelCodecAdapter
from dmel_codec_tpu_torch.eval.evaluation import Evaluation
from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
from tests.test_ecapa import _synthetic_speechbrain_sd
from tests.test_torch_support import CODEC_KW, build_codec, init_params, strict_f32  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("strict_f32")

SR = 24000
# A vocoder of the small codec's 20 mels whose upsampling is the codec's hop
# (4^4 = 256), so that the waveform columns compare clips of equal length.
VOCODER_KW = dict(num_mels=20, upsample_initial_channel=32, upsample_rates=(4, 4, 4, 4),
                  upsample_kernel_sizes=(8, 8, 8, 8))


def _speechlike(seconds: float, f0: float, seed: int) -> np.ndarray:
    """An amplitude-modulated harmonic tone with a gliding pitch, over a
    little noise: structure for STOI and the pitch tracker."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    pitch = f0 + 0.25 * f0 * np.sin(2 * np.pi * 2.0 * t)
    phase = 2 * np.pi * np.cumsum(pitch) / SR
    x = sum(np.sin(k * phase) / k for k in range(1, 5)) * 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t - np.pi / 2))
    return (0.3 * x + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def _pairs():
    """(name, target, estimate) at 24 kHz: clean, noisy, delayed, band-limited."""
    x = _speechlike(1.2, 140.0, 0)
    noise = np.random.default_rng(1).standard_normal(x.size).astype(np.float32)
    delayed = np.concatenate([np.zeros(240, np.float32), x[:-240]])
    lowpass = sosfilt(butter(6, 2000 / (SR / 2), output="sos"), x).astype(np.float32)
    return [("clean", x, x.copy()), ("noisy", x, x + 0.05 * noise), ("delayed", x, delayed),
            ("band-limited", x, lowpass)]


PAIRS = _pairs()
COPIED = {
    "si_snr": lambda m, g, e: m.si_snr(g, e),
    "stoi": lambda m, g, e: m.stoi(g, e, SR),
    "f0_corr": lambda m, g, e: m.f0_corr(g, e, SR),
    "detect_f0": lambda m, g, e: m.detect_f0(e, SR),
}


@pytest.mark.parametrize("metric", sorted(COPIED))
@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
def test_copied_metrics_are_the_jax_bits(metric, pair):
    _, g, e = pair
    got, want = COPIED[metric](metrics, g, e), COPIED[metric](jmetrics, g, e)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.all(np.isfinite(got)) or metric == "f0_corr"


@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
def test_native_pesq_is_the_jax_bits(pair):
    """pesq_wb (and its raw score) at 16 kHz, as the harness calls it."""
    from scipy.signal import resample_poly

    _, g, e = pair
    g16, e16 = resample_poly(g, 2, 3), resample_poly(e, 2, 3)
    assert pesq_native.pesq_wb_raw(g16, e16) == jpesq.pesq_wb_raw(g16, e16)
    assert pesq_native.pesq_wb(g16, e16) == jpesq.pesq_wb(g16, e16)
    with pytest.raises(ValueError):
        pesq_native.pesq_wb(g16, e16, sample_rate=24000)


def test_wer_and_entropy_are_the_jax_values():
    refs = ["Hello, WORLD!", "the cat sat on the mat", "a b c d", "一 二 三"]
    hyps = ["hello world", "the cat sat mat", "", "一 三 三"]
    assert metrics.wer(refs, hyps) == jmetrics.wer(refs, hyps)
    assert metrics.wer(refs, hyps, clean=False) == jmetrics.wer(refs, hyps, clean=False)
    assert [metrics.clean_text(r) for r in refs] == [jmetrics.clean_text(r) for r in refs]
    codes = np.random.default_rng(2).integers(0, 175, (3, 4, 40))
    mask = np.random.default_rng(3).random((3, 40)) > 0.3
    assert metrics.codebook_usage_entropy(codes, 175) == jmetrics.codebook_usage_entropy(codes, 175)
    assert metrics.codebook_usage_entropy(codes, 175, mask) == jmetrics.codebook_usage_entropy(codes, 175, mask)


class _FakeASR:
    """A stand-in for WhisperASR: the transcript depends on the clip's energy."""

    def transcribe(self, audios_16k):
        return ["hello world" if float(np.square(a).mean()) > 0.01 else "hello there" for a in audios_16k]


def test_external_entry_points_match_jax(monkeypatch):
    """pesq_wb_16k (the native PESQ: no `pesq` package here) and asr_wer
    against the JAX ones; WhisperASR and pesq's import guards."""
    from dmel_codec_tpu.eval import external as jexternal
    from scipy.signal import resample_poly

    from dmel_codec_tpu_torch.eval import external

    _, g, e = PAIRS[1]
    g16, e16 = resample_poly(g, 2, 3), resample_poly(e, 2, 3)
    assert external.pesq_wb_16k(g16, e16) == jexternal.pesq_wb_16k(g16, e16)
    texts = ["hello world", "hello world"]
    args = ([g16, 0.01 * g16], [e16, e16], texts)
    assert external.asr_wer(_FakeASR(), *args) == jexternal.asr_wer(_FakeASR(), *args) == (0.25, 0.0)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers is required"):
        external.WhisperASR("whisper-dir", device="cpu")


@pytest.mark.parametrize("pair", PAIRS[1:], ids=[p[0] for p in PAIRS[1:]])
def test_mel_l1_matches_jax(pair):
    """The torch log-mel L1 within 1e-5 relative of the JAX one (float32
    FFTs and sums in another order)."""
    _, g, e = pair
    got = metrics.mel_l1_distance(g, e[:-7], SR, device="cpu")
    want = jmetrics.mel_l1_distance(g, e[:-7], SR)
    assert got == pytest.approx(want, rel=1e-5)
    assert metrics.mel_l1_distance(g, g, SR, device="cpu") == 0.0


# ---- the harness ------------------------------------------------------------------


class _JaxNoise:
    """The noise the JAX adapter draws for each decode, in order (seed 0)."""

    def __init__(self, seed: int = 0):
        self.rng = jax.random.PRNGKey(seed)

    def __call__(self, shape) -> torch.Tensor:
        self.rng, k = jax.random.split(self.rng)
        return torch.from_numpy(np.array(jax.random.normal(k, shape, dtype=jnp.float32)))


@pytest.fixture(scope="module")
def models():
    """(JAX codec params, JAX vocoder params, port codec, port vocoder) on the
    same weights."""
    from dmel_codec_tpu.models.bigvgan import BigVGAN as JaxBigVGAN

    from dmel_codec_tpu_torch.convert import bigvgan_state_dict_from_jax

    _, cparams, codec = build_codec()
    vparams = init_params(JaxBigVGAN(config=JaxBigVGANConfig(**VOCODER_KW)), 1, jnp.zeros((1, 8, 20)))
    vocoder = BigVGAN(BigVGANConfig(**VOCODER_KW))
    vocoder.load_state_dict(bigvgan_state_dict_from_jax(vparams, vocoder.config))
    return cparams, vparams, codec, vocoder.eval()


def _batches():
    """Two batches of two clips padded to 0.8 s, the second of each shorter."""
    out = []
    for b in range(2):
        audios = np.zeros((2, int(0.8 * SR)), np.float32)
        lengths = np.array([int(0.8 * SR), int((0.6 - 0.1 * b) * SR)])
        for i in range(2):
            audios[i, : lengths[i]] = _speechlike(lengths[i] / SR, 120.0 + 60 * (2 * b + i), 10 + b)
        out.append({"audios": audios, "audio_lengths": lengths, "texts": ["hello world", "hello there"]})
    return out


def _adapters(models, monkeypatch, vocoder: bool):
    cparams, vparams, codec, port_vocoder = models
    jax_adapter = JaxDMelCodecAdapter(cparams, JaxDMelCodecConfig(**CODEC_KW), vparams if vocoder else None,
                                      JaxBigVGANConfig(**VOCODER_KW))
    noise = _JaxNoise()
    monkeypatch.setattr(DMelCodecAdapter, "_noise", lambda self, shape: noise(shape))
    return jax_adapter, DMelCodecAdapter(codec, port_vocoder if vocoder else None)


# Harness columns, port against JAX on the same clips, weights and noise.
# The waveforms differ by the vocoders' float32 sums in another order
# (<= 2e-4 of the waveform's peak on such models, tests/test_torch_lm_generate.py);
# measured on these clips (per batch and mean): si_snr 7.7e-6 dB, mel_l1
# 1.9e-6, stoi 1.0e-7, f0_corr 0 (the same voiced frames), pesq 2.2e-7,
# spk_sim 2.6e-7. Tolerances 40x or more above: absolute, in each column's unit.
HARNESS_TOL = {"si_snr": 1e-3, "mel_l1": 1e-4, "stoi": 1e-5, "f0_corr": 1e-5, "pesq": 1e-4, "spk_sim": 1e-5,
               "wer_gt": 0.0, "wer_rec": 0.0}


@pytest.mark.parametrize("vocoder", [True, False], ids=["vocoder", "mel-domain"])
def test_evaluation_run_matches_jax(models, monkeypatch, vocoder):
    """`Evaluation.run` means and per-batch columns against the JAX harness
    (the ASR columns through a stand-in transcriber): the tokens and the
    entropy equal, the other columns within HARNESS_TOL (the WERs equal);
    without a vocoder both compare in the mel domain (mel_l1 only)."""
    jax_adapter, adapter = _adapters(models, monkeypatch, vocoder)
    batches = _batches()
    for batch in batches:  # the tokens first: the harness only sees their entropy
        np.testing.assert_array_equal(adapter.encode(batch["audios"], batch["audio_lengths"])[0],
                                      jax_adapter.encode(batch["audios"], batch["audio_lengths"])[0])
    got = Evaluation(adapter, asr=_FakeASR(), compute_pesq=vocoder, device="cpu").run(batches)
    want = JaxEvaluation(jax_adapter, asr=_FakeASR(), compute_pesq=vocoder).run(batches)
    waveform = {"si_snr", "stoi", "f0_corr", "pesq", "wer_gt", "wer_rec"}
    columns = {"codebook_entropy_mean", "mel_l1"} | (waveform if vocoder else set())
    assert set(got.means) == set(want.means) == columns
    for g, w in zip(got.per_batch + [got.means], want.per_batch + [want.means]):
        assert g["codebook_entropy_mean"] == w["codebook_entropy_mean"]
        for k in columns - {"codebook_entropy_mean"}:
            assert math.isfinite(g[k]) and abs(g[k] - w[k]) <= HARNESS_TOL[k], (k, g[k], w[k])


@pytest.mark.parametrize("how", ["spk_params", "spk_weights_path"])
def test_evaluation_speaker_similarity_matches_jax(models, monkeypatch, tmp_path, how):
    """The spk_sim column through a native ECAPA (speechbrain's layout at
    C = 32): given as a model / params, or as an `embedding_model.ckpt`."""
    jax_adapter, adapter = _adapters(models, monkeypatch, vocoder=True)
    sd = _synthetic_speechbrain_sd(np.random.default_rng(4))
    if how == "spk_params":
        port_kw = {"spk_params": ecapa.ecapa_from_state_dict(sd, device="cpu")}
        jax_kw = {"spk_params": jecapa.ecapa_params_from_torch_state_dict(sd)}
    else:
        torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}, tmp_path / "embedding_model.ckpt")
        port_kw = jax_kw = {"spk_weights_path": str(tmp_path / "embedding_model.ckpt")}
    batch = _batches()[:1]
    got = Evaluation(adapter, compute_pesq=False, device="cpu", **port_kw).run(batch).means
    want = JaxEvaluation(jax_adapter, compute_pesq=False, **jax_kw).run(batch).means
    assert -1.0 <= got["spk_sim"] <= 1.0
    assert abs(got["spk_sim"] - want["spk_sim"]) <= HARNESS_TOL["spk_sim"]


def test_evaluate_main_on_the_cpu(tmp_path, capsys):
    """`evaluate.main --device cpu` on two WAVs, a manifest and checkpoints
    written here prints the JSON of the means; with --max-batches 1 only the
    first batch counts."""
    with open(tmp_path / "test.jsonl", "w") as f:
        for i, seconds in enumerate((0.7, 0.5)):
            wavfile.write(tmp_path / f"clip{i}.wav", SR, _speechlike(seconds, 130.0 + 50 * i, i))
            f.write(json.dumps({"id": f"c{i}", "audio_path": str(tmp_path / f"clip{i}.wav"), "duration": seconds,
                                "text": ""}) + "\n")
    torch.manual_seed(0)
    CheckpointManager(str(tmp_path / "codec")).save(0, {"gen_params": DMelCodec(DMelCodecConfig(**CODEC_KW)).state_dict()})
    torch.save({"generator": BigVGAN(BigVGANConfig(**VOCODER_KW)).state_dict()}, tmp_path / "vocoder.pt")
    cfg = {"codec_ckpt_dir": str(tmp_path / "codec"), "vocoder_ckpt": str(tmp_path / "vocoder.pt"),
           "test_manifest": str(tmp_path / "test.jsonl"), "max_duration": 1.0, "whisper_path": None,
           "compute_pesq": True, "compute_spk_sim": False, "model": CODEC_KW,
           "vocoder": {k: list(v) if isinstance(v, tuple) else v for k, v in VOCODER_KW.items()}}
    (tmp_path / "eval.yaml").write_text(yaml.safe_dump(cfg))
    evaluate.main(["--config", str(tmp_path / "eval.yaml"), "--device", "cpu"])
    means = json.loads(capsys.readouterr().out)
    assert set(means) == {"si_snr", "mel_l1", "stoi", "f0_corr", "codebook_entropy_mean", "pesq"}
    assert all(math.isfinite(v) for v in means.values())
    evaluate.main(["--config", str(tmp_path / "eval.yaml"), "--device", "cpu", "--max-batches", "1"])
    first = json.loads(capsys.readouterr().out)
    assert set(first) == set(means) and first != means  # max_duration 1.0 s: one clip a batch
