"""The codec zoo of the PyTorch port against the JAX package: SEANet /
SpeechTokenizer / EnCodec (`models/seanet.py`), Firefly (`models/firefly.py`)
and the adapters of `eval/codecs.py`.

The port's modules carry the original packages' parameter names, so each
test builds the port's module with seeded random weights and hands its
`state_dict()` to the JAX package's own torch-checkpoint converter
(`speechtokenizer_params_from_torch`, `firefly_architecture_params_from_torch`):
both sides then run on the same weights and inputs, float32 on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_codec_tpu.eval import codecs as jax_codecs
from dmel_codec_tpu.models import firefly as jfire
from dmel_codec_tpu.models import seanet as jsea
from dmel_codec_tpu_torch.eval import codecs
from dmel_codec_tpu_torch.models import firefly, seanet
from tests.test_torch_support import strict_f32  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("strict_f32")

# Latents and audio: the same float32 convolutions and LSTM recurrences in
# another summation order, ~1e-7 relative per op through ~20 layers
# (measured <= 7e-7 of max |x|): 1e-4 of max(1, max |JAX|).
TOL = 1e-4


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


def _np_sd(module: torch.nn.Module) -> dict:
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


# ---- SEANet: SpeechTokenizer and EnCodec ------------------------------------------

SEANET_KW = {
    "speechtokenizer": dict(n_filters=4, dimension=16, ratios=(4, 2), lstm_layers=2, n_q=4, codebook_size=32,
                            semantic_dimension=8),
    "encodec": dict(n_filters=4, dimension=16, ratios=(4, 2), lstm_layers=1, n_q=4, codebook_size=32),
}


def _seanet(kind: str, seed: int = 0):
    """(port model, its config, JAX model, JAX params) on the same weights."""
    kw = SEANET_KW[kind]
    cfg = seanet.SEANetConfig(**kw) if kind == "speechtokenizer" else seanet.SEANetConfig.encodec_24k(**kw)
    torch.manual_seed(seed)
    model = seanet.SpeechTokenizer(cfg).eval()
    jcfg = jsea.SEANetConfig(**dataclasses.asdict(cfg))
    return model, cfg, jsea.SpeechTokenizer(config=jcfg), jsea.speechtokenizer_params_from_torch(_np_sd(model), jcfg)


def _japply(jmodel, params, method, *args):
    return np.asarray(jmodel.apply({"params": params}, *[jnp.asarray(a) for a in args], method=method))


@pytest.mark.parametrize("kind", sorted(SEANET_KW))
@pytest.mark.parametrize("length", [83, 3], ids=["ragged", "shorter-than-reflect-pad"])
def test_seanet_matches_jax(kind, length):
    """Latents within 1e-4, codes equal, decoded audio within 1e-4; the length
    is no multiple of the hop (8), and 3 samples are fewer than conv_in's
    reflect pad (3 a side: `_pad1d`'s zero extension)."""
    model, cfg, jmodel, params = _seanet(kind)
    assert cfg.causal == (kind == "encodec") and cfg.bidirectional == (kind == "speechtokenizer")
    x = (0.3 * np.random.default_rng(1).standard_normal((2, length))).astype(np.float32)
    with torch.no_grad():
        z = model.encode_unquantized(torch.from_numpy(x))
        codes = model.encode(torch.from_numpy(x))
    _close(z, _japply(jmodel, params, jsea.SpeechTokenizer.encode_unquantized, x))
    want_codes = _japply(jmodel, params, jsea.SpeechTokenizer.encode, x)
    assert codes.shape == want_codes.shape == (cfg.n_q, 2, -(-length // cfg.hop_length))
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    with torch.no_grad():
        audio = model.decode(codes)
    _close(audio, _japply(jmodel, params, jsea.SpeechTokenizer.decode, want_codes))
    if kind == "speechtokenizer" and length > cfg.hop_length:
        with torch.no_grad():
            layers = model.forward_feature(torch.from_numpy(x), 2)
            sem = model.semantic_features(torch.from_numpy(x))
        _close(layers, np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), 2,
                                               method=jsea.SpeechTokenizer.forward_feature)))
        _close(sem, _japply(jmodel, params, jsea.SpeechTokenizer.semantic_features, x))


def test_bidirectional_slstm_matches_jax():
    """SpeechTokenizer's SLSTM: two bidirectional layers, [fwd ⊕ bwd] plus
    the input twice; torch's LSTM against the JAX scan on torch's weights."""
    torch.manual_seed(3)
    port = seanet.SLSTM(6, num_layers=2, bidirectional=True).eval()
    params = {k.split(".", 1)[1]: v for k, v in _np_sd(port).items()}
    x = np.random.default_rng(2).standard_normal((2, 6, 13)).astype(np.float32)  # [B, C, T]
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    want = jsea.SLSTM(6, 2, bidirectional=True).apply({"params": params}, jnp.asarray(x.transpose(0, 2, 1)))
    assert got.shape == (2, 12, 13)
    _close(got.numpy().transpose(0, 2, 1), want, 1e-5)


def test_load_speechtokenizer_reads_a_package_checkpoint(tmp_path):
    """config.json + a `.pt` of the package's names: the port's strict load and
    the JAX loader read the same file and give the same codes and audio."""
    (tmp_path / "config.json").write_text(json.dumps({
        "sample_rate": 16000, "n_filters": 4, "dimension": 16, "strides": [4, 2], "lstm_layers": 1,
        "bidirectional": True, "n_q": 3, "codebook_size": 16, "semantic_dimension": 8,
    }))
    torch.manual_seed(4)
    saved = seanet.SpeechTokenizer(seanet.SEANetConfig.from_json(str(tmp_path / "config.json")))
    torch.save(saved.state_dict(), tmp_path / "SpeechTokenizer.pt")
    model, cfg = seanet.load_speechtokenizer(str(tmp_path / "config.json"), str(tmp_path / "SpeechTokenizer.pt"))
    jmodel, params, jcfg = jsea.load_speechtokenizer(str(tmp_path / "config.json"), str(tmp_path / "SpeechTokenizer.pt"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    x = (0.3 * np.random.default_rng(5).standard_normal((1, 50))).astype(np.float32)
    with torch.no_grad():
        codes = model.encode(torch.from_numpy(x))
        audio = model.decode(codes)
    want = _japply(jmodel, params, jsea.SpeechTokenizer.encode, x)
    np.testing.assert_array_equal(codes.numpy(), want)
    _close(audio, _japply(jmodel, params, jsea.SpeechTokenizer.decode, want))
    sd = saved.state_dict()
    sd.pop("quantizer.vq.layers.0._codebook.embed")
    torch.save(sd, tmp_path / "broken.pt")
    with pytest.raises(RuntimeError, match="Missing key"):
        seanet.load_speechtokenizer(str(tmp_path / "config.json"), str(tmp_path / "broken.pt"))


# ---- Firefly ----------------------------------------------------------------------


def _fish_config(mod):
    """A small FireflyArchitectureConfig of `mod` (port or JAX module)."""
    return mod.FireflyArchitectureConfig(
        sample_rate=1024, n_fft=64, hop_length=16, n_mels=20,
        backbone=mod.ConvNeXtEncoderConfig(input_channels=20, depths=(1, 1), dims=(16, 24)),
        head=mod.HiFiGANConfig(hop_length=16, upsample_rates=(4, 2, 2), upsample_kernel_sizes=(8, 4, 4),
                               resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 2)),
                               num_mels=24, upsample_initial_channel=16, use_template=False,
                               pre_conv_kernel_size=7, post_conv_kernel_size=7),
        fsq_input_dim=24, fsq_groups=4, fsq_codebooks=1, fsq_levels=(7, 5, 5), fsq_downsample=(2, 2))


@pytest.fixture(scope="module")
def fish():
    """(port model, JAX model, JAX params) on the same weights; the ConvNeXt
    layer scales spread around 1 (their init, 1e-6, would hide the blocks)."""
    torch.manual_seed(0)
    model = firefly.FireflyArchitecture(_fish_config(firefly)).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("gamma"):
                p.copy_(1 + 0.05 * torch.randn_like(p))
    jcfg = _fish_config(jfire)
    params = jfire.firefly_architecture_params_from_torch(_np_sd(model), jcfg)
    return model, jfire.FireflyArchitecture(config=jcfg), params


def test_firefly_matches_jax(fish):
    """Codes equal, audio within 1e-4 of max(1, max |JAX|); zeros past the
    lengths (features past the mel lengths, audio past feature_lengths *
    factor * hop). The features are held to the JAX ones through the
    adapter's `get_latent` below."""
    model, jmodel, params = fish
    sr = model.config.sample_rate
    x = (0.3 * np.random.default_rng(0).standard_normal((2, 2 * sr + 37))).astype(np.float32)
    lens = np.array([2 * sr + 37, sr - 5], np.int32)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lens)
    with torch.no_grad():
        idx, flen = model.encode(xt, lt)
        feats, mel_len = model.encode_unquantized(xt, lt)
        audio, alen = model.decode(idx, flen)
    jidx, jflen = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(lens),
                               method=jfire.FireflyArchitecture.encode)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(flen.numpy(), np.asarray(jflen))
    jaudio, jalen = jmodel.apply({"params": params}, jidx, jflen, method=jfire.FireflyArchitecture.decode)
    _close(audio, jaudio)
    np.testing.assert_array_equal(alen.numpy(), np.asarray(jalen))
    assert np.abs(np.asarray(jaudio)).max() > 1e-3
    assert (feats[1, int(mel_len[1]):] == 0).all()
    assert (audio[1, int(alen[1]):] == 0).all() and (audio[1, : int(alen[1])] != 0).any()


def test_hifigan_template_matches_jax():
    """`use_template`: each stage adds a strided conv of the template signal."""
    cfg = dict(hop_length=8, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 3),), num_mels=6, upsample_initial_channel=8, use_template=True)
    torch.manual_seed(5)
    gen = firefly.HiFiGANGenerator(firefly.HiFiGANConfig(**cfg)).eval()
    jcfg = jfire.HiFiGANConfig(**cfg)
    params = jfire.hifigan_params_from_torch(_np_sd(gen), jcfg)
    rng = np.random.default_rng(6)
    mel = rng.standard_normal((2, 6, 9)).astype(np.float32)
    template = rng.standard_normal((2, 1, 72)).astype(np.float32)
    with torch.no_grad():
        got = gen(torch.from_numpy(mel), torch.from_numpy(template))
    want = jfire.HiFiGANGenerator(jcfg).apply({"params": params}, jnp.asarray(mel.transpose(0, 2, 1)),
                                              jnp.asarray(template.transpose(0, 2, 1)))
    _close(got, want)


# ---- adapters ---------------------------------------------------------------------


def test_registry_keys_match_jax():
    assert set(codecs.CODEC_REGISTRY) == set(jax_codecs.CODEC_REGISTRY)
    with pytest.raises(KeyError):
        codecs.make_codec("nope")


def _adapter_pairs(fish):
    model, _, params = fish
    pairs = [("fishspeech", codecs.make_codec("fishspeech", model, device="cpu"),
              jax_codecs.FishSpeechAdapter(params=params, config=_fish_config(jfire)))]
    for kind in ("speechtokenizer", "encodec"):
        port_model, _, jmodel, jparams = _seanet(kind)
        port = codecs.make_codec(kind, port_model, num_quantizers=3, device="cpu")
        want = jax_codecs.make_codec(kind, params=jparams, config=jmodel.config, num_quantizers=3)
        pairs.append((kind, port, want))
    return pairs


def test_native_adapters_match_jax(fish):
    """Each native adapter's encode / decode / get_latent against the JAX
    adapter's on the carried-over weights: shapes, lengths and codes equal,
    audio and latents within 1e-4."""
    for kind, port, want in _adapter_pairs(fish):
        sr = port.sample_rate
        assert sr == want.sample_rate
        t = sr // 4 if kind == "fishspeech" else 8 * 25 + 3
        x = (0.3 * np.random.default_rng(7).standard_normal((2, t))).astype(np.float32)
        lens = np.array([t, t // 2])
        idx, ilen = port.encode(x, lens)
        jidx, jilen = want.encode(x, lens)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(ilen, jilen)
        wav, mel = port.decode(idx, ilen)
        jwav, jmel = want.decode(jidx, jilen)
        assert mel is None and jmel is None
        _close(wav, jwav)
        _close(port.get_latent(x, lens), want.get_latent(x, lens))
        assert port.rec_audio_from_audio(x, lens).shape == want.rec_audio_from_audio(x, lens).shape
        if kind != "fishspeech":
            _close(port.get_latent_quantized(x), want.get_latent_quantized(x))


def test_adapters_draw_seeded_weights():
    """`model=None`: random weights from `seed`, the same for the same seed,
    and the global generator left as it was."""
    state = torch.random.get_rng_state()
    kw = dict(config=seanet.SEANetConfig(**SEANET_KW["speechtokenizer"]), device="cpu")
    a, b = codecs.SpeechTokenizerAdapter(seed=3, **kw), codecs.SpeechTokenizerAdapter(seed=3, **kw)
    c = codecs.SpeechTokenizerAdapter(seed=4, **kw)
    assert torch.equal(torch.random.get_rng_state(), state)
    sa, sb, sc = a.model.state_dict(), b.model.state_dict(), c.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa) and not all(torch.equal(sa[k], sc[k]) for k in sa)
    fish = codecs.FishSpeechAdapter(config=_fish_config(firefly), seed=3, device="cpu")
    assert fish.config.codebook_size == 7 * 5 * 5 and fish.model.training is False


def _tiny_dac_config():
    from transformers import DacConfig

    return DacConfig(encoder_hidden_size=8, downsampling_ratios=[2, 4], decoder_hidden_size=8, n_codebooks=3,
                     codebook_size=32, codebook_dim=4, sampling_rate=16000)


def test_dac_adapter_roundtrip():
    """The DAC adapter on a tiny random-init transformers DacModel, as the
    JAX package's test drives it."""
    pytest.importorskip("transformers")
    rng = np.random.default_rng(8)
    codec = codecs.make_codec("dac", config=_tiny_dac_config(), num_quantizers=2, device="cpu")
    hop = 8
    t = hop * 20
    x = np.stack([rng.standard_normal(t), rng.standard_normal(t) * 0.5]).astype(np.float32) * 0.3
    idx, lens = codec.encode(x, np.array([t, t // 2]))
    assert idx.shape[:2] == (2, 2)
    assert int(lens[1]) == (t // 2 + hop - 1) // hop
    wav, _ = codec.decode(idx)
    assert wav.shape[0] == 2 and wav.shape[1] >= t - hop
    assert codec.rec_audio_from_audio(x).shape[0] == 2
    z = codec.get_latent(x)
    assert z.shape[0] == 2 and z.shape[2] == t // hop


def test_mimi_adapter_roundtrip():
    """The Mimi adapter on a tiny random-init transformers MimiModel."""
    pytest.importorskip("transformers")
    from transformers import MimiConfig

    cfg = MimiConfig(hidden_size=16, num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
                     intermediate_size=32, num_filters=4, num_residual_layers=1, upsampling_ratios=[4, 2],
                     codebook_size=32, codebook_dim=8, vector_quantization_hidden_dimension=8, num_quantizers=4,
                     num_semantic_quantizers=1, sliding_window=4, upsample_groups=16)
    codec = codecs.make_codec("mimi", config=cfg, num_quantizers=3, device="cpu")
    hop = codec.hop_length
    t = hop * 6
    x = (0.3 * np.random.default_rng(9).standard_normal((2, t))).astype(np.float32)
    idx, lens = codec.encode(x, np.array([t, t // 2]))
    assert idx.shape[0] == 2 and idx.shape[1] == 3 and int(lens[0]) == idx.shape[2]
    wav, _ = codec.decode(idx, lens)
    assert wav.shape == (2, idx.shape[2] * hop)
    assert codec.rec_audio_from_audio(x, np.array([t, t])).shape == x.shape
    assert codec.get_latent(x).shape[0] == 2


@pytest.mark.parametrize("name", ["dac", "mimi"])
def test_hf_adapters_raise_without_transformers(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match=f"codec '{name}' needs transformers"):
        codecs.make_codec(name, device="cpu")


def test_harness_reports_fishspeech_entropy(fish):
    """The port's FireflyArchitectureConfig carries `codebook_size` (the FSQ
    levels' product), which the harness's entropy column reads; the JAX
    config has none, so the JAX harness raises there (ROADMAP.md §3)."""
    from dmel_codec_tpu_torch.eval.evaluation import Evaluation
    from dmel_codec_tpu_torch.eval.metrics import codebook_usage_entropy

    assert not hasattr(jfire.FireflyArchitectureConfig(), "codebook_size")
    adapter = codecs.make_codec("fishspeech", fish[0], device="cpu")
    x = (0.3 * np.random.default_rng(10).standard_normal((2, 2048))).astype(np.float32)
    batch = {"audios": x, "audio_lengths": np.array([2048, 1500]), "texts": ["", ""]}
    got = Evaluation(adapter, compute_pesq=False, device="cpu").run([batch]).means
    want = np.mean(codebook_usage_entropy(adapter.encode(x, batch["audio_lengths"])[0], 7 * 5 * 5))
    assert got["codebook_entropy_mean"] == pytest.approx(want) and {"si_snr", "mel_l1"} <= set(got)
