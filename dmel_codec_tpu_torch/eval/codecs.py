"""Uniform codec adapter API (the reference's codec zoo): a port of
`dmel_codec_tpu/eval/codecs.py`.

One numpy-in / numpy-out facade per codec: encode / decode /
rec_audio_from_audio / latent extraction. 'dmel', 'fishspeech',
'speechtokenizer' and 'encodec' are this package's modules (DMelCodec +
BigVGAN, models/firefly.py, models/seanet.py), on a `device` (default
cuda); 'dac' and 'mimi' wrap HF transformers' DacModel / MimiModel, as the
JAX package does, and raise ImportError where transformers is missing.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from dmel_codec_tpu_torch.dsp.spectrogram import LogMelSpectrogram
from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, FusedBigVGAN
from dmel_codec_tpu_torch.models.codec import DMelCodec
from dmel_codec_tpu_torch.models.firefly import FireflyArchitecture, FireflyArchitectureConfig
from dmel_codec_tpu_torch.models.seanet import SEANetConfig, SpeechTokenizer, load_speechtokenizer


def _seeded(build: Callable[[], torch.nn.Module], seed: int) -> torch.nn.Module:
    """`build()` with its random init drawn from `seed`, leaving the global
    generator as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


class DMelCodecAdapter:
    """numpy-in/numpy-out facade over DMelCodec (+ optional BigVGAN, run in
    its serving form).

    The modules are used where and as they are (device, dtype): a bfloat16
    codec must carry `compute_dtype="bfloat16"` in its config. The mel front
    end stays float32."""

    name = "dmel"

    def __init__(self, codec: DMelCodec, vocoder: Optional[BigVGAN] = None, seed: int = 0):
        self.codec = codec.eval()
        self.config = codec.config
        p = next(codec.parameters())
        self.device, self.dtype = p.device, p.dtype
        self.mel_tf = LogMelSpectrogram(
            sample_rate=self.config.sample_rate,
            hop_length=self.config.hop_length,
            n_mels=self.config.n_mels,
        ).to(self.device)
        self.vocoder = None if vocoder is None else FusedBigVGAN(vocoder.eval())
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    def _noise(self, shape: Tuple[int, ...]) -> torch.Tensor:
        """The decoder's driving noise, from the adapter's own generator."""
        return torch.randn(shape, generator=self._generator, device=self.device, dtype=self.dtype)

    def _mels(self, audio: np.ndarray, audio_lengths=None) -> Tuple[torch.Tensor, torch.Tensor]:
        audio = np.atleast_2d(np.asarray(audio, np.float32))
        mels = self.mel_tf(torch.from_numpy(audio).to(self.device)).to(self.dtype)
        f = self.config.downsample_total
        t = (mels.shape[1] // f) * f
        if audio_lengths is None:
            lengths = torch.full((audio.shape[0],), t, dtype=torch.int32, device=self.device)
        else:
            # per-sample valid frames, floored to the downsample factor so
            # batch zero-padding is never tokenized as audio
            lengths = torch.as_tensor(np.asarray(audio_lengths), device=self.device) // self.config.hop_length
            lengths = ((lengths // f) * f).clamp(max=t).to(torch.int32)
        return mels[:, :t], lengths

    @torch.no_grad()
    def encode(self, audio: np.ndarray, audio_lengths=None) -> Tuple[np.ndarray, np.ndarray]:
        """audio [B, T] (+ per-sample sample counts) ->
        (indices [B, G*R, L], index lengths [B])."""
        idx, idx_len = self.codec.encode(*self._mels(audio, audio_lengths))
        return idx.cpu().numpy(), idx_len.cpu().numpy()

    @torch.no_grad()
    def decode(
        self, indices: np.ndarray, lengths: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """indices -> (audio [B, T] (zeros if no vocoder), mel [B, F, M])."""
        indices = torch.as_tensor(np.asarray(indices), dtype=torch.long, device=self.device)
        b, _, n = indices.shape
        if lengths is None:
            lengths = torch.full((b,), n, dtype=torch.int32, device=self.device)
        else:
            lengths = torch.as_tensor(np.asarray(lengths), device=self.device)
        noise = self._noise((b, n * self.config.downsample_total, self.config.concat_dim))
        mel = self.codec.decode(indices, lengths, noise)
        mel_np = mel.float().cpu().numpy()
        if self.vocoder is None:
            return np.zeros((b, 0), np.float32), mel_np
        return self.vocoder(mel).float().cpu().numpy(), mel_np

    def rec_audio_from_audio(self, audio: np.ndarray, audio_lengths=None) -> np.ndarray:
        idx, lengths = self.encode(audio, audio_lengths)
        return self.decode(idx, lengths)[0]

    @torch.no_grad()
    def get_latent(self, audio: np.ndarray, audio_lengths=None) -> np.ndarray:
        """Unquantized encoder features [B*G, T, res]."""
        feats, _ = self.codec.encode_unquantized(*self._mels(audio, audio_lengths))
        return feats.float().cpu().numpy()


class FishSpeechAdapter:
    """numpy-in/numpy-out facade over the FireflyArchitecture codec.

    Mirrors the reference's fish_speech paths in initial_codec.py:
    extract_indices (:107-110), rec_audio_from_indices (:213-215),
    rec_audio_from_audio (:241-246), extract_latent_unquantized (:137-146).
    """

    name = "fishspeech"

    def __init__(self, model: Optional[FireflyArchitecture] = None, config: Optional[FireflyArchitectureConfig] = None,
                 seed: int = 0, device="cuda"):
        """model: a FireflyArchitecture (e.g. a fish-speech checkpoint loaded
        into one); None draws random weights from `seed` (API testing)."""
        if model is None:
            model = _seeded(lambda: FireflyArchitecture(config or FireflyArchitectureConfig()), seed)
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.config = model.config

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    def _audio_batch(self, audio, audio_lengths) -> Tuple[torch.Tensor, torch.Tensor]:
        audio = np.atleast_2d(np.asarray(audio, np.float32))
        if audio_lengths is None:
            lengths = np.full((audio.shape[0],), audio.shape[1], np.int32)
        else:
            lengths = np.asarray(audio_lengths, np.int32)
        return torch.from_numpy(audio).to(self.device), torch.from_numpy(lengths).to(self.device)

    @torch.no_grad()
    def encode(self, audio: np.ndarray, audio_lengths=None) -> Tuple[np.ndarray, np.ndarray]:
        """audio [B, T] -> (indices [B, G*R, L], feature lengths [B])."""
        idx, flen = self.model.encode(*self._audio_batch(audio, audio_lengths))
        return idx.cpu().numpy(), flen.cpu().numpy()

    @torch.no_grad()
    def decode(self, indices: np.ndarray, lengths: Optional[np.ndarray] = None) -> Tuple[np.ndarray, None]:
        """indices -> (audio [B, T], None): the fish path emits no mel."""
        indices = torch.as_tensor(np.asarray(indices), dtype=torch.long, device=self.device)
        if lengths is None:
            lengths = np.full((indices.shape[0],), indices.shape[2], np.int32)
        lengths = torch.as_tensor(np.asarray(lengths), device=self.device)
        wav, _ = self.model.decode(indices, lengths)
        return wav.float().cpu().numpy(), None

    def rec_audio_from_audio(self, audio: np.ndarray, audio_lengths=None) -> np.ndarray:
        idx, flen = self.encode(audio, audio_lengths)
        return self.decode(idx, flen)[0]

    @torch.no_grad()
    def get_latent(self, audio: np.ndarray, audio_lengths=None) -> np.ndarray:
        """Unquantized backbone features [B, F, D] (ref :137-146)."""
        feats, _ = self.model.encode_unquantized(*self._audio_batch(audio, audio_lengths))
        return feats.float().cpu().numpy()


class DacCodecAdapter:
    """numpy-in/numpy-out facade over a Descript-audio-codec model.

    The reference wraps the `dac` package (initial_codec.py:33-36); HF
    transformers' `DacModel` is the same architecture and weights
    (descript/dac_Nkhz), so this adapter gives the same surface: encode
    (:104-105), rec from indices via `quantizer.from_codes` + decode
    (:204-206), rec_audio_from_audio via forward (:234-235), unquantized
    latent via `codec.encoder` (:126-127).
    """

    name = "dac"

    def __init__(
        self,
        model_path: Optional[str] = None,
        config=None,
        num_quantizers: Optional[int] = None,
        device="cuda",
    ):
        """model_path: a local HF checkpoint directory (never fetched).
        config: a transformers.DacConfig for random-init (API tests)."""
        try:
            from transformers import DacConfig, DacModel
        except ImportError as e:
            raise ImportError("codec 'dac' needs transformers") from e
        if model_path is not None:
            self.model = DacModel.from_pretrained(model_path)
        else:
            self.model = DacModel(config or DacConfig())
        self.model.to(device).eval()
        self.config = self.model.config
        self.num_quantizers = num_quantizers
        self.device = device
        self.hop_length = int(np.prod(self.config.downsampling_ratios))

    @property
    def sample_rate(self) -> int:
        return int(self.config.sampling_rate)

    def _batch(self, audio: np.ndarray):
        audio = np.atleast_2d(np.asarray(audio, np.float32))
        return torch.from_numpy(audio[:, None, :]).to(self.device)

    def _code_lengths(self, audio_lengths, batch: int, frames: int) -> np.ndarray:
        if audio_lengths is None:
            return np.full((batch,), frames, np.int32)
        n = np.ceil(np.asarray(audio_lengths) / self.hop_length).astype(np.int32)
        return np.minimum(n, frames)

    def encode(self, audio: np.ndarray, audio_lengths=None) -> Tuple[np.ndarray, np.ndarray]:
        """audio [B, T] -> (codes [B, Q, L], code lengths [B])."""
        with torch.inference_mode():
            out = self.model.encode(self._batch(audio), n_quantizers=self.num_quantizers)
        codes = out.audio_codes.cpu().numpy()
        return codes, self._code_lengths(audio_lengths, codes.shape[0], codes.shape[2])

    def decode(
        self, indices: np.ndarray, lengths: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, None]:
        """codes [B, Q, L] -> (audio [B, T], None) — ref :204-206."""
        del lengths  # DAC decodes full code grids; caller trims by length
        with torch.inference_mode():
            codes = torch.from_numpy(np.asarray(indices)).long().to(self.device)
            quantized, _, _ = self.model.quantizer.from_codes(codes)
            wav = self.model.decode(quantized).audio_values
        return wav.squeeze(1).cpu().numpy(), None

    def rec_audio_from_audio(self, audio: np.ndarray, audio_lengths=None) -> np.ndarray:
        del audio_lengths
        with torch.inference_mode():
            out = self.model(self._batch(audio), n_quantizers=self.num_quantizers)
        return out.audio_values.squeeze(1).cpu().numpy()

    def get_latent(self, audio: np.ndarray, audio_lengths=None) -> np.ndarray:
        """Unquantized encoder features [B, D, L] (ref :126-127)."""
        del audio_lengths
        with torch.inference_mode():
            z = self.model.encoder(self._batch(audio))
        return z.cpu().numpy()


class MimiCodecAdapter:
    """numpy-in/numpy-out facade over Kyutai's Mimi codec.

    Same backend as the reference (HF transformers `MimiModel`,
    initial_codec.py:46-52): encode frames (:107-108), decode with an
    audio-length padding mask (:210-212, mask built :283-296), full
    round-trip via forward (:238-240), unquantized latent via
    encoder -> encoder_transformer -> downsample (:129-135).
    """

    name = "mimi"

    def __init__(
        self,
        model_path: Optional[str] = None,
        config=None,
        num_quantizers: Optional[int] = None,
        device="cuda",
    ):
        try:
            from transformers import MimiConfig, MimiModel
        except ImportError as e:
            raise ImportError("codec 'mimi' needs transformers") from e
        if model_path is not None:
            self.model = MimiModel.from_pretrained(model_path)
        else:
            self.model = MimiModel(config or MimiConfig())
        self.model.to(device).eval()
        self.config = self.model.config
        self.num_quantizers = num_quantizers
        self.device = device
        # samples per codec frame (frame_rate tokens/s at sampling_rate)
        self.hop_length = int(round(self.config.sampling_rate / self.config.frame_rate))

    @property
    def sample_rate(self) -> int:
        return int(self.config.sampling_rate)

    def _batch(self, audio: np.ndarray):
        audio = np.atleast_2d(np.asarray(audio, np.float32))
        return torch.from_numpy(audio[:, None, :]).to(self.device)

    def _padding_mask(self, audio_lengths, batch: int, samples: int):
        """[B, 1, T] bool validity mask — ref get_padding_mask_for_mimi."""
        if audio_lengths is None:
            return torch.ones((batch, 1, samples), dtype=torch.bool, device=self.device)
        mask = np.arange(samples)[None, :] < np.asarray(audio_lengths)[:, None]
        return torch.from_numpy(mask[:, None, :]).to(self.device)

    def encode(self, audio: np.ndarray, audio_lengths=None) -> Tuple[np.ndarray, np.ndarray]:
        """audio [B, T] -> (codes [B, Q, L], code lengths [B])."""
        a = self._batch(audio)
        with torch.inference_mode():
            out = self.model.encode(
                a,
                padding_mask=self._padding_mask(audio_lengths, a.shape[0], a.shape[2]),
                num_quantizers=self.num_quantizers,
            )
        codes = out.audio_codes.cpu().numpy()
        if audio_lengths is None:
            lens = np.full((codes.shape[0],), codes.shape[2], np.int32)
        else:
            lens = np.minimum(
                np.ceil(np.asarray(audio_lengths) / self.hop_length).astype(np.int32),
                codes.shape[2],
            )
        return codes, lens

    def decode(
        self, indices: np.ndarray, lengths: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, None]:
        """codes [B, Q, L] -> (audio [B, T], None) — ref :210-212."""
        codes = torch.from_numpy(np.asarray(indices)).long().to(self.device)
        mask = None
        if lengths is not None:
            mask = self._padding_mask(
                np.asarray(lengths) * self.hop_length,
                codes.shape[0],
                codes.shape[2] * self.hop_length,
            )
        with torch.inference_mode():
            wav = self.model.decode(codes, padding_mask=mask).audio_values
        return wav.squeeze(1).cpu().numpy(), None

    def rec_audio_from_audio(self, audio: np.ndarray, audio_lengths=None) -> np.ndarray:
        a = self._batch(audio)
        with torch.inference_mode():
            out = self.model(
                a,
                padding_mask=self._padding_mask(audio_lengths, a.shape[0], a.shape[2]),
                num_quantizers=self.num_quantizers,
            )
        return out.audio_values.squeeze(1).cpu().numpy()

    def get_latent(self, audio: np.ndarray, audio_lengths=None) -> np.ndarray:
        """Unquantized downsampled transformer features [B, D, L]
        (ref :129-135: encoder -> encoder_transformer -> downsample)."""
        del audio_lengths
        with torch.inference_mode():
            emb = self.model.encoder(self._batch(audio))
            h = self.model.encoder_transformer(emb.transpose(1, 2))[0].transpose(1, 2)
            z = self.model.downsample(h)
        return z.cpu().numpy()


class SpeechTokenizerAdapter:
    """numpy-in/numpy-out facade over SpeechTokenizer (models/seanet.py:
    SEANet encoder / decoder + 8-layer RVQ).

    Mirrors the reference's speechtokenizer paths: encode (initial_codec.py
    :101-103; the package returns codebook-first [Q, B, L], this adapter
    standardizes to [B, Q, L] like the others), decode (:204-205), encoder
    latent (:124), forward_feature sum (:161-166). Package checkpoints load
    via `config_json` + `ckpt_path` (`load_speechtokenizer`).
    """

    name = "speechtokenizer"

    def __init__(
        self,
        model: Optional[SpeechTokenizer] = None,
        config: Optional[SEANetConfig] = None,
        config_json: Optional[str] = None,
        ckpt_path: Optional[str] = None,
        num_quantizers: Optional[int] = None,
        seed: int = 0,
        device="cuda",
    ):
        """model: a SpeechTokenizer; else one from `config_json` (+ the weights
        of `ckpt_path`) or `config` (default SEANetConfig()), with random
        weights drawn from `seed` where no checkpoint gives them."""
        if model is None:
            if config_json is not None:
                model = _seeded(lambda: load_speechtokenizer(config_json, ckpt_path)[0], seed)
            else:
                model = _seeded(lambda: SpeechTokenizer(config or SEANetConfig()), seed)
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.config = model.config
        self.num_quantizers = num_quantizers

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    def _batch(self, audio, audio_lengths) -> Tuple[torch.Tensor, np.ndarray]:
        audio = np.atleast_2d(np.asarray(audio, np.float32))
        if audio_lengths is None:
            lens = np.full((audio.shape[0],), audio.shape[1], np.int64)
        else:
            lens = np.asarray(audio_lengths)
        frames = -(-lens // self.config.hop_length)  # ceil
        return torch.from_numpy(audio).to(self.device), frames.astype(np.int32)

    @torch.no_grad()
    def encode(self, audio: np.ndarray, audio_lengths=None) -> Tuple[np.ndarray, np.ndarray]:
        """audio [B, T] -> (codes [B, Q, L], code lengths [B])."""
        a, frames = self._batch(audio, audio_lengths)
        codes = self.model.encode(a, self.num_quantizers).transpose(0, 1).cpu().numpy()
        return codes, np.minimum(frames, codes.shape[2])

    @torch.no_grad()
    def decode(self, indices: np.ndarray, lengths: Optional[np.ndarray] = None) -> Tuple[np.ndarray, None]:
        del lengths
        codes = torch.as_tensor(np.asarray(indices), dtype=torch.long, device=self.device).transpose(0, 1)
        return self.model.decode(codes).float().cpu().numpy(), None

    def rec_audio_from_audio(self, audio: np.ndarray, audio_lengths=None) -> np.ndarray:
        idx, lens = self.encode(audio, audio_lengths)
        return self.decode(idx, lens)[0]

    @torch.no_grad()
    def get_latent(self, audio: np.ndarray, audio_lengths=None) -> np.ndarray:
        """Unquantized encoder features [B, L, D] (ref :124)."""
        a, _ = self._batch(audio, audio_lengths)
        return self.model.encode_unquantized(a).float().cpu().numpy()

    @torch.no_grad()
    def get_latent_quantized(self, audio: np.ndarray, audio_lengths=None) -> np.ndarray:
        """Summed per-layer quantized features (ref :161-166)."""
        a, _ = self._batch(audio, audio_lengths)
        return self.model.forward_feature(a, self.num_quantizers).sum(dim=0).float().cpu().numpy()


class EncodecAdapter(SpeechTokenizerAdapter):
    """EnCodec flavour of the same family (the reference's zoo docstring
    lists Encodec, initial_codec.py:6, but never implements it): causal
    convs, unidirectional LSTM, no semantic head. Defaults to the 24 kHz
    shape."""

    name = "encodec"

    def __init__(self, model: Optional[SpeechTokenizer] = None, config: Optional[SEANetConfig] = None,
                 num_quantizers: Optional[int] = None, seed: int = 0, device="cuda"):
        super().__init__(
            model=model,
            config=config or SEANetConfig.encodec_24k(),
            num_quantizers=num_quantizers,
            seed=seed,
            device=device,
        )


CODEC_REGISTRY: Dict[str, Callable] = {
    "dmel": DMelCodecAdapter,
    "dac": DacCodecAdapter,
    "speechtokenizer": SpeechTokenizerAdapter,
    "mimi": MimiCodecAdapter,
    "fishspeech": FishSpeechAdapter,
    "encodec": EncodecAdapter,
}


def make_codec(name: str, *args, **kwargs):
    if name not in CODEC_REGISTRY:
        raise KeyError(f"unknown codec '{name}'; have {sorted(CODEC_REGISTRY)}")
    return CODEC_REGISTRY[name](*args, **kwargs)
