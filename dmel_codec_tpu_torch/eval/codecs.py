"""Uniform codec adapter API: the `DMelCodecAdapter` of
`dmel_codec_tpu/eval/codecs.py` (the other codecs of that zoo are not
ported yet).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dmel_codec_tpu_torch.dsp.spectrogram import LogMelSpectrogram
from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, FusedBigVGAN
from dmel_codec_tpu_torch.models.codec import DMelCodec


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
