"""Log-mel spectrogram front end (port of `dmel_codec_tpu/dsp/spectrogram.py`).

Numerical contract (reference dmel_codec/utils/spectrogram.py:41-81):
  * reflect-pad the waveform by (n_fft - hop) // 2 on both sides
  * non-centered STFT with a periodic Hann window
  * magnitude = sqrt(re^2 + im^2 + 1e-9)
  * slaney mel projection, then log(clamp(x, min=1e-5))

Runs in float32 whatever the caller's dtype. Output is [B, frames, n_mels],
the JAX package's layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dmel_codec_tpu_torch.dsp.mel import hann_window, mel_filterbank

_LOG_CLIP = 1e-5
_MAG_EPS = 1e-9


class LogMelSpectrogram(torch.nn.Module):
    def __init__(
        self,
        sample_rate: int = 24000,
        n_fft: int = 1024,
        win_length: int = 1024,
        hop_length: int = 256,
        n_mels: int = 100,
        f_min: float = 0.0,
        f_max: float | None = 12000.0,
    ):
        super().__init__()
        if win_length != n_fft:
            raise NotImplementedError("win_length != n_fft not needed by any config")
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.register_buffer(
            "window", torch.from_numpy(hann_window(win_length)), persistent=False
        )
        self.register_buffer(
            "mel_basis",
            torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels, f_min, f_max)),
            persistent=False,
        )

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """audio [B, L] or [B, 1, L] -> log-mel [B, frames, n_mels] (float32)."""
        if audio.dim() == 2:
            audio = audio[:, None, :]
        audio = audio.float()
        pad = (self.n_fft - self.hop_length) // 2
        audio = F.pad(audio, (pad, pad), mode="reflect")[:, 0, :]
        frames = audio.unfold(-1, self.n_fft, self.hop_length) * self.window
        spec = torch.fft.rfft(frames, dim=-1)
        mag = torch.sqrt(spec.real.square() + spec.imag.square() + _MAG_EPS)
        mel = mag @ self.mel_basis.T
        return torch.log(torch.clamp(mel, min=_LOG_CLIP))
