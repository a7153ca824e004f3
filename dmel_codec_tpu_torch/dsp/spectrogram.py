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
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.win_length = win_length
        self.hop_length = hop_length
        self.n_mels = n_mels
        self.f_min = f_min
        self.f_max = f_max
        self.register_buffer(
            "window", torch.from_numpy(hann_window(win_length)), persistent=False
        )
        self.register_buffer(
            "mel_basis",
            torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels, f_min, f_max)),
            persistent=False,
        )

    def num_frames(self, num_samples: int) -> int:
        pad = (self.n_fft - self.hop_length) // 2
        return 1 + (num_samples + 2 * pad - self.n_fft) // self.hop_length

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """audio [B, L] or [B, 1, L] -> log-mel [B, frames, n_mels] (float32)."""
        return log_mel_spectrogram(
            audio,
            n_fft=self.n_fft,
            hop_length=self.hop_length,
            mel_basis=self.mel_basis,
            window=self.window,
        )


def log_mel_spectrogram(
    audio: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    mel_basis: torch.Tensor,
    window: torch.Tensor,
) -> torch.Tensor:
    """audio [B, L] or [B, 1, L] -> log-mel [B, frames, n_mels] (float32)."""
    if audio.dim() == 2:
        audio = audio[:, None, :]
    audio = audio.float()
    pad = (n_fft - hop_length) // 2
    audio = F.pad(audio, (pad, pad), mode="reflect")[:, 0, :]
    frames = audio.unfold(-1, n_fft, hop_length) * window
    spec = torch.fft.rfft(frames, dim=-1)
    mag = torch.sqrt(spec.real.square() + spec.imag.square() + _MAG_EPS)
    mel = mag @ mel_basis.T.float()
    return torch.log(torch.clamp(mel, min=_LOG_CLIP))
