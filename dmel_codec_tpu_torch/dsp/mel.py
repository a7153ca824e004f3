"""Mel filterbank + window construction (host-side numpy, computed once).

A verbatim copy of `dmel_codec_tpu/dsp/mel.py`: importing that module runs
`dmel_codec_tpu/dsp/__init__.py`, which pulls in jax. A test pins both
copies to the same output. Slaney mel scale with slaney area normalisation
(librosa.filters.mel) and the periodic Hann window (torch.hann_window).
"""

from __future__ import annotations

import numpy as np

# Slaney mel-scale constants: linear below 1 kHz (f / (200/3)),
# logarithmic above with step log(6.4)/27.
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies: np.ndarray) -> np.ndarray:
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    mels = frequencies / _F_SP
    log_region = frequencies >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(frequencies, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asanyarray(mels, dtype=np.float64)
    freqs = _F_SP * mels
    log_region = mels >= _MIN_LOG_MEL
    freqs = np.where(
        log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)), freqs
    )
    return freqs


def mel_frequencies(n_mels: int, f_min: float, f_max: float) -> np.ndarray:
    """Center frequencies (Hz) of `n_mels` points uniformly spaced in mel."""
    return mel_to_hz(np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels))


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    f_min: float = 0.0,
    f_max: float | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular slaney-normalised mel filterbank, shape [n_mels, n_fft//2 + 1]."""
    if f_max is None:
        f_max = float(sample_rate) / 2.0

    fft_freqs = np.linspace(0.0, float(sample_rate) / 2.0, n_fft // 2 + 1)
    mel_f = mel_frequencies(n_mels + 2, f_min, f_max)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style area normalisation.
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights = weights * enorm[:, None]
    return weights.astype(dtype)


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (matches torch.hann_window default)."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    return w.astype(dtype)
