"""WAV loading, resampling and normalization: the numpy/scipy backend of
`dmel_codec_tpu/data/audio.py` (its native C++ backend is not ported).

Load at the file's rate, resample with scipy's polyphase filter, normalize
to a 0.95 peak, as the reference's librosa.load + peak-normalize step.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def read_wav(
    path: str, start: float = 0.0, duration: Optional[float] = None
) -> Tuple[np.ndarray, int]:
    """Returns (mono float32 in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(path, mmap=True)
    i0 = int(round(start * sr))
    i1 = len(data) if duration is None else i0 + int(round(duration * sr))
    data = np.asarray(data[i0:i1])
    # scale to [-1, 1] BEFORE downmixing (mean() would change the dtype)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1, dtype=np.float32)
    return data, int(sr)


def resample_audio(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return audio
    g = math.gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g).astype(np.float32)


def peak_normalize(audio: np.ndarray, peak: float = 0.95) -> np.ndarray:
    """Scale so max |x| == peak (the reference normalizes every cut to 0.95)."""
    m = np.abs(audio).max()
    if m < 1e-10:
        return audio
    return (audio * (peak / m)).astype(np.float32)


def load_audio(
    path: str,
    target_sr: int = 24000,
    start: float = 0.0,
    duration: Optional[float] = None,
    normalize: bool = True,
) -> np.ndarray:
    audio, sr = read_wav(path, start, duration)
    audio = resample_audio(audio, sr, target_sr)
    return peak_normalize(audio) if normalize else audio
