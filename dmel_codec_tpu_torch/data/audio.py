"""WAV loading, resampling and normalization (port of
`dmel_codec_tpu/data/audio.py`): load at the file's rate, resample with a
Kaiser polyphase filter, normalize to a 0.95 peak, as the reference's
librosa.load + peak-normalize step. Two backends with the same semantics:

  * native: one host C++ call per cut (`native/audio_kernels.cpp`: RIFF
    decode, scipy-exact Kaiser polyphase resampling, peak normalization),
    which releases the GIL for the whole call, so the loader's decode
    threads scale across cores;
  * python: scipy.io.wavfile + scipy.signal.resample_poly, also the
    native backend's oracle in the tests.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from dmel_codec_tpu_torch.native import load_library


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


def load_audio_python(
    path: str,
    target_sr: int = 24000,
    start: float = 0.0,
    duration: Optional[float] = None,
    normalize: bool = True,
) -> np.ndarray:
    audio, sr = read_wav(path, start, duration)
    audio = resample_audio(audio, sr, target_sr)
    return peak_normalize(audio) if normalize else audio


def load_audio_native(
    path: str,
    target_sr: int = 24000,
    start: float = 0.0,
    duration: Optional[float] = None,
    normalize: bool = True,
) -> Optional[np.ndarray]:
    """Decode + resample + normalize in one C++ call. Raises `RuntimeError`
    when the library cannot be built or loaded; None when it cannot read
    this file (a format it does not decode)."""
    lib = load_library()
    p = os.fsencode(path)
    dur = -1.0 if duration is None else float(duration)
    n = lib.dmel_load_len(p, float(start), dur, int(target_sr))
    if n < 0:
        return None
    out = np.empty(int(n), np.float32)
    wrote = lib.dmel_load_wav(
        p, float(start), dur, int(target_sr), 0.95 if normalize else -1.0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(n),
    )
    if wrote < 0:
        return None
    return out[:wrote]


BACKENDS = ("auto", "native", "python")


def load_audio(
    path: str,
    target_sr: int = 24000,
    start: float = 0.0,
    duration: Optional[float] = None,
    normalize: bool = True,
    backend: str = "auto",
) -> np.ndarray:
    """backend: 'native' decodes with the C++ kernels and raises when they
    cannot be built or cannot read the file; 'python' with scipy; 'auto'
    prefers the native kernels and takes scipy where they are unavailable
    or cannot read the file (the JAX package's contract)."""
    if backend not in BACKENDS:
        raise ValueError(f"audio backend {backend!r}: expected one of {BACKENDS}")
    if backend in ("auto", "native"):
        try:
            audio = load_audio_native(path, target_sr, start, duration, normalize)
        except RuntimeError:
            if backend == "native":
                raise
            audio = None
        if audio is not None:
            return audio
        if backend == "native":
            raise RuntimeError(f"the native audio kernels could not read {path}")
    return load_audio_python(path, target_sr, start, duration, normalize)
