"""Reconstruction / intelligibility metrics (port of `dmel_codec_tpu/eval/metrics.py`).

The numpy metrics are copies of the JAX package's, pinned to them by
tests/test_torch_eval.py:

  * WER           — word-level Levenshtein + the reference's text cleaning
  * STOI          — Taal et al. 2010 short-time objective intelligibility
                    (1/3-octave bands at 10 kHz, 384 ms segments, -15 dB
                    clipped correlation), numpy
  * SI-SNR        — scale-invariant SNR
  * F0 corr       — autocorrelation pitch tracker + Pearson r over voiced
                    frames
  * codebook use  — per-codebook entropy in bits

The mel L1 distance runs in torch through this package's
`dsp.LogMelSpectrogram`, on a `device` (default cuda).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy.signal import resample_poly

from dmel_codec_tpu_torch.dsp.spectrogram import LogMelSpectrogram

# ---------------------------------------------------------------------------
# text / WER
# ---------------------------------------------------------------------------

_PUNCT = ",.!?;:\"'()[]{}、，。！？；：""【】《》-"


def clean_text(text: str) -> str:
    """Lowercase, strip punctuation, collapse spaces (ref :13-33)."""
    text = text.lower()
    for p in _PUNCT:
        text = text.replace(p, " ")
    return " ".join(text.split())


def _edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    m, n = len(ref), len(hyp)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[n]


def wer(references: List[str], hypotheses: List[str], clean: bool = True) -> float:
    """Corpus WER: total edits / total reference words."""
    assert len(references) == len(hypotheses)
    edits = words = 0
    for ref, hyp in zip(references, hypotheses):
        if clean:
            ref, hyp = clean_text(ref), clean_text(hyp)
        r, h = ref.split(), hyp.split()
        edits += _edit_distance(r, h)
        words += len(r)
    return edits / max(words, 1)


# ---------------------------------------------------------------------------
# SI-SNR
# ---------------------------------------------------------------------------


def si_snr(target: np.ndarray, estimate: np.ndarray, eps: float = 1e-8) -> float:
    """Scale-invariant SNR in dB; inputs [T] or [B, T] (mean over batch)."""
    t = np.atleast_2d(np.asarray(target, np.float64))
    e = np.atleast_2d(np.asarray(estimate, np.float64))
    t = t - t.mean(-1, keepdims=True)
    e = e - e.mean(-1, keepdims=True)
    s = (e * t).sum(-1, keepdims=True) * t / ((t * t).sum(-1, keepdims=True) + eps)
    noise = e - s
    ratio = (s * s).sum(-1) / ((noise * noise).sum(-1) + eps)
    return float(np.mean(10 * np.log10(ratio + eps)))


# ---------------------------------------------------------------------------
# STOI (Taal et al., 2010)
# ---------------------------------------------------------------------------

_STOI_FS = 10000
_STOI_FRAME = 256
_STOI_HOP = 128
_STOI_NFFT = 512
_STOI_NBANDS = 15
_STOI_MINFREQ = 150.0
_STOI_SEG = 30  # 384 ms
_STOI_BETA = -15.0  # clipping, dB
_STOI_DYN_RANGE = 40.0  # silent-frame removal, dB


def _third_octave_bands() -> np.ndarray:
    """[15, 257] boolean-ish band matrix over rfft bins at 10 kHz/512."""
    f = np.linspace(0, _STOI_FS / 2, _STOI_NFFT // 2 + 1)
    cf = _STOI_MINFREQ * 2.0 ** (np.arange(_STOI_NBANDS) / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    bands = np.zeros((_STOI_NBANDS, len(f)))
    for k in range(_STOI_NBANDS):
        # snap band edges to the nearest rfft bin — EXACTLY what pystoi's
        # thirdoct() does (argmin over squared bin distance); agreement with
        # a line-by-line pystoi transcription is tested to ±0.03 (measured
        # ≤3e-4) in tests/test_eval.py::test_stoi_matches_pystoi_oracle
        i_lo = np.argmin((f - lo[k]) ** 2)
        i_hi = np.argmin((f - hi[k]) ** 2)
        bands[k, i_lo:i_hi] = 1.0
    return bands


def _frames(x: np.ndarray, frame: int, hop: int) -> np.ndarray:
    n = 1 + max(0, (len(x) - frame)) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    return x[idx]


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    w = np.hanning(_STOI_FRAME + 2)[1:-1]
    xf = _frames(x, _STOI_FRAME, _STOI_HOP) * w
    yf = _frames(y, _STOI_FRAME, _STOI_HOP) * w
    energy = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    keep = energy > energy.max() - _STOI_DYN_RANGE
    xf, yf = xf[keep], yf[keep]
    # overlap-add back
    n = len(xf)
    out_len = _STOI_FRAME + (n - 1) * _STOI_HOP if n else 0
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    for i in range(n):
        o = i * _STOI_HOP
        xs[o : o + _STOI_FRAME] += xf[i]
        ys[o : o + _STOI_FRAME] += yf[i]
    return xs, ys


def stoi(target: np.ndarray, estimate: np.ndarray, sample_rate: int = 24000) -> float:
    """Short-time objective intelligibility in [~0, 1]."""
    x = np.asarray(target, np.float64).reshape(-1)
    y = np.asarray(estimate, np.float64).reshape(-1)
    assert x.shape == y.shape
    if sample_rate != _STOI_FS:
        import math

        g = math.gcd(sample_rate, _STOI_FS)
        x = resample_poly(x, _STOI_FS // g, sample_rate // g)
        y = resample_poly(y, _STOI_FS // g, sample_rate // g)

    x, y = _remove_silent_frames(x, y)
    if len(x) < _STOI_FRAME + _STOI_HOP * (_STOI_SEG - 1):
        return float("nan")  # too short after silence removal

    w = np.hanning(_STOI_FRAME + 2)[1:-1]
    xf = _frames(x, _STOI_FRAME, _STOI_HOP) * w
    yf = _frames(y, _STOI_FRAME, _STOI_HOP) * w
    X = np.abs(np.fft.rfft(xf, _STOI_NFFT, axis=1)) ** 2  # [M, 257]
    Y = np.abs(np.fft.rfft(yf, _STOI_NFFT, axis=1)) ** 2

    bands = _third_octave_bands()
    Xb = np.sqrt(X @ bands.T)  # [M, 15]
    Yb = np.sqrt(Y @ bands.T)

    m = Xb.shape[0]
    if m < _STOI_SEG:
        return float("nan")
    clip = 10 ** (-_STOI_BETA / 20.0)
    d_sum, count = 0.0, 0
    for mi in range(_STOI_SEG, m + 1):
        xs = Xb[mi - _STOI_SEG : mi].T  # [15, 30]
        ys = Yb[mi - _STOI_SEG : mi].T
        alpha = np.linalg.norm(xs, axis=1, keepdims=True) / (
            np.linalg.norm(ys, axis=1, keepdims=True) + 1e-12
        )
        ys_n = np.minimum(alpha * ys, xs * (1 + clip))
        xs_c = xs - xs.mean(1, keepdims=True)
        ys_c = ys_n - ys_n.mean(1, keepdims=True)
        num = (xs_c * ys_c).sum(1)
        den = np.linalg.norm(xs_c, axis=1) * np.linalg.norm(ys_c, axis=1) + 1e-12
        d_sum += float((num / den).sum())
        count += _STOI_NBANDS
    return d_sum / count


# ---------------------------------------------------------------------------
# F0 correlation (autocorrelation pitch tracker)
# ---------------------------------------------------------------------------


def detect_f0(
    audio: np.ndarray,
    sample_rate: int = 24000,
    frame_time: float = 0.01,
    freq_low: float = 85.0,
    freq_high: float = 3400.0,
) -> np.ndarray:
    """Per-frame F0 (Hz), 0 for unvoiced, via normalized autocorrelation."""
    x = np.asarray(audio, np.float64).reshape(-1)
    frame = int(sample_rate * frame_time) * 3  # 30 ms analysis window
    hop = int(sample_rate * frame_time)
    lag_min = max(2, int(sample_rate / freq_high))
    lag_max = int(sample_rate / freq_low)
    if len(x) < frame + lag_max:
        return np.zeros(0)
    f = _frames(x, frame + lag_max, hop)
    f = f - f.mean(1, keepdims=True)
    base = f[:, :frame]
    e0 = (base * base).sum(1) + 1e-12
    best_corr = np.full(len(f), -1.0)
    best_lag = np.full(len(f), lag_min)
    for lag in range(lag_min, lag_max + 1):
        shifted = f[:, lag : lag + frame]
        corr = (base * shifted).sum(1) / np.sqrt(
            e0 * ((shifted * shifted).sum(1) + 1e-12)
        )
        better = corr > best_corr
        best_corr = np.where(better, corr, best_corr)
        best_lag = np.where(better, lag, best_lag)
    voiced = best_corr > 0.45
    return np.where(voiced, sample_rate / best_lag, 0.0)


def f0_corr(target: np.ndarray, estimate: np.ndarray, sample_rate: int = 24000) -> float:
    """Pearson correlation of F0 over frames voiced in both (ref :76-84)."""
    f0_t = detect_f0(target, sample_rate)
    f0_e = detect_f0(estimate, sample_rate)
    n = min(len(f0_t), len(f0_e))
    f0_t, f0_e = f0_t[:n], f0_e[:n]
    valid = (f0_t > 0) & (f0_e > 0)
    if valid.sum() < 2:
        return float("nan")
    return float(np.corrcoef(f0_t[valid], f0_e[valid])[0, 1])


# ---------------------------------------------------------------------------
# mel distance + codebook usage
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# mel distance + codebook usage
# ---------------------------------------------------------------------------

_MEL_TF: Dict[Tuple[int, str], LogMelSpectrogram] = {}


def _mel_transform(sample_rate: int, device) -> LogMelSpectrogram:
    """The log-mel transform for (sample rate, device), built once: full-corpus
    sweeps call mel_l1_distance per batch."""
    key = (sample_rate, str(torch.device(device)))
    if key not in _MEL_TF:
        _MEL_TF[key] = LogMelSpectrogram(sample_rate=sample_rate).to(device)
    return _MEL_TF[key]


@torch.no_grad()
def mel_l1_distance(
    target: np.ndarray, estimate: np.ndarray, sample_rate: int = 24000, device="cuda"
) -> float:
    """Mean |log-mel(gt) - log-mel(rec)| through the codec front end."""
    t = np.atleast_2d(np.asarray(target, np.float32))
    e = np.atleast_2d(np.asarray(estimate, np.float32))
    n = min(t.shape[-1], e.shape[-1])
    tf = _mel_transform(sample_rate, device)
    t = torch.from_numpy(np.ascontiguousarray(t[..., :n])).to(device)
    e = torch.from_numpy(np.ascontiguousarray(e[..., :n])).to(device)
    return float((tf(t) - tf(e)).abs().mean())


def codebook_usage_entropy(
    codes: np.ndarray,
    codebook_size: int,
    mask: Optional[np.ndarray] = None,
) -> List[float]:
    """codes [B, C, T] -> per-codebook entropy in bits (ref :133-151)."""
    codes = np.asarray(codes)
    b, c, t = codes.shape
    if mask is None:
        mask = np.ones((b, t), bool)
    else:
        mask = np.asarray(mask).astype(bool).reshape(b, t)
    out = []
    for i in range(c):
        vals = codes[:, i, :][mask]
        counts = np.bincount(vals, minlength=codebook_size).astype(np.float64)
        p = np.clip(counts / max(counts.sum(), 1), 1e-10, None)
        out.append(float(-(p * np.log2(p)).sum()))
    return out
