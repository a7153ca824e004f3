"""Manifest preprocessing: build / filter / window cut manifests (a copy of
`dmel_codec_tpu/data/preprocess.py`; numpy and the standard library).

Scan a directory (or a list) of WAVs into cuts with optional transcripts,
cut long recordings into fixed windows (flagship: 3 s training windows),
filter by duration, shuffle, report duration stats, save as jsonl(.gz);
only the text field is kept.

One difference: a WAV that the standard library's `wave` cannot open (IEEE
float samples) has its header read by scipy, where the JAX package raises
`wave.Error`.
"""

from __future__ import annotations

import os
import wave
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.io import wavfile

from dmel_codec_tpu_torch.data.manifest import Cut, load_manifest, save_manifest


def _wav_info(path: str):
    try:
        with wave.open(path, "rb") as w:
            return w.getframerate(), w.getnframes()
    except wave.Error:  # not PCM (IEEE float): the data chunk through a memory map
        sr, data = wavfile.read(path, mmap=True)
        return sr, data.shape[0]


def cuts_from_paths(
    paths: Sequence[str], transcripts: Optional[Dict[str, str]] = None
) -> List[Cut]:
    cuts = []
    for p in paths:
        sr, n = _wav_info(p)
        cut_id = os.path.splitext(os.path.basename(p))[0]
        cuts.append(
            Cut(
                id=cut_id,
                audio_path=os.path.abspath(p),
                start=0.0,
                duration=n / sr,
                sampling_rate=sr,
                text=(transcripts or {}).get(cut_id),
            )
        )
    return cuts


def cuts_from_dir(
    root: str, transcripts: Optional[Dict[str, str]] = None
) -> List[Cut]:
    paths = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(".wav"):
                paths.append(os.path.join(dirpath, f))
    return cuts_from_paths(paths, transcripts)


def cut_into_windows(cuts: Sequence[Cut], window_seconds: float) -> List[Cut]:
    """Split each cut into consecutive fixed windows (ref preprocess.py:169,
    stage config window_size=3); the ragged tail keeps its true duration."""
    out = []
    for cut in cuts:
        n = max(1, int(np.ceil(cut.duration / window_seconds)))
        for i in range(n):
            start = cut.start + i * window_seconds
            dur = min(window_seconds, cut.start + cut.duration - start)
            if dur <= 0:
                continue
            out.append(
                Cut(
                    id=f"{cut.id}_w{i}",
                    audio_path=cut.audio_path,
                    start=start,
                    duration=dur,
                    sampling_rate=cut.sampling_rate,
                    text=cut.text,
                )
            )
    return out


def filter_by_duration(
    cuts: Sequence[Cut],
    min_duration: Optional[float] = None,
    max_duration: Optional[float] = None,
) -> List[Cut]:
    out = list(cuts)
    if min_duration is not None:
        out = [c for c in out if c.duration >= min_duration]
    if max_duration is not None:
        out = [c for c in out if c.duration <= max_duration]
    return out


def duration_stats(cuts: Sequence[Cut]) -> dict:
    d = np.array([c.duration for c in cuts]) if cuts else np.zeros(1)
    return {
        "num_cuts": len(cuts),
        "total_hours": float(d.sum() / 3600),
        "min": float(d.min()),
        "max": float(d.max()),
        "mean": float(d.mean()),
    }


def prepare_manifests(
    cuts: Sequence[Cut],
    out_path: str,
    window_seconds: Optional[float] = None,
    min_duration: Optional[float] = None,
    max_duration: Optional[float] = None,
    shuffle_seed: Optional[int] = 0,
) -> dict:
    """Window -> filter -> shuffle -> save. Returns duration stats."""
    cuts = list(cuts)
    if window_seconds:
        cuts = cut_into_windows(cuts, window_seconds)
    cuts = filter_by_duration(cuts, min_duration, max_duration)
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(cuts)
    save_manifest(cuts, out_path)
    return duration_stats(cuts)


def sort_cuts_by_duration(
    in_path: str, out_path: str, descending: bool = False
) -> int:
    """Sort a cut manifest by duration (reference dataset/sort_cuts.py:6-50;
    the reference shards + multiprocesses because lhotse cuts are heavy —
    plain dataclass cuts sort in memory). Returns the number of cuts."""
    cuts = load_manifest(in_path)
    cuts.sort(key=lambda c: c.duration, reverse=descending)
    save_manifest(cuts, out_path)
    return len(cuts)
