"""Streaming (chunked) codec inference: bounded device memory for
arbitrarily long audio, with exact outputs (port of
`dmel_codec_tpu/models/streaming.py`).

The host holds the clip, the device one window. The frame axis is
processed in fixed-size windows of chunk + 2 * halo frames, and only the
central chunk of each is kept:

  * interior chunks carry `halo` frames of real neighbours on both sides,
    at least the path's receptive field, so the kept region equals the
    full-signal computation;
  * edge chunks clamp the window inside the signal (window edge == true
    signal boundary), so every layer's zero or replicate padding falls
    exactly where the one-shot computation pads;
  * an input no longer than one window runs one-shot.

Receptive fields: the WaveNet stacks reach 75 frames per side (20 layers
of k = 3 convs with dilations 2^(i % 4)) and the quantizer's ConvNeXt
blocks 18; the default halo of 128 frames (32 tokens) covers both. The
flagship BigVGAN (rates 4, 4, 2, 2, 2, 2; resblock kernels 3 / 7 / 11,
dilations 1 / 3 / 5; 12-tap anti-alias FIRs) reaches 26.3 mel frames; its
default halo is 40. The CUDA kernels under the vocoder tile by position and
take any length, so the chunked kernel path equals the one-shot kernel path
too.

Inputs and outputs are host numpy arrays; `device` defaults to the model's.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

DEFAULT_HALO_FRAMES = 128
# the flagship BigVGAN reaches 26.3 mel frames per side; 40 adds margin
DEFAULT_VOCODER_HALO_FRAMES = 40


def window_positions(t: int, chunk: int, halo: int) -> Iterator[Tuple[int, int]]:
    """(chunk start, window start) for every chunk of a length-t axis; the
    window of chunk + 2 * halo is clamped inside [0, t)."""
    window = chunk + 2 * halo
    for start in range(0, t, chunk):
        yield start, min(max(start - halo, 0), t - window)


def _device_dtype(model, device) -> Tuple[torch.device, torch.dtype]:
    """Where and in which floating type `model` (an nn.Module, or a serving
    form with `device` / `dtype`) runs."""
    if isinstance(model, torch.nn.Module):
        p = next(model.parameters())
        own, dtype = p.device, p.dtype
    else:
        own, dtype = model.device, model.dtype
    return (own if device is None else torch.device(device)), dtype


def _to_host(x: torch.Tensor) -> np.ndarray:
    x = x.float() if x.is_floating_point() else x
    return x.cpu().numpy()


@torch.no_grad()
def chunked_encode(
    model,
    mels: np.ndarray,
    chunk_frames: int = 1024,
    halo_frames: int = DEFAULT_HALO_FRAMES,
    device=None,
) -> np.ndarray:
    """mels [B, T, M] (host) -> indices [B, G*R, T'/down] (host), equal to
    one-shot `DMelCodec.encode`. T is cropped to a downsample_total
    multiple (the one-shot path's floor behaviour)."""
    down = model.config.downsample_total
    if chunk_frames % down or halo_frames % down:
        raise ValueError(f"chunk_frames and halo_frames must be multiples of {down}")
    device, dtype = _device_dtype(model, device)
    b, t, _ = np.shape(mels)
    t = (t // down) * down
    mels = np.asarray(mels[:, :t], np.float32)

    def encode(win: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(win).to(device=device, dtype=dtype)
        lengths = torch.full((b,), win.shape[1], device=device)
        return _to_host(model.encode(x, lengths)[0])

    window = chunk_frames + 2 * halo_frames
    if t <= window:  # short input: one-shot
        return encode(mels)
    chunk_t = chunk_frames // down
    pieces = []
    for start, pos in window_positions(t, chunk_frames, halo_frames):
        idx = encode(mels[:, pos : pos + window])
        off_t = (start - pos) // down
        n_tok = min(chunk_t, (t - start) // down)
        pieces.append(idx[:, :, off_t : off_t + n_tok])
    return np.concatenate(pieces, axis=2)


@torch.no_grad()
def chunked_decode(
    model,
    indices: np.ndarray,
    noise: Optional[np.ndarray] = None,
    chunk_tokens: int = 256,
    halo_tokens: int = DEFAULT_HALO_FRAMES // 4,
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """indices [B, G*R, L] (host) -> gen_mel [B, L*down, M] (host), equal to
    one-shot `DMelCodec.decode` when given the same `noise`
    ([B, L*down, concat_dim]; drawn on the host from `seed` if omitted)."""
    cfg = model.config
    down = cfg.downsample_total
    device, dtype = _device_dtype(model, device)
    indices = np.asarray(indices)
    b, _, l = indices.shape
    if noise is None:
        generator = torch.Generator().manual_seed(seed)
        noise = torch.randn((b, l * down, cfg.concat_dim), generator=generator).numpy()
    noise = np.asarray(noise, np.float32)

    def decode(idx_win: np.ndarray, noise_win: np.ndarray) -> np.ndarray:
        idx = torch.from_numpy(idx_win).to(device=device, dtype=torch.long)
        lengths = torch.full((b,), idx_win.shape[2], device=device)
        z = torch.from_numpy(noise_win).to(device=device, dtype=dtype)
        return _to_host(model.decode(idx, lengths, z))

    window = chunk_tokens + 2 * halo_tokens
    if l <= window:  # short input: one-shot
        return decode(indices, noise)
    pieces = []
    for start, pos in window_positions(l, chunk_tokens, halo_tokens):
        mel = decode(indices[:, :, pos : pos + window], noise[:, pos * down : (pos + window) * down])
        off = (start - pos) * down
        n_frames = min(chunk_tokens, l - start) * down
        pieces.append(mel[:, off : off + n_frames])
    return np.concatenate(pieces, axis=1)


@torch.no_grad()
def chunked_vocode(
    vocoder,
    mel: np.ndarray,
    chunk_frames: int = 480,
    halo_frames: int = DEFAULT_VOCODER_HALO_FRAMES,
    device=None,
) -> np.ndarray:
    """mel [B, T, M] (host) -> waveform [B, T*hop_total] (host), equal to the
    one-shot call of `vocoder` (a `BigVGAN` or a `FusedBigVGAN`: any
    callable mel -> waveform with `.config.hop_total`). Device memory is
    bounded by the window, not T."""
    hop = vocoder.config.hop_total
    device, dtype = _device_dtype(vocoder, device)
    _, t, _ = np.shape(mel)
    mel = np.asarray(mel, np.float32)

    def vocode(win: np.ndarray) -> np.ndarray:
        return _to_host(vocoder(torch.from_numpy(win).to(device=device, dtype=dtype)))

    window = chunk_frames + 2 * halo_frames
    if t <= window:  # short input: one-shot
        return vocode(mel)
    pieces = []
    for start, pos in window_positions(t, chunk_frames, halo_frames):
        wav = vocode(mel[:, pos : pos + window])
        off = (start - pos) * hop
        n = min(chunk_frames, t - start) * hop
        pieces.append(wav[:, off : off + n])
    return np.concatenate(pieces, axis=1)
