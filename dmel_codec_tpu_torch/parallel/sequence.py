"""Sequence (time-axis) parallelism for long-audio codec inference (port of
`dmel_codec_tpu/parallel/sequence.py`).

The ranks of a group hold contiguous, equal chunks of the time axis: rank r
the mel frames [r c, (r + 1) c) of every clip (encode), or its tokens and
their decoder noise (decode), and returns its chunk of the output. The
codec is convolutional, so a chunk's output needs its neighbours' frames
within the receptive field. XLA's partitioner exchanges those halos inside
the JAX functions; here each rank gathers the window [r c - halo,
(r + 1) c + halo) (clamped to the clip) from the ranks that hold it, by
send / recv (from the neighbours, and from further ranks when a chunk is
shorter than the halo), runs the model on the window, and keeps its chunk:
`models/streaming.py`'s windowing, with the halo its callers use
(`DEFAULT_HALO_FRAMES` = 128 frames, 32 tokens: the WaveNet stacks reach
75 frames per side and the quantizer's ConvNeXt blocks 18). Masks come from
the clips' global lengths at global positions, so each rank's output equals
its chunk of the one-process `DMelCodec.encode` / `decode`.

Chunks and halos are multiples of `downsample_total` (4), so that every
window starts on a token boundary.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist

from dmel_codec_tpu_torch.models.streaming import DEFAULT_HALO_FRAMES


def _positions_mask(lengths: torch.Tensor, start: int, stop: int, dtype: torch.dtype) -> torch.Tensor:
    """[B, stop - start, 1]: whether each global frame position is inside its clip."""
    positions = torch.arange(start, stop, device=lengths.device)
    return (positions[None, :] < lengths[:, None]).to(dtype)[..., None]


def _gather_window(local: torch.Tensor, dim: int, halo: int, group=None) -> Tuple[torch.Tensor, int]:
    """The ranks of `group` hold equal contiguous chunks of an axis of
    length chunk * size along `dim` (this rank's is `local`). Returns this
    rank's window [r chunk - halo, (r + 1) chunk + halo), clamped to the
    axis, assembled from the ranks that hold it, and the window's start."""
    group = dist.group.WORLD if group is None else group
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    chunk = local.shape[dim]
    total = chunk * size

    def window(r: int) -> Tuple[int, int]:
        return max(0, r * chunk - halo), min(total, (r + 1) * chunk + halo)

    def overlap(j: int, lo: int, hi: int) -> Tuple[int, int]:
        return max(lo, j * chunk), min(hi, (j + 1) * chunk)

    lo, hi = window(rank)
    pieces, ops = [], []
    for j in range(size):
        a, b = overlap(j, lo, hi)
        if a >= b:
            continue
        if j == rank:
            pieces.append(local.narrow(dim, a - j * chunk, b - a))
        else:
            shape = list(local.shape)
            shape[dim] = b - a
            pieces.append(local.new_empty(shape))
            ops.append(dist.P2POp(dist.irecv, pieces[-1], dist.get_global_rank(group, j), group))
    for i in range(size):
        a, b = overlap(rank, *window(i))
        if i != rank and a < b:
            piece = local.narrow(dim, a - rank * chunk, b - a).contiguous()
            ops.append(dist.P2POp(dist.isend, piece, dist.get_global_rank(group, i), group))
    if ops:
        for request in dist.batch_isend_irecv(ops):
            request.wait()
    return torch.cat(pieces, dim=dim), lo


def _check_halo(model, halo_frames: int) -> int:
    down = model.config.downsample_total
    if halo_frames % down:
        raise ValueError(f"halo_frames must be a multiple of {down} (downsample_total)")
    return down


def time_sharded_encode(model, group=None, halo_frames: int = DEFAULT_HALO_FRAMES) -> Callable:
    """`DMelCodec.encode` with the mel frames cut over the ranks of `group`
    (default: the world).

    Returns fn(mels [B, T/N, M] (this rank's frames), mel_lengths [B] (the
    clips' global lengths)) -> (indices [B, G*R, T/(N*down)] (this rank's
    tokens), index_lengths [B] (the same on every rank))."""
    down = _check_halo(model, halo_frames)

    @torch.no_grad()
    def encode(mels: torch.Tensor, mel_lengths: torch.Tensor):
        chunk = mels.shape[1]
        if chunk % down:
            raise ValueError(f"each rank's chunk of {chunk} mel frames must be a multiple of {down} (downsample_total)")
        rank = dist.get_rank(group)
        window, lo = _gather_window(mels, 1, halo_frames, group)
        masks = _positions_mask(mel_lengths, lo, lo + window.shape[1], window.dtype)
        features = model.encode_features(window, masks)
        indices = model.quantizer.encode(features.transpose(1, 2))
        start = (rank * chunk - lo) // down
        return indices[:, :, start: start + chunk // down], mel_lengths // down

    return encode


def time_sharded_decode(model, group=None, halo_frames: int = DEFAULT_HALO_FRAMES) -> Callable:
    """`DMelCodec.decode` with the token frames and the decoder noise cut
    over the ranks of `group` (default: the world).

    Returns fn(indices [B, G*R, L/N] (this rank's tokens), feature_lengths
    [B] (global, in tokens), noise [B, L/N*down, C] (this rank's frames)) ->
    gen_mel [B, L/N*down, M] (this rank's frames)."""
    down = _check_halo(model, halo_frames)
    cfg = model.config

    @torch.no_grad()
    def decode(indices: torch.Tensor, feature_lengths: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        frames = indices.shape[2] * down
        if noise.shape[1] != frames:
            raise ValueError(f"noise has {noise.shape[1]} frames for {indices.shape[2]} tokens ({frames} expected)")
        rank = dist.get_rank(group)
        idx_window, _ = _gather_window(indices, 2, halo_frames // down, group)
        noise_window, lo = _gather_window(noise, 1, halo_frames, group)
        dtype = getattr(torch, cfg.compute_dtype) if cfg.compute_dtype else None
        z = model.quantizer.decode(idx_window, dtype=dtype).transpose(1, 2)
        masks = _positions_mask(feature_lengths * down, lo, lo + z.shape[1], z.dtype)
        quality = torch.full((z.shape[0], 1), 2.0, dtype=z.dtype, device=z.device)
        condition = z * masks + model.project_quality(quality)
        mel = model.decode_mel(condition, masks, noise_window)
        start = rank * frames - lo
        return mel[:, start: start + frames]

    return decode
