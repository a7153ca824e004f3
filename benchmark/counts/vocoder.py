"""Operations and bytes of the BigVGAN generator's work, from its shapes.

After `chip_smoke.py`'s `stage_shapes` and `stage_bound_ms`: a stage's
resblock group is 6 convs of C x C x k for each kernel size k (18 at
(3, 7, 11)) and 18 anti-aliased activations of K1_FLOPS_PER_SAMPLE each;
the stage's transposed conv is counted here too (the `vocoder.s<i>` spans
hold it). Bytes: the stage's input and output planes once each and its
weights once. Every count is of one clip at its own length (real audio,
not padding), so that no way of batching can do less.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

# K1's arithmetic per output sample: two 6-tap polyphase up FIRs (24 flops)
# and their gain (2), two snakes (mul, sin, mul, fma: 8), one 12-tap down
# FIR (24) (chip_smoke.py's K1_FLOPS_PER_SAMPLE).
ACT_FLOPS_PER_SAMPLE = 58


def stage_channels(cfg: dict, i: int) -> int:
    return cfg["upsample_initial_channel"] // (2 ** (i + 1))


def stage_work(cfg: dict, i: int, frames: Iterable[int], itemsize: int) -> Tuple[float, float]:
    """(flops, bytes) of stage i over clips of `frames` mel frames each."""
    c, u, k_up = stage_channels(cfg, i), cfg["upsample_rates"][i], cfg["upsample_kernel_sizes"][i]
    convs = sum(len(d) * 2 * k for k, d in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]))
    acts = sum(len(d) * 2 for d in cfg["resblock_dilation_sizes"])
    flops = nbytes = 0.0
    clips = 0
    for f in frames:
        t_in = f * math.prod(cfg["upsample_rates"][:i])
        t = t_in * u
        flops += 2.0 * t_in * 2 * c * c * k_up + 2.0 * t * c * c * convs + acts * ACT_FLOPS_PER_SAMPLE * c * t
        nbytes += (2 * c * t_in + c * t) * itemsize
        clips += 1
    if clips:
        nbytes += (2 * c * c * k_up + convs * c * c) * itemsize
    return flops, nbytes


def vocoder_flops(cfg: dict, frames: Iterable[int]) -> float:
    """Operations of the whole generator over clips of `frames` frames."""
    frames = list(frames)
    n = len(cfg["upsample_rates"])
    flops = sum(stage_work(cfg, i, frames, 4)[0] for i in range(n))
    c0, cl = cfg["upsample_initial_channel"], stage_channels(cfg, n - 1)
    hop = math.prod(cfg["upsample_rates"])
    for f in frames:
        flops += 2.0 * f * cfg["num_mels"] * c0 * 7  # conv_pre
        flops += ACT_FLOPS_PER_SAMPLE * cl * f * hop + 2.0 * f * hop * cl * 7  # activation_post, conv_post
    return flops
