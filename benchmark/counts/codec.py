"""Model operations of the dMel codec's encode and decode, from its shapes
(one clip at its own number of mel frames; 2 flops a multiply-add)."""

from __future__ import annotations

import math
from typing import Iterable


def _wavenet(f: int, cin: int, c: int, cout, layers: int, cond) -> float:
    flops = 2.0 * f * cin * c if cin != c else 0.0
    per_layer = 2 * c * 3 + 2 * c + (2 * cond if cond else 0)  # dilated conv, output projection, condition
    flops += 2.0 * f * c * per_layer * layers + 2.0 * f * c * c
    if cout and cout != c:
        flops += 2.0 * f * c * cout
    return flops


def _convnext(t: int, c: int) -> float:
    return 2.0 * t * c * 7 + 2.0 * t * c * 4 * c * 2


def mel_flops(frames: int, n_fft: int = 1024, n_mels: int = 100) -> float:
    """A real FFT of n_fft (2.5 n log2 n), the magnitude and the mel projection, per frame."""
    bins = n_fft // 2 + 1
    return frames * (2.5 * n_fft * math.log2(n_fft) + 4 * bins + 2 * bins * n_mels)


def encode_flops(cfg: dict, frames: Iterable[int]) -> float:
    g, res = cfg["dmel_groups"], cfg["encoder_residual_channels"]
    band, nl = cfg["n_mels"] // g, len(cfg["levels"])
    total = 0.0
    for f in frames:
        total += mel_flops(f, n_mels=cfg["n_mels"])
        total += g * _wavenet(f, band, res, None, cfg["encoder_layers"], None)
        t = f
        for fac in cfg["downsample_factor"]:
            t //= fac
            total += g * (2.0 * t * res * res * fac + _convnext(t, res))
        total += g * 2.0 * t * res * nl
    return total


def decode_flops(cfg: dict, frames: Iterable[int]) -> float:
    g, res = cfg["dmel_groups"], cfg["encoder_residual_channels"]
    concat, nl = g * res, len(cfg["levels"])
    total = 0.0
    for f in frames:
        t = f // math.prod(cfg["downsample_factor"])
        total += g * 2.0 * t * nl * res
        for fac in reversed(cfg["downsample_factor"]):
            total += g * 2.0 * t * res * res * fac
            t *= fac
            total += g * _convnext(t, res)
        total += 2.0 * f * concat + _wavenet(f, concat, concat, cfg["n_mels"], cfg["decoder_layers"], concat)
    return total
