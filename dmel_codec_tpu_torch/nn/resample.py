"""Kaiser-windowed sinc up/down-samplers (port of `dmel_codec_tpu/nn/resample.py`).

Channels-first [B, C, T], with the reference's numerical contract
(bigvgan/alias_free_activation/torch/{filter.py,resample.py}):
  * 12-tap kaiser-sinc lowpass, cutoff 0.5/ratio, half-width 0.6/ratio
  * upsample1d: replicate-pad 5, depthwise transposed conv stride 2 scaled
    by ratio, crop 15/15
  * downsample1d: replicate-pad (5, 6), depthwise conv stride 2
These are the plain version of the fused activation kernel (ops/anti_alias).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Normalized lowpass FIR, shape [kernel_size] (reference filter.py:30-62).

    A verbatim copy of the JAX package's numpy function (its module imports
    jax); a test pins the two together."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2

    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)

    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size

    if cutoff == 0:
        return np.zeros(kernel_size, dtype=np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt = filt / filt.sum()
    return filt.astype(np.float32)


def _depthwise(filt: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return filt.to(device=x.device, dtype=x.dtype).expand(x.shape[1], 1, -1)


def upsample1d(x: torch.Tensor, filt: torch.Tensor, ratio: int = 2, kernel_size: int = 12):
    """[B, C, T] -> [B, C, ratio*T] anti-aliased upsample."""
    pad = kernel_size // ratio - 1
    pad_left = pad * ratio + (kernel_size - ratio) // 2
    pad_right = pad * ratio + (kernel_size - ratio + 1) // 2
    x = F.pad(x, (pad, pad), mode="replicate")
    y = ratio * F.conv_transpose1d(x, _depthwise(filt, x), stride=ratio, groups=x.shape[1])
    return y[..., pad_left:-pad_right]


def downsample1d(x: torch.Tensor, filt: torch.Tensor, ratio: int = 2, kernel_size: int = 12):
    """[B, C, T] -> [B, C, T//ratio] anti-aliased downsample."""
    even = kernel_size % 2 == 0
    x = F.pad(x, (kernel_size // 2 - int(even), kernel_size // 2), mode="replicate")
    return F.conv1d(x, _depthwise(filt, x), stride=ratio, groups=x.shape[1])


class _Resample1d(torch.nn.Module):
    def __init__(self, ratio: int = 2, kernel_size: int | None = None):
        super().__init__()
        self.ratio = ratio
        self.kernel_size = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
        self.register_buffer(
            "filter",
            torch.from_numpy(kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, self.kernel_size)),
            persistent=False,
        )


class UpSample1d(_Resample1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample1d(x, self.filter, self.ratio, self.kernel_size)


class DownSample1d(_Resample1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return downsample1d(x, self.filter, self.ratio, self.kernel_size)
