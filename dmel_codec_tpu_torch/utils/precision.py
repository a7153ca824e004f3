"""Precision settings for comparing against a float32 reference."""

from __future__ import annotations

import torch


def strict_float32() -> None:
    """Full float32 everywhere: no TF32 in cuBLAS matmuls or cuDNN convs
    (cuDNN allows TF32 by default), float32 as the default dtype."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_default_dtype(torch.float32)
