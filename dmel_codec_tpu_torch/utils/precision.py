"""Precision settings: float32 means float32, as in the JAX package."""

from __future__ import annotations

import torch


def strict_float32() -> None:
    """Full float32 everywhere: no TF32 in cuBLAS matmuls or cuDNN convs
    (cuDNN allows TF32 by default), float32 as the default dtype.

    The entry points call it before they build a model. The JAX package
    contracts float32 inputs exactly (`Precision.HIGHEST`,
    dmel_codec_tpu/ops/stage_fused.py:148) and the parity tests hold the
    port to it in float32 on the CPU; one TF32 product keeps ~3 digits.
    Only the legacy flags are set: torch refuses to read them back once they
    are mixed with `fp32_precision`, and setting them moves that too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_default_dtype(torch.float32)


def tf32_flags() -> dict:
    """What the process allows: the two legacy flags and, where this torch
    has it, the cuDNN convs' `fp32_precision`."""
    flags = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    conv = getattr(torch.backends.cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        flags["cudnn.conv.fp32_precision"] = conv.fp32_precision
    return flags
