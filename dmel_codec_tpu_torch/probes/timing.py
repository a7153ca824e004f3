"""What the probes' tables share: CUDA-event timing and the card's peaks."""

from __future__ import annotations

import torch

# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data
# sheet): bf16 and TF32 tensor cores, float32 outside them, HBM3.
PEAK_BF16, PEAK_TF32, PEAK_F32, PEAK_BYTES = 989e12, 494.7e12, 67e12, 3.35e12


def cuda_ms(fn, reps: int = 20, warm: bool = True) -> float:
    """Mean milliseconds per call (CUDA events), after one warm-up call
    unless `warm` is False."""
    if warm:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def require_gpu(what: str) -> None:
    if not torch.cuda.is_available():
        raise SystemExit(f"{what}: the probe times a CUDA kernel and needs a GPU")
