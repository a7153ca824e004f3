"""The plain references that decide `correct`.

Plain PyTorch and NumPy, written from the published descriptions of the
models and frozen here: they import neither `jax`, nor the JAX package, nor
anything of `dmel_codec_tpu_torch`, and take nothing the program derived.
Each function names the function of the port (and of the JAX package) that
it stands for. Every one of them takes the raw parameters by their
checkpoint names, as the benchmark made them from the seed, and works out
again whatever the program derives from them (weight norm, packed stage
weights, the codec decoder's noise).
"""

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matmuls and convolutions with TF32 off (the reference) or on
    (the control one precision below it), restoring the flags after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
