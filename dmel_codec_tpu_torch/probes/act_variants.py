"""Ablate kernel K1 to locate its time (port of `scripts/exp_act_variants.py`).

`run_variant` launches K1 (csrc/anti_alias.cu) with parts removed, at the
production kernel's grid, tile and loads:
  copy      load the tile and store its centre (pure traffic)
  no_snake  both FIRs around an identity (no sinf)
  no_fir    snake on the input, no filters
  full      the kernel as the vocoder runs it
Each variant has a plain PyTorch version, `variant_reference`, which a CPU
tensor takes and the card's result is held against.

    python -m dmel_codec_tpu_torch.probes.act_variants

prints the four times (CUDA events) at K1's three main-path shapes
(16 clips x 4 s through the flagship vocoder) and at [16, 384, 6000], the
[B, C, T] form of the JAX probe's second shape, in bfloat16.
"""

from __future__ import annotations

from typing import Optional

import torch

from dmel_codec_tpu_torch.nn.snake import snake_beta
from dmel_codec_tpu_torch.ops import library
from dmel_codec_tpu_torch.ops.anti_alias import FILT, FILT_BF16, activation_chain, anti_alias_activation_reference
from dmel_codec_tpu_torch.probes.timing import cuda_ms, require_gpu

VARIANTS = ("full", "copy", "no_snake", "no_fir")  # the kernel's enum order
# [B, C, T]: act_post, stage 0 and stage 1 of a 16 x 4 s request, and the JAX probe's shape
SHAPES = ((16, 24, 95232), (16, 768, 1488), (16, 384, 5952), (16, 384, 6000))


def variant_reference(
    x: torch.Tensor,
    alpha: torch.Tensor,
    beta: Optional[torch.Tensor],
    variant: str,
    logscale: bool = True,
) -> torch.Tensor:
    """Plain version of each variant: coefficients in the parameters' dtype
    and, on bf16 x, bf16 taps and v (as K1's), float32 arithmetic, result in
    x's dtype."""
    if variant == "full":
        return anti_alias_activation_reference(x, alpha, beta, logscale)
    if variant == "copy":
        return x.clone()
    if variant == "no_fir":
        return snake_beta(x.float(), alpha, beta, logscale).to(x.dtype)
    if variant == "no_snake":  # as "full", the identity in place of snake (its v rounded on bf16 x too)
        return activation_chain(x.float(), lambda u: u, x.dtype == torch.bfloat16).to(x.dtype)
    raise ValueError(f"unknown variant {variant!r}, expected one of {VARIANTS}")


def run_variant(
    x: torch.Tensor,
    alpha: torch.Tensor,
    beta: Optional[torch.Tensor],
    variant: str,
    logscale: bool = True,
) -> torch.Tensor:
    """[B, C, T] -> [B, C, T] through K1 with parts removed."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}, expected one of {VARIANTS}")
    if x.device.type == "cpu":
        return variant_reference(x, alpha, beta, variant, logscale)
    lib = library.load()
    library.check_plane(x)
    b, c, t = x.shape
    a, bt, param_bf16 = library.snake_parameters(alpha, beta, x, c)
    bf16 = x.dtype == torch.bfloat16
    y = torch.empty_like(x)
    rc = lib.dmel_anti_alias_variant(
        x.data_ptr(), y.data_ptr(), a.data_ptr(), None if bt is None else bt.data_ptr(),
        int(logscale), param_bf16, b, c, t, int(bf16), library.taps(FILT_BF16 if bf16 else FILT),
        VARIANTS.index(variant), library.stream(x),
    )
    library.check(lib, rc, "dmel_anti_alias_variant")
    run_variant.launches += 1
    return y


run_variant.launches = 0  # probe launches, counted in run_variant


def time_variants(shape, dtype=torch.bfloat16, reps: int = 20, device="cuda") -> dict:
    """Mean milliseconds per launch of each variant at `shape` (CUDA events)."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(shape, device=device, generator=gen).to(dtype)
    alpha = 0.1 * torch.randn(shape[1], device=device, generator=gen)
    return {v: cuda_ms(lambda v=v: run_variant(x, alpha, alpha, v), reps) for v in VARIANTS}


def main() -> dict:
    """Prints the table; returns {shape: {variant: ms}}."""
    require_gpu("act_variants")
    print(torch.cuda.get_device_name(0))
    print(f"{'shape':<20}" + "".join(f"{v:>10}" for v in VARIANTS) + "   (ms, bf16)")
    table = {}
    for shape in SHAPES:
        ms = table[shape] = time_variants(shape)
        print(f"{str(list(shape)):<20}" + "".join(f"{ms[v]:>10.4f}" for v in VARIANTS), flush=True)
    return table


if __name__ == "__main__":
    main()
