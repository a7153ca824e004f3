"""Fused anti-aliased snake activation (port of `dmel_codec_tpu/ops/anti_alias.py`).

`anti_alias_activation` computes UpSample1d -> snake/snakebeta ->
DownSample1d on channels-first [B, C, T] (the reference's
alias_free_activation chain, exact at both edges):
  * on a CPU tensor it runs the plain PyTorch version,
    `anti_alias_activation_reference`;
  * on a CUDA tensor it launches kernel K1 (csrc/anti_alias.cu) or raises.
The snake's coefficients, alpha and 1 / (beta + eps), exp'd under
`logscale`, are taken in the parameters' dtype (`snake_coefficients`; the
kernel rounds them so itself), as the JAX op takes them before its kernel
(ops/anti_alias.py:607-612): bf16 parameters give bf16-rounded
coefficients. The rest is float32 arithmetic with the result in x's dtype.
On bf16 x it also rounds where the JAX kernel does (its FIRs are bf16
banded matmuls, ops/anti_alias.py:317-372): the 12 taps to bf16 (the
up FIR's gain of 2 stays exact) and the 2x-rate snake output v to bf16
before the down FIR.
The backward pass differentiates the plain version, as the JAX op's custom
VJP differentiates its oracle.
"""

from __future__ import annotations

from typing import Optional

import torch

from dmel_codec_tpu_torch.nn.resample import downsample1d, kaiser_sinc_filter1d, upsample1d
from dmel_codec_tpu_torch.nn.snake import snake_beta
from dmel_codec_tpu_torch.ops import library

_KS = 12
FILT = kaiser_sinc_filter1d(0.5 / 2, 0.6 / 2, _KS)  # [12] numpy float32
FILT_BF16 = torch.from_numpy(FILT).bfloat16().float().numpy()  # the taps of the bf16 contract


def activation_chain(x: torch.Tensor, snake_fn, bf16: bool) -> torch.Tensor:
    """UpSample1d -> snake_fn -> DownSample1d on float32 x, in float32; with
    `bf16` the taps and the snake's output v are rounded to bf16."""
    filt = torch.from_numpy(FILT_BF16 if bf16 else FILT)
    v = snake_fn(upsample1d(x, filt, 2, _KS))
    if bf16:
        v = v.bfloat16().float()
    return downsample1d(v, filt, 2, _KS)


def anti_alias_activation_reference(
    x: torch.Tensor,
    alpha: torch.Tensor,
    beta: Optional[torch.Tensor],
    logscale: bool = False,
) -> torch.Tensor:
    """Plain version: coefficients in the parameters' dtype, float32
    arithmetic (bf16 taps and v on bf16 x), result in x's dtype."""
    snake_fn = lambda u: snake_beta(u, alpha, beta, logscale)  # noqa: E731
    return activation_chain(x.float(), snake_fn, x.dtype == torch.bfloat16).to(x.dtype)


def _launch(x, alpha, beta, logscale: bool) -> torch.Tensor:
    lib = library.load()
    library.check_plane(x)
    b, c, t = x.shape
    a, bt, param_bf16 = library.snake_parameters(alpha, beta, x, c)
    bf16 = x.dtype == torch.bfloat16
    y = torch.empty_like(x)
    rc = lib.dmel_anti_alias(
        x.data_ptr(), y.data_ptr(), a.data_ptr(), None if bt is None else bt.data_ptr(),
        int(logscale), param_bf16, b, c, t, int(bf16), library.taps(FILT_BF16 if bf16 else FILT), library.stream(x),
    )
    library.check(lib, rc, "dmel_anti_alias")
    anti_alias_activation.launches += 1
    return y


class _AntiAlias(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha, beta, logscale):
        ctx.save_for_backward(x, alpha, beta)
        ctx.logscale = logscale
        return _launch(x, alpha, beta, logscale)

    @staticmethod
    def backward(ctx, grad):
        ins = [None if t is None else t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = anti_alias_activation_reference(*ins, ctx.logscale)
            live = [t for t in ins if t is not None]
            grads = iter(torch.autograd.grad(y, live, grad))
        return (*(None if t is None else next(grads) for t in ins), None)


def anti_alias_activation(
    x: torch.Tensor,
    alpha: torch.Tensor,
    beta: Optional[torch.Tensor] = None,
    logscale: bool = False,
) -> torch.Tensor:
    """[B, C, T] -> [B, C, T]; beta=None selects plain snake (gain 1/alpha)."""
    if x.device.type == "cpu":
        return anti_alias_activation_reference(x, alpha, beta, logscale)
    return _AntiAlias.apply(x, alpha, beta, logscale)


anti_alias_activation.launches = 0  # K1 launches, counted in _launch
