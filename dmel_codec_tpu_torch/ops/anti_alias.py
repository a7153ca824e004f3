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

from typing import List, Optional, Tuple

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


# K1's launch plan (csrc/anti_alias.cu): a warp takes units of UNIT
# outputs of one row, RUN per lane; a row's units start at its first
# sample on a 16-byte boundary (`head`), with one unit more before it
# (`lead`) when rows are not all aligned. `k1_plan` mirrors the kernel's
# arithmetic for the tests.
RUN = 8
UNIT = 32 * RUN


def k1_plan(t: int, itemsize: int, x0: int = 0, vec: bool = True) -> Tuple[int, int]:
    """(units per row, lead) of a launch on rows of `t` samples of
    `itemsize` bytes, x at element address `x0`; `vec` = False (x and y
    of another 16-byte phase) goes element by element from sample 0."""
    lead = int(vec and ((x0 * itemsize) % 16 != 0 or (t * itemsize) % 16 != 0))
    return -(-t // UNIT) + lead, lead


def k1_row_units(t: int, itemsize: int, x0: int, row: int, vec: bool = True) -> List[Tuple[int, List[Tuple[int, bool]]]]:
    """The units the kernel computes on row `row`: [(first output, [(a
    lane's first output, whether its 16 samples go as 16-byte vectors)])],
    units wholly outside [0, t) left out."""
    n_units, lead = k1_plan(t, itemsize, x0, vec)
    ve = 16 // itemsize
    head = (ve - (x0 + row * t) % ve) % ve if vec else 0
    out = []
    for k in range(n_units):
        seg = head + (k - lead) * UNIT
        if seg + UNIT <= 0 or seg >= t:
            continue
        out.append((seg, [(seg + RUN * lane, vec and seg + RUN * lane >= 0 and seg + RUN * lane + RUN <= t)
                          for lane in range(32)]))
    return out


def _launch(x, alpha, beta, logscale: bool) -> torch.Tensor:
    lib = library.load()
    library.check_plane(x)
    b, c, t = x.shape
    a, bt, param_bf16 = library.snake_parameters(alpha, beta, x, c)
    bf16 = x.dtype == torch.bfloat16
    y = torch.empty_like(x)
    rc = lib.dmel_anti_alias(
        x.data_ptr(), y.data_ptr(), a.data_ptr(), None if bt is None else bt.data_ptr(),
        int(logscale), param_bf16, b, c, t, int(bf16), library.taps(FILT_BF16 if bf16 else FILT),
        library.stream(x),
    )
    library.check(lib, rc, "dmel_anti_alias")
    anti_alias_activation.launches += 1
    return y


def sin_replica_mismatches(device: str = "cuda") -> int:
    """The floats below 105615 where the kernel's sinf without conversions
    (csrc/anti_alias.cu sin_reduced) and sinf differ beyond the sign, all
    2^32 of them visited on the card; 0 is the kernel's premise."""
    lib = library.load()
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    library.check(lib, lib.dmel_sin_check(bad.data_ptr(), library.stream(bad)), "dmel_sin_check")
    return int(bad.item())


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
