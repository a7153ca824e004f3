"""Kimi Delta Attention's chunked core, from the projections' outputs to o (kernel K6).

`models/kimi_linear.KimiDeltaAttention` hands over, for a call over several
positions, the bf16 outputs of q_proj, k_proj and v_proj (before their
convolutions), the forget gate's pre-activation f_b_proj(f_a_proj(x)),
b_proj's output, the three depthwise convolutions' weights, A_log, dt_bias
and the query scale, and the layer's cache (`conv`, the convolutions' last
inputs, and `state`, [B, heads, d, d] float32) or none. The core:

  q~, k~, v~ = SiLU(causal depthwise conv), the inputs before position 0
      the carried ones (or zeros);
  q = l2norm(q~) * scale, k = l2norm(k~) (`kimi_linear.L2NORM_EPS`);
  g = -exp(A_log) softplus(f + dt_bias), beta = sigmoid(b);
  the delta rule over the positions from the cache's state (or zeros)
      -> o [B, S, heads, d] float32, what the gated norm reads;

and, given a cache, leaves the last state and the convolutions' last
`taps - 1` inputs in it:
  * `kda_scan_reference` is that core in plain PyTorch, the model's plain
    path (`kimi_linear.causal_conv`, whose convolution runs in the inputs'
    dtype, then the chunked WY scan `kimi_linear.chunk_kda`) over every head
    at once;
  * `kda_scan` runs the plain version on a CPU tensor and on a CUDA tensor
    launches kernel K6 (csrc/kda_scan.cu: one launch a call over all heads)
    or raises. K6 takes bf16 projections and convolution inputs of the
    sizes `shape_fault` passes (heads of 128, 4 taps, chunks of 64); it
    computes the convolutions, norms and gates in float32 from the bf16
    inputs (the plain version rounds the convolutions' outputs to bf16),
    and every product of the scan as split-TF32 with float32 sums.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from dmel_codec_tpu_torch.ops import library

K6_D, K6_TAPS, K6_CHUNK = 128, 4, 64  # the head size, convolution taps and chunk K6 is built for (Kimi Linear's)


def kda_scan_reference(q, k, v, f, b, weights: Sequence[torch.Tensor], a_log, dt_bias, scale: float,
                       conv: Optional[torch.Tensor] = None, state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6's function in plain PyTorch. q, k, v, f [B, S, heads x d] (the
    projections' outputs), b [B, S, heads]; weights the q, k, v
    convolutions' [heads x d, 1, taps]; a_log [heads], dt_bias [heads x
    d]; conv [B, taps - 1, 3 heads d] and state [B, heads, d, d] float32,
    or None (zeros; nothing written) -> o [B, S, heads, d] float32."""
    # the model's own pieces: that module imports this one, so they are looked up at the call
    from dmel_codec_tpu_torch.models.kimi_linear import causal_conv, chunk_kda, l2norm_

    bsz, s, width = q.shape
    heads = a_log.shape[0]
    d = width // heads
    ops, tails = [], []
    for j, (x, w) in enumerate(zip((q, k, v), weights)):
        y, tail = causal_conv(x, w[:, 0], None if conv is None else conv[:, :, j * width:(j + 1) * width])
        tails.append(tail)
        y = y.view(bsz, s, heads, d)
        if j < 2:
            l2norm_(y)
        ops.append(y.mul_(scale) if j == 0 else y)
    g = F.softplus(f.unflatten(-1, (heads, d)) + dt_bias.float().view(heads, d))
    g = g.mul_(-torch.exp(a_log.float())[:, None])
    beta = torch.sigmoid(b.float())

    def rows(t):  # [B, S, heads, ...] -> [B heads, S, ...]
        return t.transpose(1, 2).reshape(bsz * heads, s, *t.shape[3:])

    first = None if state is None else state.reshape(bsz * heads, d, d)
    o, last = chunk_kda(*(rows(t) for t in (*ops, g)), rows(beta), first)
    if state is not None:
        state.copy_(last.view(bsz, heads, d, d))
    if conv is not None:
        conv.copy_(torch.cat(tails, dim=-1))
    return o.view(bsz, heads, s, d).transpose(1, 2)


def shape_fault(heads: int, d: int, taps: int, chunk: int) -> str:
    """Why K6 does not take KDA of these sizes, or "" where it does.
    `KimiDeltaAttention.k6_takes` asks it of its configuration, `_check` of
    the tensors of each call."""
    if d != K6_D:
        return f"K6 takes heads of {K6_D}, got {d}"
    if taps != K6_TAPS:
        return f"K6 takes convolutions of {K6_TAPS} taps, got {taps}"
    if chunk != K6_CHUNK:
        return f"K6 takes chunks of {K6_CHUNK} positions, got {chunk}"
    if heads < 1:
        return f"K6 takes at least one head, got {heads}"
    return ""


def _aligned(x: torch.Tensor) -> bool:
    """Unit last stride, the others multiples of 8 elements, starting on 16 bytes."""
    return x.stride(-1) == 1 and not any(st % 8 for st in x.stride()[:-1]) and x.data_ptr() % 16 == 0


def _check(q, k, v, f, b, weights, a_log, dt_bias, conv, state) -> None:
    """Raises unless K6 takes these tensors (module docstring); the device
    last, so that the rest can be checked on `meta` tensors."""
    if q.dim() != 3 or q.numel() == 0:
        raise ValueError(f"q must be a non-empty [B, S, heads x d] tensor, got {tuple(q.shape)}")
    bsz, s, width = q.shape
    heads = a_log.shape[0] if a_log.dim() == 1 else 0
    if heads < 1 or width % heads:
        raise ValueError(f"a_log must be [heads] with heads dividing {width}, got {tuple(a_log.shape)}")
    fault = shape_fault(heads, width // heads, weights[0].shape[-1], K6_CHUNK)
    if fault:
        raise ValueError(fault)
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v), ("f", f)):
        if tuple(x.shape) != (bsz, s, width) or x.dtype != torch.bfloat16 or x.device != dev or not _aligned(x):
            raise ValueError(f"{name} must be bf16 {(bsz, s, width)} on {dev} with rows contiguous on 16 bytes, got "
                             f"{x.dtype} {tuple(x.shape)} strides {x.stride()} on {x.device}")
    if tuple(b.shape) != (bsz, s, heads) or b.dtype != torch.bfloat16 or b.device != dev or b.stride(-1) != 1:
        raise ValueError(f"b must be bf16 {(bsz, s, heads)} on {dev} with heads contiguous, got {b.dtype} "
                         f"{tuple(b.shape)} on {b.device}")
    for name, w in zip(("q", "k", "v"), weights):
        if tuple(w.shape) != (width, 1, K6_TAPS) or w.dtype != torch.bfloat16 or w.device != dev or not w.is_contiguous():
            raise ValueError(f"the {name} convolution's weight must be contiguous bf16 {(width, 1, K6_TAPS)} on {dev}, "
                             f"got {w.dtype} {tuple(w.shape)} on {w.device}")
    if tuple(dt_bias.shape) != (width,) or a_log.device != dev or dt_bias.device != dev:
        raise ValueError(f"dt_bias must be [{width}] beside a_log on {dev}, got {tuple(dt_bias.shape)} on {dt_bias.device}")
    if conv is not None and (tuple(conv.shape) != (bsz, K6_TAPS - 1, 3 * width) or conv.dtype != torch.bfloat16
                             or conv.device != dev or not conv.is_contiguous() or conv.data_ptr() % 16):
        raise ValueError(f"conv must be contiguous bf16 {(bsz, K6_TAPS - 1, 3 * width)} on {dev}, got {conv.dtype} "
                         f"{tuple(conv.shape)} on {conv.device}")
    if state is not None and (tuple(state.shape) != (bsz, heads, K6_D, K6_D) or state.dtype != torch.float32
                              or state.device != dev or not state.is_contiguous() or state.data_ptr() % 16):
        raise ValueError(f"state must be contiguous float32 {(bsz, heads, K6_D, K6_D)} on {dev}, got {state.dtype} "
                         f"{tuple(state.shape)} on {state.device}")
    if dev.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor, got {dev}")


def kda_scan(q, k, v, f, b, weights: Sequence[torch.Tensor], a_log, dt_bias, scale: float,
             conv: Optional[torch.Tensor] = None, state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-> o [B, S, heads, d] float32, `kda_scan_reference`'s function (and
    its writes to `conv` and `state`): by K6 on a CUDA tensor, by the plain
    version on a CPU one."""
    if q.device.type == "cpu":
        return kda_scan_reference(q, k, v, f, b, weights, a_log, dt_bias, scale, conv, state)
    _check(q, k, v, f, b, weights, a_log, dt_bias, conv, state)
    lib = library.load()
    bsz, s, width = q.shape
    heads = a_log.shape[0]
    a_log, dt_bias = a_log.float().contiguous(), dt_bias.float().contiguous()
    strides = (*q.stride()[:2], *k.stride()[:2], *v.stride()[:2], *f.stride()[:2], *b.stride()[:2])
    o = q.new_empty((bsz, s, heads, K6_D), dtype=torch.float32)
    conv_p = None if conv is None else conv.data_ptr()
    state_p = None if state is None else state.data_ptr()
    rc = lib.dmel_kda_scan(q.data_ptr(), k.data_ptr(), v.data_ptr(), f.data_ptr(), b.data_ptr(),
                           (ctypes.c_longlong * 10)(*strides), *(w.data_ptr() for w in weights), a_log.data_ptr(),
                           dt_bias.data_ptr(), conv_p, conv_p, state_p, state_p, o.data_ptr(), bsz, s, heads, K6_D,
                           K6_TAPS, K6_CHUNK, float(scale), library.stream(q))
    library.check(lib, rc, "dmel_kda_scan")
    kda_scan.launches += 1
    return o


kda_scan.launches = 0  # K6 kernel launches (1 a call), counted after each call
