"""Causal grouped-query flash attention (port of `_flash_causal_attention`,
`dmel_codec_tpu/models/transformer.py`, which runs jax's Pallas TPU kernel).

`flash_attention(q, k, v)` computes, for q [B, S, H, hd] and k, v
[B, S, KH, hd] with g = H / KH query heads per KV head,

    out[b, s, h] = softmax_{t <= s}(q[b, s, h] . k[b, t, h // g] / sqrt(hd)) . v[b, t, h // g]

with float32 scores, softmax and accumulation, and the result in the input
dtype:
  * on CPU tensors it runs the plain PyTorch version,
    `flash_attention_reference`;
  * on CUDA tensors it launches the kernel FA (csrc/flash_attention.cu) or
    raises.
The kernel never forms the [S, S] score matrix in device memory, indexes
the KV head itself (no repeat of K/V) and masks a ragged last tile (no
padding of S). The backward pass differentiates the plain version.
"""

from __future__ import annotations

import math

import torch

from dmel_codec_tpu_torch.ops import library


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: float32 arithmetic, result in q's dtype."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    qg = q.float().reshape(b, s, kh, h // kh, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, -1e30), dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    lib = library.load()
    library.check_attention(q, k, v)
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    rc = lib.dmel_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, k.shape[2], hd, int(q.dtype == torch.bfloat16),
        1.0 / math.sqrt(hd), library.stream(q),
    )
    library.check(lib, rc, "dmel_flash_attention")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            return torch.autograd.grad(flash_attention_reference(*ins), ins, grad)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B, S, H, hd], k, v [B, S, KH, hd] -> [B, S, H, hd], causal."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    return _FlashAttention.apply(q, k, v)


flash_attention.launches = 0  # FA launches, counted in _launch
