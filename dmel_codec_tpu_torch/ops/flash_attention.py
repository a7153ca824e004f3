"""Causal grouped-query flash attention (port of `_flash_causal_attention`,
`dmel_codec_tpu/models/transformer.py`, which runs jax's Pallas TPU kernels,
forward and backward).

`flash_attention(q, k, v)` computes, for q [B, S, H, hd] and k, v
[B, S, KH, hd] with g = H / KH query heads per KV head,

    out[b, s, h] = softmax_{t <= s}(q[b, s, h] . k[b, t, h // g] / sqrt(hd)) . v[b, t, h // g]

with float32 scores, softmax and accumulation, and the result in the input
dtype:
  * on CPU tensors it runs the plain PyTorch versions,
    `flash_attention_reference` and, under autograd,
    `flash_attention_backward_reference`;
  * on CUDA tensors it launches the kernels or raises: FA
    (csrc/flash_attention.cu) forward, and under autograd FA-dKV and FA-dQ
    (csrc/flash_attention_bwd.cu) backward.
In bf16 the kernels run their products on the tensor cores and round the
probabilities P (before P V and P^T dO), dS (before dS^T Q) and scale * dS
(before dS K) to bf16, as jax's Pallas kernels do; the plain versions keep
them float32 (the exact float32-product functions the kernels are held
against). In float32, FA and FA-dQ run their products on the tensor cores
as split-TF32 products (each operand split into hi = tf32(x) and lo =
tf32(x - hi), three products, P and dS float32), FA-dKV on the CUDA cores.
The kernels never form the [S, S] score matrix in device memory, index the
KV head themselves (no repeat of K/V) and mask a ragged last tile (no
padding of S). Under autograd the forward also stores each row's
log-sum-exp `L` (float32 [B, H, S]); the backward recomputes the
probabilities as exp(scores - L), with D = rowsum(dO * O) taken by one
reduction outside the kernels, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from dmel_codec_tpu_torch.ops import library


def _causal_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """float32 scaled scores [B, KH, G, S, S], -1e30 above the diagonal."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    qg = q.float().reshape(b, s, kh, h // kh, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    return scores.masked_fill(~causal, -1e30)


def _attend(scores: torch.Tensor, v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """softmax(scores) . v as [B, S, H, hd] in `like`'s dtype."""
    out = torch.einsum("bkgst,btkh->bskgh", torch.softmax(scores, dim=-1), v.float())
    return out.reshape(like.shape).to(like.dtype)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: float32 arithmetic, result in q's dtype."""
    return _attend(_causal_scores(q, k), v, q)


def flash_attention_forward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward as autograd runs it: the output in q's
    dtype and the rows' float32 log-sum-exp [B, H, S]."""
    b, s, h, _ = q.shape
    scores = _causal_scores(q, k)
    return _attend(scores, v, q), torch.logsumexp(scores, dim=-1).reshape(b, h, s)


def _recompute(q, k, v, out, lse, grad):
    """What each backward kernel recomputes from its inputs, in float32:
    the grouped q [B, S, KH, G, hd] and dO, P = exp(scores - L) (0 where
    masked) and dS = P * (dO V^T - D) with D = rowsum(dO * O), both
    [B, KH, G, S, S], and the scale."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(b, s, kh, g, hd)
    do = grad.float().reshape(b, s, kh, g, hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * scale
    probs = torch.exp(scores - lse.reshape(b, kh, g, s, 1)).masked_fill(~causal, 0.0)
    delta = (grad.float() * out.float()).sum(-1).reshape(b, s, kh, g).permute(0, 2, 3, 1)
    ds = probs * (torch.einsum("bskgh,btkh->bkgst", do, v.float()) - delta[..., None])
    return qg, do, probs, ds, scale


def _dkv(k, v, qg, do, probs, ds, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    dv = torch.einsum("bkgst,bskgh->btkh", probs, do)
    dk = scale * torch.einsum("bkgst,bskgh->btkh", ds, qg)
    return dk.to(k.dtype), dv.to(v.dtype)


def _dq(q, k, ds, scale) -> torch.Tensor:
    return (scale * torch.einsum("bkgst,btkh->bskgh", ds, k.float())).reshape(q.shape).to(q.dtype)


def flash_attention_dkv_reference(q, k, v, out, lse, grad) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of FA-dKV: dV = P^T dO and dK = scale dS^T Q, summed
    over the query heads of a KV head; float32 arithmetic, results in the
    inputs' dtype."""
    return _dkv(k, v, *_recompute(q, k, v, out, lse, grad))


def flash_attention_dq_reference(q, k, v, out, lse, grad) -> torch.Tensor:
    """Plain version of FA-dQ: dQ = scale dS K; float32 arithmetic, result
    in q's dtype."""
    _, _, _, ds, scale = _recompute(q, k, v, out, lse, grad)
    return _dq(q, k, ds, scale)


def flash_attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, grad: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward pass, (dq, dk, dv): P and dS recomputed
    once from `lse`, then both kernels' products."""
    qg, do, probs, ds, scale = _recompute(q, k, v, out, lse, grad)
    dk, dv = _dkv(k, v, qg, do, probs, ds, scale)
    return _dq(q, k, ds, scale), dk, dv


def _dims(q: torch.Tensor, k: torch.Tensor) -> tuple:
    """The kernels' trailing arguments: B, S, H, KH, hd, bf16, scale, stream."""
    b, s, h, hd = q.shape
    return (b, s, h, k.shape[2], hd, int(q.dtype == torch.bfloat16),
            1.0 / math.sqrt(hd), library.stream(q))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, with_lse: bool = False):
    """Launch FA; returns (out, lse), lse None unless asked for."""
    lib = library.load()
    library.check_attention(q, k, v)
    b, s, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    rc = lib.dmel_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, *_dims(q, k),
    )
    library.check(lib, rc, "dmel_flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention_dkv(q, k, v, grad, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch FA-dKV: (dk, dv) [B, S, KH, hd] from checked CUDA tensors.
    Scratch: each query head's float32 partial dK and dV [B, H, S, hd], and
    one zeroed arrival count per (batch, KV head, key tile of 64)."""
    lib = library.load()
    b, s, h, hd = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    part_k = torch.empty((b, h, s, hd), dtype=torch.float32, device=q.device)
    part_v = torch.empty_like(part_k)
    count = torch.zeros((b, k.shape[2], -(-s // 64)), dtype=torch.int32, device=q.device)
    rc = lib.dmel_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), grad.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), part_k.data_ptr(), part_v.data_ptr(), count.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *_dims(q, k),
    )
    library.check(lib, rc, "dmel_flash_attention_bwd_dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_dq(q, k, v, grad, lse, delta) -> torch.Tensor:
    """Launch FA-dQ: dq [B, S, H, hd] from checked CUDA tensors."""
    lib = library.load()
    dq = torch.empty_like(q)
    rc = lib.dmel_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), grad.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), *_dims(q, k),
    )
    library.check(lib, rc, "dmel_flash_attention_bwd_dq")
    flash_attention_dq.launches += 1
    return dq


# The float32 launches of FA and FA-dQ (csrc/flash_attention.cu
# `tf32_smem_bytes`, csrc/flash_attention_bwd.cu `dq_tf32_smem_bytes`):
# 4 warps, and 64-row float32 tiles of hd + 4 in shared memory: FA holds Q
# and the hi and lo tiles of K and V, FA-dQ also dO.
TF32_THREADS = 128


def tf32_smem_bytes(kernel: str, hd: int) -> int:
    """Shared bytes per block of the float32 launch of "FA" or "FA-dQ"."""
    return 4 * 64 * (hd + 4) * {"FA": 5, "FA-dQ": 6}[kernel]


def launch_config(kernel: str, q: torch.Tensor) -> dict:
    """The launch that `kernel` ("FA", "FA-dKV" or "FA-dQ") makes for q of
    this shape and dtype, as the library reports it: grid, threads and
    shared bytes per block."""
    lib = library.load()
    b, s, h, hd = q.shape
    bf = int(q.dtype == torch.bfloat16)
    cfg = (ctypes.c_int * 5)()
    if kernel == "FA":
        rc = lib.dmel_flash_attention_config(b, s, h, hd, bf, cfg)
    else:
        rc = lib.dmel_flash_attention_bwd_config(["FA-dKV", "FA-dQ"].index(kernel), b, s, h, hd, bf, cfg)
    library.check(lib, rc, f"{kernel} launch configuration")
    return {"grid": tuple(cfg[:3]), "threads": cfg[3], "smem_bytes": cfg[4]}


def flash_attention_backward(q, k, v, out, lse, grad):
    """(dq, dk, dv) on CUDA tensors through FA-dQ and FA-dKV."""
    library.check_attention(q, k, v)
    grad = grad.contiguous()
    library.check_attention_grad(q, out, lse, grad)
    # D = rowsum(dO * O) as [B, H, S] beside L
    delta = (grad.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = flash_attention_dkv(q, k, v, grad, lse, delta)
    return flash_attention_dq(q, k, v, grad, lse, delta), dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cpu":
            out, lse = flash_attention_forward_reference(q, k, v)
        else:
            out, lse = _launch(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            return flash_attention_backward_reference(q, k, v, out, lse, grad)
        return flash_attention_backward(q, k, v, out, lse, grad)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B, S, H, hd], k, v [B, S, KH, hd] -> [B, S, H, hd], causal."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    return _launch(q, k, v)[0]


# launches of FA, FA-dKV and FA-dQ, each counted where its kernel is launched
flash_attention.launches = 0
flash_attention_dkv.launches = 0
flash_attention_dq.launches = 0
