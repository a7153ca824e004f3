"""One block step of the fast depth decoder, bf16 (kernel K4).

`fast_block(x, weights, cos, sin, eps)` computes a Qwen2 block
(`models/transformer.Block`) on the cache-less causal path: x [B, S, H]
through RMSNorm, q / k / v with biases, RoPE at positions 0..S-1 (`cos`,
`sin` [S, head_dim] float32, computed once per call of the decoder), causal
GQA attention over each sequence's S positions, o_proj and the residual,
then RMSNorm, the SiLU-gated MLP and the residual:
  * on a CPU tensor it runs the plain version, `fast_block_reference`: the
    module's maths written out, op for op;
  * on a CUDA tensor it launches kernel K4 (csrc/fast_block.cu: four
    launches, no grid-wide sync inside one) or raises. K4 takes bf16 and any
    batch over the sizes `shape_fault` passes: S <= 16, head sizes 32, 48,
    64 and 128, heads x head size = hidden, up to 16 heads, a multiple of
    the KV heads, hidden and intermediate sizes multiples of 32.
The weights are read where they lie (`BlockWeights.of(block)` names the
module's own parameters), so a graph that captured K4 sees later changes to
them as the module path does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from dmel_codec_tpu_torch.ops import library

# K4's launches a block step: fb_qkv_kernel, fb_attn_kernel, fb_mlp_in_kernel, fb_mlp_out_kernel
K4_LAUNCHES = 4
K4_MAX_S = 16
K4_HEAD_DIMS = (32, 48, 64, 128)


class BlockWeights(NamedTuple):
    """A Qwen2 block's parameters, as the module holds them."""

    input_norm: torch.Tensor  # [H]
    q: torch.Tensor  # [heads * hd, H]
    q_bias: torch.Tensor
    k: torch.Tensor  # [kv_heads * hd, H]
    k_bias: torch.Tensor
    v: torch.Tensor
    v_bias: torch.Tensor
    o: torch.Tensor  # [H, heads * hd]
    post_norm: torch.Tensor  # [H]
    gate: torch.Tensor  # [I, H]
    up: torch.Tensor
    down: torch.Tensor  # [H, I]

    @classmethod
    def of(cls, block) -> "BlockWeights":
        """The parameters of a `models/transformer.Block` themselves (no copies)."""
        attn, mlp = block.self_attn, block.mlp
        return cls(block.input_layernorm.weight, attn.q_proj.weight, attn.q_proj.bias, attn.k_proj.weight,
                   attn.k_proj.bias, attn.v_proj.weight, attn.v_proj.bias, attn.o_proj.weight,
                   block.post_attention_layernorm.weight, mlp.gate_proj.weight, mlp.up_proj.weight,
                   mlp.down_proj.weight)


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (weight * (xf * torch.rsqrt(var + eps))).to(x.dtype)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """`models/transformer.apply_rope` with cos / sin [S, hd] for every sequence."""
    half = x.shape[-1] // 2
    xf = x.float()
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos[..., None, :] + rotated * sin[..., None, :]).to(x.dtype)


def fast_block_reference(
    x: torch.Tensor, w: BlockWeights, cos: torch.Tensor, sin: torch.Tensor, eps: float
) -> torch.Tensor:
    """K4's function in plain PyTorch: `Block.forward` without a cache, as
    `Decoder.forward` calls it (causal mask, positions 0..S-1), op for op,
    so that it returns the module's bits."""
    b, s, _ = x.shape
    hd = cos.shape[-1]
    heads, kv_heads = w.q.shape[0] // hd, w.k.shape[0] // hd
    h = _rms_norm(x, w.input_norm, eps)
    q, k, v = F.linear(h, w.q, w.q_bias), F.linear(h, w.k, w.k_bias), F.linear(h, w.v, w.v_bias)
    q = _rope(q.reshape(b, s, heads, hd), cos, sin)
    k = _rope(k.reshape(b, s, kv_heads, hd), cos, sin)
    v = v.reshape(b, s, kv_heads, hd)
    qg = q.reshape(b, s, kv_heads, heads // kv_heads, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k) / math.sqrt(hd)
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril().expand(b, s, s)
    scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    x = x + F.linear(out.reshape(b, s, -1), w.o)
    h = _rms_norm(x, w.post_norm, eps)
    return x + F.linear(F.silu(F.linear(h, w.gate)) * F.linear(h, w.up), w.down)


def shape_fault(s: int, hidden: int, heads: int, kv_heads: int, head_dim: int, inter: int) -> str:
    """Why K4 does not take a block of these sizes over S positions, or ""
    where it does. `models/transformer.Decoder.fusable` asks it of a
    decoder's configuration, `_check` of the tensors of each call."""
    if not 1 <= s <= K4_MAX_S:
        return f"K4 takes 1 to {K4_MAX_S} positions, got S {s}"
    if head_dim not in K4_HEAD_DIMS or heads * head_dim != hidden or hidden % 32:
        return (f"K4 takes a head size in {K4_HEAD_DIMS} and heads x head size = hidden, a multiple of 32; got "
                f"{heads} heads of {head_dim}, hidden {hidden}")
    if kv_heads < 1 or heads % kv_heads or heads > 16 or inter % 32:
        return (f"K4 takes a multiple of the KV heads up to 16 heads and an intermediate size that is a multiple "
                f"of 32; got {heads} heads over {kv_heads}, intermediate {inter}")
    return ""


def _check(x: torch.Tensor, w: BlockWeights, cos: torch.Tensor, sin: torch.Tensor) -> None:
    """Raises unless K4 takes these tensors (module docstring); the device
    last, so that the shapes can be checked on `meta` tensors."""
    if x.dim() != 3 or x.numel() == 0 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"K4 takes a contiguous, non-empty bf16 [B, S, H] x, got {x.dtype} {tuple(x.shape)}")
    b, s, hidden = x.shape
    hd = cos.shape[-1] if cos.dim() == 2 else 0
    heads, kv_heads, inter = w.q.shape[0] // max(hd, 1), w.k.shape[0] // max(hd, 1), w.gate.shape[0]
    fault = shape_fault(s, hidden, heads, kv_heads, hd, inter)
    if fault:
        raise ValueError(fault)
    shapes = BlockWeights((hidden,), (hidden, hidden), (hidden,), (kv_heads * hd, hidden), (kv_heads * hd,),
                          (kv_heads * hd, hidden), (kv_heads * hd,), (hidden, hidden), (hidden,),
                          (inter, hidden), (inter, hidden), (hidden, inter))
    for name, t, shape in zip(BlockWeights._fields, w, shapes):
        if t is None or tuple(t.shape) != shape or t.dtype != torch.bfloat16 or t.device != x.device:
            got = None if t is None else (tuple(t.shape), t.dtype, t.device)
            raise ValueError(f"weight {name} must be bf16 {shape} on {x.device}, got {got}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"weight {name} must be contiguous and start on 16 bytes")
    for name, t in (("cos", cos), ("sin", sin)):
        if tuple(t.shape) != (s, hd) or t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [{s}, {hd}] on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if x.data_ptr() % 16:
        raise ValueError("x must start on 16 bytes")
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")


def fast_block(x: torch.Tensor, w: BlockWeights, cos: torch.Tensor, sin: torch.Tensor, eps: float) -> torch.Tensor:
    """[B, S, H] -> [B, S, H], `fast_block_reference`'s function: by K4 on a
    CUDA tensor, by the plain version on a CPU one."""
    if x.device.type == "cpu":
        return fast_block_reference(x, w, cos, sin, eps)
    _check(x, w, cos, sin)
    lib = library.load()
    b, s, hidden = x.shape
    hd = cos.shape[-1]
    heads, kv_heads, inter = hidden // hd, w.k.shape[0] // hd, w.gate.shape[0]
    rows = b * s
    qkv = x.new_empty((rows, (heads + 2 * kv_heads) * hd))
    x1, hid, out = x.new_empty((rows, hidden)), x.new_empty((rows, inter)), torch.empty_like(x)
    rc = lib.dmel_fast_block(
        x.data_ptr(), out.data_ptr(), qkv.data_ptr(), x1.data_ptr(), hid.data_ptr(),
        *(t.data_ptr() for t in w), cos.data_ptr(), sin.data_ptr(),
        b, s, hidden, heads, kv_heads, hd, inter, float(eps), library.stream(x),
    )
    library.check(lib, rc, "dmel_fast_block")
    fast_block.launches += K4_LAUNCHES
    return out


fast_block.launches = 0  # K4 kernel launches (4 a call), counted after each call
