"""The attention core of multi-head latent attention's expanded form (kernel K5).

`models/deepseek_v3.LatentAttention` takes its expanded form in every call
over several positions: the keys' latents expanded per head by `kv_b_proj`
into k_nope and the values, beside the heads' shared rope key k_pe. The
core is, for query (b, s) and head h, over the keys t the mask lets through:

  out[b, s, h] = softmax_t([q_nope | q_pe] . [k_nope | k_pe] * scale) . value

  * `expanded_attention` is that core in plain PyTorch given any mask
    [B, S, T] bool: the queries in chunks of at most `score_elements`
    float32 scores, each chunk's scores rounded to the operands' dtype by
    the product, scaled and masked in float32, a float32 softmax, the
    probabilities rounded to the values' dtype before their product;
  * `mla_attention_reference` is the same core given the positions of the
    decoder's own causal mask (`Decoder.forward`: key t visible to query
    (b, s) iff t <= positions[b, s]), the mask built from them;
  * `mla_attention` takes those positions too: on a CPU tensor it runs the
    plain version, on a CUDA tensor it launches kernel K5
    (csrc/mla_attention.cu: one launch a call) or raises. K5 takes bf16
    operands of the head sizes `shape_fault` passes (nope 128 + rope 64,
    values 128) and positions >= 0; it computes the scores in float32
    from the bf16 operands (the plain version rounds them to bf16 first),
    skips the keys past a block's largest position, and rounds P to bf16
    before P V as the plain version rounds its probabilities.
"""

from __future__ import annotations

import ctypes

import torch

from dmel_codec_tpu_torch.ops import library

# Largest score block of the plain version ([B, heads, queries, keys] in
# float32: 1 GiB); longer calls take their queries in chunks.
SCORE_ELEMENTS = 1 << 28
K5_NOPE, K5_ROPE, K5_V = 128, 64, 128  # the head sizes K5 is built for (Moonlight's, DeepSeek-V3's)


def expanded_attention(q_nope, q_pe, k_nope, k_pe, value, mask, scale: float,
                       score_elements: int = SCORE_ELEMENTS) -> torch.Tensor:
    """q_nope [B, S, heads, nope], q_pe [B, S, heads, rope], k_nope
    [B, T, heads, nope], k_pe [B, T, rope] (shared by the heads), value
    [B, T, heads, v], mask [B, S, T] bool -> [B, S, heads, v], in the
    promotion of the queries' and k_pe's dtypes."""
    b, s, nh, _ = q_nope.shape
    t, rope = k_nope.shape[1], k_pe.shape[-1]
    dtype = torch.promote_types(q_nope.dtype, k_pe.dtype)
    # heads first, once: [B, heads, T, d]
    keys = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, t, nh, rope).to(k_nope.dtype)], dim=-1)
    keys = keys.to(dtype).transpose(1, 2).contiguous()
    value = value.to(dtype).transpose(1, 2).contiguous()
    queries = torch.cat([q_nope, q_pe], dim=-1).to(dtype).transpose(1, 2)  # [B, heads, S, d]
    step = max(1, score_elements // (b * nh * t))
    out = []
    for i in range(0, s, step):
        scores = torch.matmul(queries[:, :, i:i + step], keys.transpose(-1, -2)).float() * scale
        scores = torch.where(mask[:, None, i:i + step, :], scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(dtype)
        out.append(torch.matmul(probs, value))  # [B, heads, chunk, v]
    return (out[0] if len(out) == 1 else torch.cat(out, dim=2)).transpose(1, 2)


def mla_attention_reference(q_nope, q_pe, k_nope, k_pe, value, positions, scale: float,
                            score_elements: int = SCORE_ELEMENTS) -> torch.Tensor:
    """K5's function in plain PyTorch: `expanded_attention` under the mask
    key t <= positions[b, s] (positions [B, S] integer)."""
    mask = torch.arange(k_nope.shape[1], device=positions.device) <= positions[:, :, None]
    return expanded_attention(q_nope, q_pe, k_nope, k_pe, value, mask, scale, score_elements)


def shape_fault(heads: int, nope: int, rope: int, v: int) -> str:
    """Why K5 does not take latent attention of these head sizes, or ""
    where it does. `LatentAttention` asks it of its configuration, `_check`
    of the tensors of each call."""
    if (nope, rope, v) != (K5_NOPE, K5_ROPE, K5_V):
        return (f"K5 takes query / key heads of {K5_NOPE} + {K5_ROPE} and value heads of {K5_V}; got nope {nope}, "
                f"rope {rope}, value {v}")
    if not 1 <= heads <= 65535:
        return f"K5 takes 1 to 65535 heads, got {heads}"
    return ""


def _check(q_nope, q_pe, k_nope, k_pe, value, positions) -> None:
    """Raises unless K5 takes these tensors (module docstring); the device
    and then the positions' sign last, so that the shapes can be checked on
    `meta` tensors."""
    if q_nope.dim() != 4 or q_nope.numel() == 0:
        raise ValueError(f"q_nope must be a non-empty [B, S, heads, nope] tensor, got {tuple(q_nope.shape)}")
    b, s, nh, nope = q_nope.shape
    if k_nope.dim() != 4 or k_nope.numel() == 0:
        raise ValueError(f"k_nope must be a non-empty [B, T, heads, nope] tensor, got {tuple(k_nope.shape)}")
    t, rope, v = k_nope.shape[1], q_pe.shape[-1], value.shape[-1]
    fault = shape_fault(nh, nope, rope, v)
    if fault:
        raise ValueError(fault)
    if b > 65535:
        raise ValueError(f"K5 takes a batch of at most 65535, got {b}")
    shapes = {"q_pe": (b, s, nh, rope), "k_nope": (b, t, nh, nope), "k_pe": (b, t, rope), "value": (b, t, nh, v)}
    for name, x, shape in (("q_nope", q_nope, (b, s, nh, nope)), ("q_pe", q_pe, shapes["q_pe"]),
                           ("k_nope", k_nope, shapes["k_nope"]), ("k_pe", k_pe, shapes["k_pe"]),
                           ("value", value, shapes["value"])):
        if tuple(x.shape) != shape or x.dtype != torch.bfloat16 or x.device != q_nope.device:
            raise ValueError(f"{name} must be bf16 {shape} on {q_nope.device}, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")
    for name, x in (("q_nope", q_nope), ("q_pe", q_pe), ("k_nope", k_nope), ("k_pe", k_pe), ("value", value)):
        if x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:-1]) or x.data_ptr() % 16:
            raise ValueError(f"{name}'s rows must be contiguous and start on 16 bytes (strides multiples of 8 "
                             f"elements), got strides {x.stride()}")
    if tuple(positions.shape) != (b, s) or positions.dtype.is_floating_point or positions.device != q_nope.device:
        raise ValueError(f"positions must be integer [{b}, {s}] on {q_nope.device}, got {positions.dtype} "
                         f"{tuple(positions.shape)} on {positions.device}")
    if q_nope.device.type != "cuda":
        raise ValueError(f"q_nope must be a CUDA tensor, got {q_nope.device}")
    if int(positions.min()) < 0:
        raise ValueError("K5 takes positions >= 0: every query sees key 0")


def mla_attention(q_nope, q_pe, k_nope, k_pe, value, positions, scale: float) -> torch.Tensor:
    """-> [B, S, heads, v], `mla_attention_reference`'s function: by K5 on
    a CUDA tensor (reading the operands where they lie), by the plain
    version on a CPU one."""
    if q_nope.device.type == "cpu":
        return mla_attention_reference(q_nope, q_pe, k_nope, k_pe, value, positions, scale)
    _check(q_nope, q_pe, k_nope, k_pe, value, positions)
    lib = library.load()
    b, s, nh, nope = q_nope.shape
    t, rope = k_nope.shape[1], k_pe.shape[-1]
    strides = (*q_nope.stride()[:3], *q_pe.stride()[:3], *k_nope.stride()[:3], *k_pe.stride()[:2],
               *value.stride()[:3])
    pos = positions.to(torch.int32).contiguous()
    out = q_nope.new_empty((b, s, nh, K5_V))
    rc = lib.dmel_mla_attention(q_nope.data_ptr(), q_pe.data_ptr(), k_nope.data_ptr(), k_pe.data_ptr(),
                                value.data_ptr(), pos.data_ptr(), out.data_ptr(), (ctypes.c_longlong * 14)(*strides),
                                b, s, t, nh, nope, rope, value.shape[-1], float(scale), library.stream(q_nope))
    library.check(lib, rc, "dmel_mla_attention")
    mla_attention.launches += 1
    return out


mla_attention.launches = 0  # K5 kernel launches (1 a call), counted after each call
