"""K5 (csrc/mla_attention.cu) on the card, timed beside the plain chunked
core it replaces and, as a yardstick only, one PyTorch call for the same
function: the core of latent attention's expanded form at Moonlight's heads
(16 of 128 + 64 / 128) in the dialog prefill, B rows of 3,127 positions
into a 4,096-position cache at index 0 (B = 16, the cell's, and B = 1).

Rows: K5's wrapper (`mla_attention`: the kernel, the positions' check and
their int32 copy) and the kernel alone, in turns with the plain version
(`mla_attention_reference`), and `scaled_dot_product_attention` with
`is_causal` over the prompt's 3,127 keys (the port never calls it). The
bound is the two products over the visible (query, key) pairs, 2 x (192 +
128) flops each, at the bf16 peak (the bytes of K and V take less).

    python -m dmel_codec_tpu_torch.probes.mla_attention_times

Prints each row; `main()` returns them.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from dmel_codec_tpu_torch.ops import library
from dmel_codec_tpu_torch.ops.mla_attention import mla_attention, mla_attention_reference
from dmel_codec_tpu_torch.probes.timing import PEAK_BF16, cuda_ms, require_gpu

HEADS, S, T = 16, 3127, 4096
SCALE = 1 / math.sqrt(192)


def _inputs(b: int, dev, seed: int = 0):
    """The operands as LatentAttention hands them over (views of the
    projections' outputs), N(0, 1), and the positions 0 .. S - 1."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, device=dev, generator=gen).bfloat16()

    q, q_pe, kvb, kv = draw(b, S, HEADS, 192), draw(b, S, HEADS, 64), draw(b, T, HEADS, 256), draw(b, T, 576)
    return q[..., :128], q_pe, kvb[..., :128], kv[..., 512:], kvb[..., 128:], torch.arange(S, device=dev).expand(b, S)


def _kernel_alone(args):
    """K5's launch without the wrapper's checks and copies."""
    q_nope, q_pe, k_nope, k_pe, value, positions = args
    lib, b = library.load(), q_nope.shape[0]
    pos = positions.to(torch.int32).contiguous()
    out = q_nope.new_empty((b, S, HEADS, 128))
    strides = (ctypes.c_longlong * 14)(*q_nope.stride()[:3], *q_pe.stride()[:3], *k_nope.stride()[:3],
                                       *k_pe.stride()[:2], *value.stride()[:3])
    stream = library.stream(q_nope)
    ptrs = [t.data_ptr() for t in (q_nope, q_pe, k_nope, k_pe, value, pos, out)]
    return lambda: lib.dmel_mla_attention(*ptrs, strides, b, S, T, HEADS, 128, 64, 128, SCALE, stream)


def rows(dev, reps: int) -> list:
    out = []
    for b in (16, 1):
        args = _inputs(b, dev)
        q_nope, q_pe, k_nope, k_pe, value, _ = args
        q = torch.cat([q_nope, q_pe], -1).transpose(1, 2)
        k = torch.cat([k_nope, k_pe[:, :, None].expand(b, T, HEADS, 64)], -1)[:, :S].transpose(1, 2)
        v = value[:, :S].transpose(1, 2)
        fns = {"wrapper": lambda: mla_attention(*args, SCALE), "kernel": _kernel_alone(args),
               "plain": lambda: mla_attention_reference(*args, SCALE),
               "sdpa": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=SCALE)}
        ms = {name: [] for name in fns}
        for name in ("kernel", "wrapper", "plain", "sdpa", "sdpa", "plain", "wrapper", "kernel"):
            ms[name].append(cuda_ms(fns[name], reps if name != "plain" else 3))
        flops = 2 * (192 + 128) * b * HEADS * S * (S + 1) / 2
        row = {"b": b, "bound_ms": flops / PEAK_BF16 * 1e3, **{f"{n}_ms": min(v) for n, v in ms.items()},
               **{f"{n}_runs_ms": v for n, v in ms.items()}}
        out.append(row)
        print(f"B {b}, S {S}, T {T}, 16 heads: K5 kernel {row['kernel_ms']:.4f} ms "
              f"({flops / row['kernel_ms'] / 1e9:.1f} TFLOP/s, {row['bound_ms'] / row['kernel_ms'] * 100:.1f} % of the "
              f"{row['bound_ms']:.4f} ms bound), wrapper {row['wrapper_ms']:.4f}, plain {row['plain_ms']:.3f}, "
              f"SDPA {row['sdpa_ms']:.4f} (yardstick); runs {ms}", flush=True)
    return out


def main() -> list:
    require_gpu("mla_attention_times")
    library.build()
    print(torch.cuda.get_device_name(0), flush=True)
    return rows(torch.device("cuda"), 20)


if __name__ == "__main__":
    main()
