"""K6 (csrc/kda_scan.cu) on the card, timed beside the plain chunked core
it replaces: one KDA layer of Kimi-Linear-48B-A3B (32 heads of 128, 4-tap
convolutions, hidden 2,304) at the long-dialog prefill, B = 16 rows of
12,343 positions from a zero cache, bf16 weights (A_log and dt_bias
float32, as the benchmark draws them).

Rows, in turns: K6's kernel alone and through its wrapper (`kda_scan`:
the checks, A_log / dt_bias as float32, o's allocation); the plain core
over the same span of work (`kda_scan_reference`, projections' outputs to
o, two rows a call: every head at once at 16 rows would hold ~50 GB); and
the whole layer call (projections, core, gated norm, o_proj) on K6 against
the plain `_chunked` (heads in groups of GROUP_BYTES) the model ran
before. The bound is `benchmark/counts/kda.py` `scan_work`'s for one
layer's positions: max(its products at the bf16 peak, its bytes at 3.35
TB/s).

    python -m dmel_codec_tpu_torch.probes.kda_scan_times

Prints each row; `main()` returns them.
"""

from __future__ import annotations

import ctypes

import torch

from dmel_codec_tpu_torch.models.kimi_linear import CHUNK, KimiDeltaAttention
from dmel_codec_tpu_torch.models.transformer import TransformerConfig
from dmel_codec_tpu_torch.ops import kda_scan as k6
from dmel_codec_tpu_torch.ops import library
from dmel_codec_tpu_torch.probes.timing import PEAK_BF16, PEAK_BYTES, cuda_ms, require_gpu

B, S, HEADS, D, HIDDEN = 16, 12343, 32, 128, 2304
LAYER = TransformerConfig(vocab_size=64, hidden_size=HIDDEN, intermediate_size=9216, num_layers=1, num_heads=HEADS,
                          num_kv_heads=HEADS, rms_norm_eps=1e-5, kind="kimi_linear", kda_layers=(0,),
                          kda_num_heads=HEADS, kda_head_dim=D, kda_conv_size=4)


def bound_ms(b: int = B, s: int = S) -> float:
    """`scan_work`'s bound of one layer call: (4 C d + 3 d^2) multiply-adds
    a position and head; q, k, v at bf16 and the gates (d) and beta (1) in
    float32 read once, o at bf16 written once, the final state once."""
    positions = b * s
    flops = 2.0 * (4 * CHUNK * D + 3 * D * D) * HEADS * positions
    nbytes = positions * HEADS * (4 * D * 2 + (D + 1) * 4) + b * HEADS * D * D * 4
    return max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3


def _layer(dev) -> KimiDeltaAttention:
    torch.manual_seed(0)
    with torch.device(dev):
        layer = KimiDeltaAttention(LAYER)
        layer.reset_gates()
    layer.to(torch.bfloat16).eval()
    layer.A_log.data, layer.dt_bias.data = layer.A_log.data.float(), layer.dt_bias.data.float()
    return layer


def _cache(dev):
    return (torch.zeros((B, HEADS, D, D), device=dev),
            torch.zeros((B, 3, 3 * HEADS * D), device=dev, dtype=torch.bfloat16))


def _kernel_alone(args, conv, state):
    """K6's launch without the wrapper's checks, casts and allocation."""
    q, k, v, f, beta, weights, a_log, dt_bias, scale = args
    lib, o = library.load(), q.new_empty((B, S, HEADS, D), dtype=torch.float32)
    strides = (ctypes.c_longlong * 10)(*q.stride()[:2], *k.stride()[:2], *v.stride()[:2], *f.stride()[:2],
                                       *beta.stride()[:2])
    ptrs = [t.data_ptr() for t in (q, k, v, f, beta)]
    rest = [*(w.data_ptr() for w in weights), a_log.data_ptr(), dt_bias.data_ptr(), conv.data_ptr(), conv.data_ptr(),
            state.data_ptr(), state.data_ptr(), o.data_ptr()]
    stream = library.stream(q)
    return lambda: lib.dmel_kda_scan(*ptrs, strides, *rest, B, S, HEADS, D, 4, CHUNK, scale, stream)


@torch.no_grad()
def rows(dev, reps: int) -> dict:
    layer = _layer(dev)
    x = torch.randn((B, S, HIDDEN), device=dev, generator=torch.Generator(device=dev).manual_seed(1)).bfloat16()
    projs, convs = layer._projections()
    args = (*(p(x) for p in projs), layer.f_b_proj(layer.f_a_proj(x)), layer.b_proj(x), [c.weight for c in convs],
            layer.A_log, layer.dt_bias, layer.scale)
    cache = _cache(dev)
    plain_layer = _layer(dev)
    plain_layer.k6_takes = lambda *_: False

    def plain_core():
        state, conv = cache
        for i in range(0, B, 2):
            part = [t[i:i + 2] for t in args[:5]]
            k6.kda_scan_reference(*part, *args[5:], conv[i:i + 2], state[i:i + 2])

    fns = {"kernel": _kernel_alone(args, cache[1], cache[0]), "wrapper": lambda: k6.kda_scan(*args, cache[1], cache[0]),
           "plain": plain_core, "layer_k6": lambda: layer(x, cache), "layer_plain": lambda: plain_layer(x, cache)}
    counts = {"kernel": reps, "wrapper": reps, "plain": 1, "layer_k6": max(1, reps // 2), "layer_plain": 1}
    ms = {name: [] for name in fns}
    for name in ("kernel", "wrapper", "plain", "layer_k6", "layer_plain", "layer_plain", "layer_k6", "plain", "wrapper",
                 "kernel"):
        ms[name].append(cuda_ms(fns[name], counts[name]))
    torch.cuda.reset_peak_memory_stats()
    layer(x, _cache(dev))
    peak_k6 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plain_layer(x, _cache(dev))
    peak_plain = torch.cuda.max_memory_allocated()
    row = {"b": B, "s": S, "bound_ms": bound_ms(), **{f"{n}_ms": min(v) for n, v in ms.items()},
           **{f"{n}_runs_ms": v for n, v in ms.items()}, "layer_peak_gb_k6": peak_k6 / 1e9,
           "layer_peak_gb_plain": peak_plain / 1e9}
    print(f"B {B}, S {S}, {HEADS} heads of {D}: K6 kernel {row['kernel_ms']:.3f} ms ({row['bound_ms'] / row['kernel_ms'] * 100:.2f} "
          f"% of the {row['bound_ms']:.3f} ms bound), wrapper {row['wrapper_ms']:.3f}, plain core {row['plain_ms']:.1f}; "
          f"layer on K6 {row['layer_k6_ms']:.1f} ms (peak {row['layer_peak_gb_k6']:.2f} GB), plain layer "
          f"{row['layer_plain_ms']:.1f} ms (peak {row['layer_peak_gb_plain']:.2f} GB); runs {ms}", flush=True)
    return row


def main() -> dict:
    require_gpu("kda_scan_times")
    library.build()
    print(torch.cuda.get_device_name(0), flush=True)
    return rows(torch.device("cuda"), 6)


if __name__ == "__main__":
    main()
