"""K4 (csrc/fast_block.cu) on the card, timed beside the module path it
replaces: one block step of the flagship fast depth decoder (12 x 480, 10
heads over 2 of 48, FFN 2,880; bf16) at the LM cells' shape, x [16, 11,
480] (B = 16 sequences of 1 + 10 codebooks), and at B = 1 and 64.

The decoder's 12 blocks (each its own weights: 113 MB, more than the 50 MB
L2, as a frame reads them) are captured in one CUDA graph, once through K4
and once through the modules as `Decoder.forward` runs them, and replayed
in turns (K4, modules, modules, K4); per block step: us, weight bytes over
the time (GB/s, against 3.35 TB/s), kernel launches (K4's count; the
modules' from a profiler over one eager step) and K4's device time by
kernel. The bound is 9.4 MB / 3.35 TB/s = 2.8 us a step. K4's check
against its plain version is tests/test_torch_card_lm.py's.

    python -m dmel_codec_tpu_torch.probes.fast_block_times

Prints each row; `main()` returns them.
"""

from __future__ import annotations

import torch

from dmel_codec_tpu_torch.models.transformer import FAST_LM_CONFIG, Block, rope_cos_sin
from dmel_codec_tpu_torch.ops import library
from dmel_codec_tpu_torch.ops.fast_block import BlockWeights, fast_block
from dmel_codec_tpu_torch.probes.timing import PEAK_BYTES, cuda_ms, require_gpu

CFG = FAST_LM_CONFIG
S = 11  # 1 + 10 codebooks


def _blocks(n: int, dev) -> list:
    """n blocks with the benchmark's draw: dense N(0, 1 / fan_in), biases
    N(0, 0.02^2), norms 1 + N(0, 0.02^2); bf16 on the card."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for _ in range(n):
        with torch.device(dev):
            block = Block(CFG)
        with torch.no_grad():
            for name, p in block.named_parameters():
                noise = torch.randn(p.shape, device=dev, generator=gen)
                p.copy_(noise / p.shape[1] ** 0.5 if p.dim() == 2 else
                        1.0 + 0.02 * noise if name.endswith("layernorm.weight") else 0.02 * noise)
        out.append(block.to(torch.bfloat16).eval())
    return out


def _x(b: int, dev, seed: int = 1) -> torch.Tensor:
    return torch.randn((b, S, CFG.hidden_size), device=dev, generator=torch.Generator(device=dev).manual_seed(seed)).bfloat16()


def _module_kernels(block: Block, x, cos_b, sin_b, mask) -> int:
    """CUDA kernels of one eager module block step (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        block(x, cos_b, sin_b, mask, None, None, True)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def _graph_kernels(graph, steps: int, replays: int = 5) -> dict:
    """Device microseconds a block step of each kernel in `graph`'s replays
    (torch.profiler; {} where it records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
        if us and "fb_" in e.key:
            name = next((k for k in ("fb_qkv", "fb_attn", "fb_mlp_in", "fb_mlp_out") if k in e.key), e.key[:40])
            out[name] = out.get(name, 0.0) + us / replays / steps
    return out


def steps(dev, reps: int, batches=(16, 1, 64)) -> list:
    """12 block steps a graph replay, K4 against the modules, in turns."""
    blocks = _blocks(CFG.num_layers, dev)
    weights = [BlockWeights.of(blk) for blk in blocks]
    step_bytes = 2 * sum(p.numel() for p in blocks[0].parameters())
    cos, sin = rope_cos_sin(torch.arange(S, device=dev), CFG.head_dim, CFG.rope_theta)
    rows = []
    for b in batches:
        x = _x(b, dev)
        cos_b, sin_b = rope_cos_sin(torch.arange(S, device=dev).expand(b, S), CFG.head_dim, CFG.rope_theta)
        mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril().expand(b, S, S)

        def k4():
            y = x
            for w in weights:
                y = fast_block(y, w, cos, sin, CFG.rms_norm_eps)
            return y

        def modules():
            y = x
            for blk in blocks:
                y = blk(y, cos_b, sin_b, mask, None, None, True)
            return y

        graphs, launches = {}, {}
        for name, fn in (("k4", k4), ("modules", modules)):
            with torch.no_grad():
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    fn()
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                before = fast_block.launches
                with torch.cuda.graph(graph):
                    fn()
                launches[name] = (fast_block.launches - before) / len(blocks)
            graphs[name] = graph
        launches["modules"] = _module_kernels(blocks[0], x, cos_b, sin_b, mask)
        ms = {"k4": [], "modules": []}
        for name in ("k4", "modules", "modules", "k4"):
            ms[name].append(cuda_ms(graphs[name].replay, reps))
        row = {"b": b, "shape": (b, S, CFG.hidden_size), "launches_k4": launches["k4"],
               "launches_modules": launches["modules"], "bound_us": step_bytes / PEAK_BYTES * 1e6}
        for name in ("k4", "modules"):
            us = min(ms[name]) / len(blocks) * 1e3
            row[f"{name}_us"] = us
            row[f"{name}_runs_us"] = [m / len(blocks) * 1e3 for m in ms[name]]
            row[f"{name}_gbps"] = step_bytes / us / 1e3
        row["k4_kernels_us"] = _graph_kernels(graphs["k4"], len(blocks))
        rows.append(row)
        print(f"block step [{b}, {S}, {CFG.hidden_size}] bf16: K4 {row['k4_us']:.2f} us "
              f"({row['k4_gbps']:.0f} GB/s, {row['launches_k4']:.0f} launches; runs "
              f"{', '.join(f'{u:.2f}' for u in row['k4_runs_us'])}), modules {row['modules_us']:.2f} us "
              f"({row['modules_gbps']:.0f} GB/s, {row['launches_modules']} kernels; runs "
              f"{', '.join(f'{u:.2f}' for u in row['modules_runs_us'])}); x{row['modules_us'] / row['k4_us']:.2f}; "
              f"bound {row['bound_us']:.2f} us ({step_bytes / 1e6:.2f} MB at {PEAK_BYTES / 1e12:.2f} TB/s; K4 at "
              f"{row['bound_us'] / row['k4_us'] * 100:.1f} % of it); K4 by kernel (device us a step, profiler): "
              f"{', '.join(f'{k} {v:.2f}' for k, v in row['k4_kernels_us'].items())}", flush=True)
        del graphs
    return rows


def main() -> list:
    require_gpu("fast_block_times")
    library.build()
    print(torch.cuda.get_device_name(0), flush=True)
    return steps(torch.device("cuda"), 50)


if __name__ == "__main__":
    main()
