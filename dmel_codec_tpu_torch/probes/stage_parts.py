"""Where K2's and K2-v1's time goes: K2's kernels (bf16
csrc/stage_fused_tc.cu, float32 split-TF32 csrc/stage_fused_tf32.cu) with
parts removed, 18 launches of a stage at a time, at the flagship vocoder's
fused stages of one codec request (16 clips x 4 s) and of one streaming
window (1 x 560 frames); then K2-v1 (csrc/stage_fused_v1.cu, a cluster of
tiles), one launch a stage, at s4 and s5; each kernel in bf16 and in
float32.

  full        the launch as the vocoder runs it
  products    the weight stream and the tensor-core products, no activation
  activation  the activation into the staged tile, no weights or products
  epilogue    neither: the stores (bias, residual, running sum) alone; for
              K2-v1 the loads, the halo exchanges and barriers and the stores

    python -m dmel_codec_tpu_torch.probes.stage_parts

prints ms per stage of each (CUDA events) and, per kernel, dtype and
request / window, the sums and what each part adds to the epilogue alone;
`main()` returns the table, keyed by ("K2 bf16 request s2", B, C, T) and
so on. The dropped parts leave the output wrong: only `full` is the
kernel.
"""

from __future__ import annotations

import math

import torch

from dmel_codec_tpu_torch.ops import stage_fused
from dmel_codec_tpu_torch.ops.stage_fused import StageSpec
from dmel_codec_tpu_torch.probes.timing import cuda_ms, require_gpu

PARTS = {"full": 3, "products": 2, "activation": 1, "epilogue": 0}
# (name, B, C, T): s2..s5 of a 16 x 4 s request (372 mel frames) and of a streaming window (560 frames)
SHAPES = tuple((f"request s{i}", 16, c, 372 * r) for i, c, r in ((2, 192, 32), (3, 96, 64), (4, 48, 128), (5, 24, 256)))
SHAPES += tuple((f"window s{i}", 1, c, 560 * r) for i, c, r in ((2, 192, 32), (3, 96, 64), (4, 48, 128), (5, 24, 256)))


def random_pack(c: int, gen: torch.Generator, device) -> dict:
    """`pack_stage`-shaped arrays from a seeded generator."""
    spec = StageSpec(channels=c)
    ws = [torch.randn((k, c, c), device=device, generator=gen) / math.sqrt(k * c)
          for k in spec.kernel_sizes for _ in range(6)]
    return {"w": ws, "b": 0.05 * torch.randn((c, 18), device=device, generator=gen),
            "a": torch.exp(0.1 * torch.randn((c, 18), device=device, generator=gen)),
            "ib": 1.0 / (torch.exp(0.1 * torch.randn((c, 18), device=device, generator=gen)) + 1e-9)}


def stage_parts_ms(x: torch.Tensor, packed: dict, spec: StageSpec, reps: int = 3) -> dict:
    """ms of one K2 stage (18 launches) by what the launches keep."""
    with torch.no_grad():
        return {name: cuda_ms(lambda p=p: stage_fused._run_kernel(x, packed, spec, parts=p), reps)
                for name, p in PARTS.items()}


def v1_parts_ms(x: torch.Tensor, packed: dict, spec: StageSpec, reps: int = 3) -> dict:
    """ms of one K2-v1 stage (one launch) by what the launch keeps."""
    with torch.no_grad():
        return {name: cuda_ms(lambda p=p: stage_fused._run_kernel_v1(x, packed, spec, parts=p), reps)
                for name, p in PARTS.items()}


def main() -> dict:
    require_gpu("stage_parts")
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = {}
    print(f"{'stage [B, C, T]':<40}" + "".join(f"{name:>12}" for name in PARTS) + "   (ms per stage)")
    for kernel, fn in (("K2", stage_parts_ms), ("K2-v1", v1_parts_ms)):
        for name, b, c, t in SHAPES:
            if kernel == "K2-v1" and c > stage_fused.V1_MAX_CHANNELS:
                continue
            spec = StageSpec(channels=c)
            packed = random_pack(c, gen, "cuda")
            x = torch.randn((b, c, t), device="cuda", generator=gen)
            for dt in (torch.bfloat16, torch.float32):
                what = f"{kernel} {'bf16' if dt == torch.bfloat16 else 'float32'} {name}"
                row = table[(what, b, c, t)] = fn(x.to(dt), packed, spec)
                print(f"{what + ' ' + str([b, c, t]):<40}" + "".join(f"{row[p]:12.3f}" for p in PARTS))
    for group in sorted({key[0].rsplit(" ", 1)[0] for key in table}):
        total = {p: sum(row[p] for key, row in table.items() if key[0].rsplit(" ", 1)[0] == group) for p in PARTS}
        print(f"{group}: " + ", ".join(f"{p} {v:.3f} ms" for p, v in total.items())
              + f"; over the epilogue: activation {total['activation'] - total['epilogue']:.3f}, products "
              f"{total['products'] - total['epilogue']:.3f}")
    return table


if __name__ == "__main__":
    main()
