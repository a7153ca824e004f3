"""K3 (csrc/stage_conv_tf32.cu) on the card: against its plain version, then
timed beside what it replaced, at the flagship vocoder's per-block stages
(s0: C = 768, s1: C = 384) of a `codec.batch16.f32` request padded to 6 s
(B = 16, 560 mel frames: T = 2,240 and 8,960).

  check    K3 against `stage_conv_reference` (cuDNN's float32 conv, TF32
           off) and both against float64, at s0 / s1 shapes with B 1 and
           16, T = 375, 2,240 and 36,000, T under the reach (24 at k = 11,
           d = 5), a ragged C = 40, and each epilogue (res, acc_in,
           mean_of 3); the largest error over max(1, max |float64|)
  convs    per (k, d) of a stage, 6 convs of each: K3 and `F.conv1d` with
           its bias (float32, TF32 off), ms, beside the bound at three TF32
           products and at the CUDA-core rate
  stages   one resblock group (18 convs): the "block" route as it ran
           before K3 (`AMPBlock1.forward`: K1, cuDNN, the adds), the route
           now (K1 -> K3), and K2 (`amp_stage`, the stage packed for it,
           which its planner tiles as blocks of 192 output channels)

    python -m dmel_codec_tpu_torch.probes.conv_times [--quick]

`--quick` runs `check` alone at small reps. Prints each row; `main()`
returns the table.
"""

from __future__ import annotations

import math
import sys

import torch
import torch.nn.functional as F

from dmel_codec_tpu_torch.ops import library
from dmel_codec_tpu_torch.ops.stage_conv import conv_plan, conv_weights, stage_conv, stage_conv_reference
from dmel_codec_tpu_torch.probes.timing import PEAK_F32, PEAK_TF32, cuda_ms, require_gpu

FRAMES = 560  # a 6 s clip: the padded length of codec.batch16.f32's longest requests
STAGES = ((0, 768, 4 * FRAMES), (1, 384, 16 * FRAMES))
KD = ((3, 1), (3, 3), (3, 5), (7, 1), (7, 3), (7, 5), (11, 1), (11, 3), (11, 5))
TOL = 2e-5  # of max(1, max |float64|): K2's float32 tolerance (tests/card.py)


def _conv(gen, c: int, k: int, dev):
    w = torch.randn((c, c, k), device=dev, generator=gen) / math.sqrt(c * k)
    return w, 0.05 * torch.randn((c,), device=dev, generator=gen)


def check(gen, dev) -> list:
    """K3 against its plain version and float64 at the shapes the module
    docstring names; raises past TOL."""
    cases = [(1, 768, 375, 11, 5), (1, 768, 2240, 3, 1), (16, 768, 2240, 11, 5), (16, 384, 8960, 7, 3),
             (1, 384, 36000, 11, 5), (16, 768, 36000, 3, 3), (1, 768, 24, 11, 5), (2, 40, 700, 7, 3),
             (1, 384, 375, 3, 1)]
    rows = []
    for i, (b, c, t, k, d) in enumerate(cases):
        w, bias = _conv(gen, c, k, dev)
        a = torch.randn((b, c, t), device=dev, generator=gen)
        extra = {}
        if i % 3 == 1:
            extra = {"res": torch.randn_like(a)}
        elif i % 3 == 2:
            extra = {"res": torch.randn_like(a), "acc_in": torch.randn_like(a), "mean_of": 3}
        got = stage_conv(a, w, bias, d, **extra)
        want = stage_conv_reference(a, w, bias, d, **extra)
        ext64 = {key: (v.double() if torch.is_tensor(v) else v) for key, v in extra.items()}
        exact = stage_conv_reference(a.double(), w.double(), bias.double(), d, **ext64)
        floor = max(1.0, exact.abs().max().item())
        row = {"shape": (b, c, t, k, d), "epilogue": sorted(extra), "plan": tuple(conv_plan(b, c, t, k, d)[:2]),
               "k3_vs_plain": (got - want).abs().max().item() / floor,
               "k3_vs_f64": (got.double() - exact).abs().max().item() / floor,
               "plain_vs_f64": (want.double() - exact).abs().max().item() / floor,
               "k3_rms_vs_f64": ((got.double() - exact).square().mean().sqrt() / exact.square().mean().sqrt()).item()}
        rows.append(row)
        print(f"check {row['shape']} {row['epilogue']} plan {row['plan']}: K3 vs plain {row['k3_vs_plain']:.3e}, "
              f"K3 vs f64 {row['k3_vs_f64']:.3e} (rms {row['k3_rms_vs_f64']:.3e}), plain vs f64 "
              f"{row['plain_vs_f64']:.3e}", flush=True)
        again = stage_conv(a, w, bias, d, **extra)
        assert torch.equal(got, again), "K3 is not the same bits from run to run"
        assert row["k3_vs_plain"] <= TOL and row["k3_vs_f64"] <= TOL, row
        del a, got, want, exact, again, extra
    torch.cuda.empty_cache()
    return rows


def convs(gen, dev, reps: int) -> list:
    """K3 against cuDNN's float32 conv, one conv of each (k, d) at s0 / s1."""
    rows = []
    b = 16
    for i, c, t in STAGES:
        a = torch.randn((b, c, t), device=dev, generator=gen)
        for k, d in KD:
            w, bias = _conv(gen, c, k, dev)
            packed = conv_weights(w)
            ms_k3 = cuda_ms(lambda: stage_conv(a, w, bias, d, packed=packed), reps)
            ms_lib = cuda_ms(lambda: F.conv1d(a, w, bias, padding=d * (k - 1) // 2, dilation=d), reps)
            flops = 2 * c * c * k * b * t
            row = {"stage": f"s{i}", "shape": (b, c, t, k, d), "k3_ms": ms_k3, "library_ms": ms_lib,
                   "bound_tf32x3_ms": 3 * flops / PEAK_TF32 * 1e3, "bound_f32_ms": flops / PEAK_F32 * 1e3,
                   "k3_model_tflops": flops / ms_k3 / 1e9, "library_model_tflops": flops / ms_lib / 1e9}
            rows.append(row)
            print(f"conv s{i} [{b}, {c}, {t}] k {k} d {d}: K3 {ms_k3:.3f} ms ({row['k3_model_tflops']:.1f} "
                  f"TFLOP/s of model work), F.conv1d {ms_lib:.3f} ms ({row['library_model_tflops']:.1f}); bound "
                  f"{row['bound_tf32x3_ms']:.3f} (3 TF32 products), {row['bound_f32_ms']:.3f} (CUDA cores); "
                  f"x{ms_lib / ms_k3:.2f}", flush=True)
        del a
    for i, _, _ in STAGES:
        sub = [r for r in rows if r["stage"] == f"s{i}"]
        k3, lib = sum(r["k3_ms"] for r in sub) * 2, sum(r["library_ms"] for r in sub) * 2  # 18 convs: 2 of each (k, d)
        bound = sum(r["bound_tf32x3_ms"] for r in sub) * 2
        print(f"convs of s{i}, 18: K3 {k3:.2f} ms, F.conv1d {lib:.2f} ms (x{lib / k3:.2f}), bound {bound:.2f} ms "
              f"at 3 TF32 products ({bound / k3 * 100:.1f} % of it)", flush=True)
    return rows


def stages(dev, reps: int) -> list:
    """One resblock group of s0 / s1 three ways, float32, B = 16."""
    from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, FusedBigVGAN

    torch.manual_seed(0)
    model = BigVGAN(BigVGANConfig()).eval().to(dev)
    per_block = FusedBigVGAN(model, fuse_max_channels=192)
    fused = FusedBigVGAN(model, fuse_max_channels=768)  # every stage on K2
    rows = []
    for i, c, t in STAGES:
        x = torch.randn((16, c, t), device=dev)
        blocks = model.stage_blocks(i)
        with torch.no_grad():
            old = lambda: sum(blk(x, w) for blk, w in zip(blocks, per_block.stages[i][1])) / len(blocks)  # noqa: E731
            row = {"stage": f"s{i}", "shape": (16, c, t), "route": fused.routes[i],
                   "block_cudnn_ms": cuda_ms(old, reps), "block_k3_ms": cuda_ms(lambda: per_block.resblocks(i, x), reps),
                   "k2_ms": cuda_ms(lambda: fused.resblocks(i, x), reps)}
            ref = old()
            row["k3_route_vs_cudnn"] = ((per_block.resblocks(i, x) - ref).abs().max() / ref.abs().max().clamp(min=1)).item()
            row["k2_vs_cudnn"] = ((fused.resblocks(i, x) - ref).abs().max() / ref.abs().max().clamp(min=1)).item()
        rows.append(row)
        print(f"stage s{i} [16, {c}, {t}]: block route K1 + cuDNN {row['block_cudnn_ms']:.2f} ms, K1 + K3 "
              f"{row['block_k3_ms']:.2f} ms, K2 ({row['route']}) {row['k2_ms']:.2f} ms; error vs the cuDNN route: "
              f"K3 route {row['k3_route_vs_cudnn']:.2e}, K2 {row['k2_vs_cudnn']:.2e}", flush=True)
        del x
    return rows


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    require_gpu("conv_times")
    from dmel_codec_tpu_torch.utils.precision import strict_float32

    strict_float32()
    dev = torch.device("cuda")
    path, seconds = library.build()
    log = path.with_suffix(".log").read_text().splitlines()
    for j, line in enumerate(log):
        if "Compiling entry" in line and "stage_conv" in line:
            print("ptxas:", "\n       ".join(s.strip() for s in log[j: j + 4]))
    print(f"{torch.cuda.get_device_name(0)}; library built in {seconds:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"check": check(gen, dev)}
    if "--quick" not in argv:
        out["convs"] = convs(gen, dev, 10)
        out["stages"] = stages(dev, 3)
    print(f"stage_conv launches {stage_conv.launches}")
    return out


if __name__ == "__main__":
    main()
