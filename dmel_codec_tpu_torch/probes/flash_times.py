"""Times of the redesigned kernels at their main-path shapes (the
flash-attention kernels FA, FA-dKV and FA-dQ at the LM's shapes, P4 at the
probe's 264 planes at C = 96 and 192, K2's stages s2..s5 and K2-v1's s4
and s5 of the flagship vocoder in bf16 and float32, K1 at its three
shapes, each at a codec request's and a streaming window's shapes, the
probe P1 at its timed shape [16, 96, 24064], w = 2048, in bf16 and
float32 with K1 at that shape beside it, and P2 / P3 on 1 and 264 planes,
per call and per launch on the device), and a same-card comparison of two
checkouts.

    python3 -m dmel_codec_tpu_torch.probes.flash_times              # this checkout
    python3 -m dmel_codec_tpu_torch.probes.flash_times --ab OTHER   # OTHER, this, this, OTHER

With `--ab` each run is its own process (this file run as a script from
the checkout's root) that imports the port from its checkout, builds that
checkout's kernels from its own `csrc/` (into its `build/`), and times them
through its `ops/flash_attention.py` (`_launch(q, k, v, with_lse)`,
`flash_attention_dkv(q, k, v, grad, lse, delta)`, `flash_attention_dq(...)`),
its `probes/sublane_ops.tap_matmul` (a width that checkout refuses is
left out), its `ops/stage_fused.amp_stage(x, packed, spec)` and
`amp_stage_v1(x, packed, spec)` and its
`ops/anti_alias.anti_alias_activation(x, alpha, beta, logscale)`, its
`probes/cf_act.cf_act_windowed(x, alpha, inv_beta, w)` and its
`probes/sublane_ops.slice_rows` / `roll_rows` (per call: CUDA events around
back-to-back calls; on the device: 20 launches captured in one CUDA graph,
the input rotated over 5 sets of planes, replayed); the runs
alternate so that a drift of the card shows as a difference between the
two runs of one checkout. K2 and K2-v1 are timed in bf16 and in float32
(the float32 kernels run split-TF32 products on the tensor cores since
their redesign; the parent's ran on the CUDA cores). Each run also records
what must not change: hashes of the bf16 FA output and L at [2, 2048], of
the bf16 FA-dKV and FA-dQ outputs at [2, 2048] and the float32 FA-dKV
outputs at [2, 1024] (both fed the plain forward's output and L), of the bf16 K2 stage at a window's s3 and the bf16
K2-v1 stage at a window's s5, and of K1 in float32 and bf16 at s1 and at a
ragged shape, of P1 in bf16 and float32 at its timed shape, and of P2 /
P3 on 1 and 264 planes (the same bits in all four runs; P2 / P3 also
equal to their plain versions, or the run raises); and of the float32 FA
output and L and FA-dQ output at [2, 1024] and the float32 K2 and K2-v1
stages (the same bits in the two runs of one checkout: these float32
kernels sum in a fixed order, in another one than before their split-TF32
redesign); and the
flagship vocoder's bf16 waveform on
seeded random weights with spread snake parameters (written to the
checkout's `build/ab_vocoder.pt`; the difference between the checkouts is
printed). Prints one line per case and run, and as its last line a JSON
object {checkout: {case: ms per launch, mean of its runs}, "vocoder": {...}}.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
# (name, B, S, H, KH, hd, dtype): the LM forward's bf16 [2, 2048] and the
# trainer's float32 [2, 1024] (plus its backward at [2, 2048] in both types)
CASES = [("fwd", 2, 2048, 14, 2, 64, "bfloat16"), ("fwd+L", 2, 1024, 14, 2, 64, "float32"),
         ("bwd", 2, 1024, 14, 2, 64, "float32"), ("bwd", 2, 2048, 14, 2, 64, "float32"),
         ("bwd", 2, 2048, 14, 2, 64, "bfloat16")]
P4_WIDTHS, P4_PLANES = (96, 192), 264  # x [264, 2176, C] @ w [C, C], 11 taps of step 8
# K2: (case, B, C, T) of the flagship's fused stages, 16 x 4 s (372 mel frames) and one window (560)
K2_CASES = tuple((f"{what} s{i}", b, c, frames * rate) for what, b, frames in (("request", 16, 372), ("window", 1, 560))
                 for i, c, rate in ((2, 192, 32), (3, 96, 64), (4, 48, 128), (5, 24, 256)))
K2_BITS = ("window s3", 1, 96, 560 * 64)  # the stage whose bits the runs must share
V1_CASES = tuple(case for case in K2_CASES if case[2] <= 48)  # K2-v1: s4 and s5
V1_BITS = ("window s5", 1, 24, 560 * 256)
# K1: (case, B, C, T) of act_post, s0 and s1 at a request's and a window's shapes
K1_CASES = tuple((f"{what} {name}", b, c, frames * rate) for what, b, frames in (("request", 16, 372), ("window", 1, 560))
                 for name, c, rate in (("act_post", 24, 256), ("s0", 768, 4), ("s1", 384, 16)))
K1_BITS = (("s1", 2, 384, 5952), ("ragged", 3, 7, 1037))
P1_SHAPE, P1_WINDOW = (16, 96, 24064), 2048  # the probe P1's timed shape and window
ROWS_PLANES, ROWS_SETS, ROWS_GRAPH = (1, 264), 5, 20  # P2 / P3: planes; sets and launches of the device timing


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.float().cpu().numpy().tobytes())
    return h.hexdigest()


def time_here(root: Path, reps: int = 20) -> dict:
    """ms per launch of the checkout at `root`, keyed "FA bfloat16 [2, 2048]" etc., and the
    hashes of the outputs ("bits ...", "own bits ..."); writes the vocoder's waveform to
    `root`/build."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flash_times: the probe times CUDA kernels and needs a GPU")
    sys.path.insert(0, str(root))
    from dmel_codec_tpu_torch.ops import flash_attention as fa
    from dmel_codec_tpu_torch.ops.anti_alias import anti_alias_activation
    from dmel_codec_tpu_torch.ops.stage_fused import StageSpec, amp_stage, amp_stage_v1
    from dmel_codec_tpu_torch.probes import cf_act, sublane_ops

    def cuda_ms(fn, n):  # CUDA events over n launches after one warm-up
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    def graph_ms(fn, xs, n, replays=5):  # n launches of fn over the inputs in turn, in one CUDA graph
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            ys = [fn(xs[i % len(xs)]) for i in range(n)]
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        del ys
        return start.elapsed_time(end) / (replays * n)

    assert Path(fa.__file__).resolve().is_relative_to(root.resolve()), fa.__file__
    (root / "build").mkdir(exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    with torch.no_grad():
        for name, b, s, h, kh, hd, dt in CASES:
            dtype = getattr(torch, dt)
            q, k, v, g = (torch.randn((b, s, n, hd), device="cuda", generator=gen).to(dtype)
                          for n in (h, kh, kh, h))
            tag = f"{dt} [{b}, {s}]"
            # bf16 and float32 FA-dKV: the same bits in all four runs; the
            # float32 FA and FA-dQ (split-TF32 since their redesign): in the two
            # runs of one checkout
            bits = "bits" if dt == "bfloat16" else "own bits"
            if name == "fwd":
                out[f"FA {tag}"] = cuda_ms(lambda: fa._launch(q, k, v), reps)
                out[f"{bits} FA and L {tag}"] = digest(*fa._launch(q, k, v, with_lse=True))
            elif name == "fwd+L":
                out[f"FA storing L {tag}"] = cuda_ms(lambda: fa._launch(q, k, v, with_lse=True), reps)
                out[f"{bits} FA and L {tag}"] = digest(*fa._launch(q, k, v, with_lse=True))
            else:
                o, lse = fa._launch(q, k, v, with_lse=True)
                delta = (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
                out[f"FA-dKV {tag}"] = cuda_ms(lambda: fa.flash_attention_dkv(q, k, v, g, lse, delta), reps)
                out[f"FA-dQ {tag}"] = cuda_ms(lambda: fa.flash_attention_dq(q, k, v, g, lse, delta), reps)
                if s == 2048 and dt == "float32":
                    continue
                # fed the plain forward's output and L, which no redesign moves
                o, lse = fa.flash_attention_forward_reference(q, k, v)
                delta = (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
                out[f"bits FA-dKV {tag}"] = digest(*fa.flash_attention_dkv(q, k, v, g, lse, delta))
                out[f"{bits} FA-dQ {tag}"] = digest(fa.flash_attention_dq(q, k, v, g, lse, delta))
        for c in P4_WIDTHS:
            xb = torch.randn((P4_PLANES, sublane_ops.MM_ROWS, c), device="cuda", generator=gen).to(torch.bfloat16)
            w = torch.randn((c, c), device="cuda", generator=gen).to(torch.bfloat16)
            try:
                sublane_ops.tap_matmul(xb, w)
            except ValueError:  # a width this checkout's P4 does not take
                continue
            out[f"P4 C = {c} [{P4_PLANES} planes]"] = cuda_ms(lambda: sublane_ops.tap_matmul(xb, w), reps)
        cpu = torch.Generator().manual_seed(2)
        for kernel, fn, cases, bits in (("K2", amp_stage, K2_CASES, K2_BITS), ("K2-v1", amp_stage_v1, V1_CASES, V1_BITS)):
            what = "18 launches" if kernel == "K2" else "1 launch"
            for i, (name, b, c, t) in enumerate(cases + (bits,)):
                spec, packed = StageSpec(channels=c), k2_pack(c, cpu)
                x = torch.randn((b, c, t), generator=cpu).to("cuda")
                for dt in ("bfloat16", "float32"):
                    xd = x.to(getattr(torch, dt))
                    tag = f"{kernel} {'bf16' if dt == 'bfloat16' else dt} {name} {[b, c, t]}"
                    if i < len(cases):
                        out[f"{tag} ({what})"] = cuda_ms(lambda: fn(xd, packed, spec), 3)
                    else:  # bf16: the same bits in every run; float32: in the two runs of a checkout
                        y = fn(xd, packed, spec).float().cpu().numpy()
                        key = f"bits {tag}" if dt == "bfloat16" else f"own bits {tag}"
                        out[key] = hashlib.sha256(y.tobytes()).hexdigest()
        for name, b, c, t in K1_CASES:
            x = torch.randn((b, c, t), generator=cpu).to("cuda", torch.bfloat16)
            alpha = (0.3 * torch.randn(c, generator=cpu)).to("cuda")
            out[f"K1 bf16 {name} {[b, c, t]}"] = cuda_ms(lambda: anti_alias_activation(x, alpha, alpha, True), reps)
        for name, b, c, t in K1_BITS:
            x = torch.randn((b, c, t), generator=cpu).to("cuda")
            alpha, beta = ((0.3 * torch.randn(c, generator=cpu)).to("cuda") for _ in range(2))
            for dt in (torch.float32, torch.bfloat16):
                y = anti_alias_activation(x.to(dt), alpha, beta, True).float().cpu().numpy()
                out[f"bits K1 {dt} {name} {[b, c, t]}"] = hashlib.sha256(y.tobytes()).hexdigest()
        x = torch.randn(P1_SHAPE, generator=cpu)
        alpha, beta = (torch.exp(0.1 * torch.randn(P1_SHAPE[1], generator=cpu)).to("cuda") for _ in range(2))
        inv_beta = 1.0 / (beta + 1e-9)
        for dt in (torch.bfloat16, torch.float32):
            xd = x.to("cuda", dt)
            tag = f"{'bf16' if dt == torch.bfloat16 else 'float32'} {list(P1_SHAPE)}"
            out[f"P1 {tag} w = {P1_WINDOW}"] = cuda_ms(lambda: cf_act.cf_act_windowed(xd, alpha, inv_beta, P1_WINDOW),
                                                       reps)
            out[f"K1 {tag} (P1's shape)"] = cuda_ms(lambda: anti_alias_activation(xd, alpha, beta, False), reps)
            out[f"bits P1 {tag} w = {P1_WINDOW}"] = digest(cf_act.cf_act_windowed(xd, alpha, inv_beta, P1_WINDOW))
        rows_gen = torch.Generator(device="cuda").manual_seed(3)
        for planes in ROWS_PLANES:
            xs = [torch.randn((planes, sublane_ops.ROWS, sublane_ops.LANES), device="cuda", generator=rows_gen)
                  for _ in range(ROWS_SETS)]
            for name, fn, ref in (("P2", sublane_ops.slice_rows, sublane_ops.slice_reference),
                                  ("P3", sublane_ops.roll_rows, sublane_ops.roll_reference)):
                y = fn(xs[0])
                if not torch.equal(y, ref(xs[0])):
                    raise AssertionError(f"{name} on {planes} planes differs from its plain version")
                out[f"bits {name} [{planes} planes]"] = digest(y)
                out[f"{name} per call [{planes} planes]"] = cuda_ms(lambda: fn(xs[0]), reps)
                out[f"{name} device per launch [{planes} planes]"] = graph_ms(fn, xs, ROWS_GRAPH)
            del xs
        torch.save(vocoder_bf16(), root / "build" / "ab_vocoder.pt")
    return out


def k2_pack(c: int, gen):
    """`pack_stage`-shaped arrays of a C-channel stage (on the card) from a
    CPU generator, the same in every checkout."""
    import torch

    ws = [torch.randn((k, c, c), generator=gen) / math.sqrt(k * c) for k in (3, 7, 11) for _ in range(6)]
    cols = {"b": 0.05 * torch.randn((c, 18), generator=gen), "a": torch.exp(0.1 * torch.randn((c, 18), generator=gen)),
            "ib": 1.0 / (torch.exp(0.1 * torch.randn((c, 18), generator=gen)) + 1e-9)}
    return {"w": [w.cuda() for w in ws], **{k: v.cuda() for k, v in cols.items()}}


def vocoder_bf16():
    """The flagship serving vocoder's bf16 waveform (CPU) for a seeded mel
    of 2 x 96 frames, on random weights from a fixed seed with log-alpha /
    log-beta spread (they start at 0, where exp is exact in any dtype)."""
    import torch
    from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, FusedBigVGAN
    from dmel_codec_tpu_torch.nn.snake import SnakeBeta

    torch.manual_seed(0)
    model = BigVGAN(BigVGANConfig())
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SnakeBeta):
                for p in (m.alpha, m.beta):
                    if p is not None:
                        p.normal_(0.0, 0.1)
    vocoder = FusedBigVGAN(model.eval().to("cuda", torch.bfloat16))
    mel = torch.randn((2, 96, model.config.num_mels), generator=torch.Generator().manual_seed(1))
    return vocoder(mel.to("cuda", torch.bfloat16)).float().cpu()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", type=Path, help="another checkout, timed in turns with this one")
    ap.add_argument("--root", type=Path, default=HERE, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ab is None:
        times = time_here(args.root)
        print(json.dumps(times))
        return times
    import torch

    runs = [args.ab, HERE, HERE, args.ab]
    table, bits = {}, {}
    for i, root in enumerate(runs):
        proc = subprocess.run([sys.executable, __file__, "--root", str(root.resolve())],
                              cwd=root, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"timing {root} failed:\n{proc.stderr[-4000:]}")
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        for case, ms in times.items():
            if case.startswith(("bits ", "own bits ")):
                print(f"run {i + 1} {root}: {case}: sha256 {ms[:16]}")
                key = case if case.startswith("bits ") else (case, str(root))
                bits.setdefault(key, set()).add(ms)
                continue
            print(f"run {i + 1} {root}: {case}: {ms:.4f} ms")
            table.setdefault(str(root), {}).setdefault(case, []).append(ms)
    for case, hashes in bits.items():
        if len(hashes) != 1:
            raise AssertionError(f"{case}: the runs gave different bits ({len(hashes)} hashes)")
        print(f"{case}: the same bits in all four runs" if isinstance(case, str)
              else f"{case[0]} in {case[1]}: the same bits in both of its runs")
    means = {root: {case: sum(v) / len(v) for case, v in cases.items()} for root, cases in table.items()}
    other, here = (torch.load(Path(r) / "build" / "ab_vocoder.pt") for r in (args.ab, HERE))
    diff = (here - other).abs()
    means["vocoder"] = {"max_abs_diff": diff.max().item(), "mean_abs_diff": diff.mean().item(),
                        "max_abs_out": other.abs().max().item(), "same_bits": (here == other).float().mean().item()}
    print(f"flagship vocoder, bf16, 2 x 96 frames: this checkout against {args.ab}: {means['vocoder']}")
    print(json.dumps(means))
    return means


if __name__ == "__main__":
    main()
