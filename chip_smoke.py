#!/usr/bin/env python3
"""Drive the PyTorch port's codec serving path once on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one GPU

Phases (any failure raises and exits non-zero; there is no CPU path):
  1. card name and power limit (nvidia-smi);
  2. build the CUDA kernels from dmel_codec_tpu_torch/csrc into build/;
  3. K1 (anti-aliased snake) against its plain version at the vocoder's
     shapes, float32 and bfloat16;
  4. K2 (fused AMP stage) against its plain version at every fused width,
     B = 2, float32 and bfloat16;
  5. the main path at the flagship width with seeded random bf16 weights:
     three requests of 16 clips x 4 s through log-mel -> DMelCodec.encode ->
     DMelCodec.decode -> serving BigVGAN, with output checks and kernel
     launch counts; then xRT with its per-part split, a one-request
     torch.profiler breakdown, the vocoder stage by stage, and each kernel's
     time beside its plain version at the main-path shapes;
  6. stage-wise kernel-vs-plain error of the vocoder in float32, each stage
     fed the same input.
The comparison phases run with TF32 off for cuBLAS and cuDNN. The
line before the last is one JSON object describing the kernels; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

SECONDS, BATCH, SR, HOP = 4, 16, 24000, 256
FUSE_MAX_CHANNELS = 192
DEVICE = "cuda:0"
K1_SOURCE = "dmel_codec_tpu_torch/csrc/anti_alias.cu"
K2_SOURCE = "dmel_codec_tpu_torch/csrc/stage_fused.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, rel: float) -> float:
    """Fails unless max |got - want| <= rel * max(1, max |want|)."""
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = max_err(got, want)
    scale = max(1.0, want.float().abs().max().item())
    log(f"  {name}: max abs err {err:.3e} (tol {rel * scale:.3e}, max|plain| {scale:.3g})")
    if not err <= rel * scale:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call, CUDA events, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Tolerances, relative to max(1, max |plain|):
#  K1 f32: sinf and the 6-tap FIR sums in another order than the plain
#    chain's cuDNN convs, ~1e-7 relative per op: 1e-6.
#  K1 bf16: both sides compute in float32 and round once; a result next to
#    a rounding boundary may round the other way: one bf16 ulp, 2^-7.
#  K2 f32: 36 chained ops, each ~1e-7 relative apart, amplified by the
#    random weights' gain: 2e-5.
#  K2 bf16: 54 bf16 rounding points on each side; a flip there is one ulp
#    (<= 2^-7) and flips compound down the chain: 5e-2.
TOL = {("K1", torch.float32): 1e-6, ("K1", torch.bfloat16): 2.0**-7,
       ("K2", torch.float32): 2e-5, ("K2", torch.bfloat16): 5e-2}


def stage_shapes(vcfg, frames: int):
    t = frames
    for i, u in enumerate(vcfg.upsample_rates):
        t *= u
        yield i, vcfg.stage_channels(i), t


def profile_once(what: str, fn) -> None:
    """Device kernel time by name over one call (torch.profiler, CUDA
    activity). Busy share = summed kernel time / the call's wall time under
    the profiler (its own host overhead inflates the idle share)."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            by_name[e.name][1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    if not by_name:
        log(f"  profile of {what}: no device time recorded (not measured)")
        return
    log(f"  profile of {what}: wall {wall_ms:.2f} ms, kernels {busy_ms:.2f} ms, "
        f"device idle share {1 - busy_ms / wall_ms:.3f}")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"    {ms:9.3f} ms  x{n:<5d} {name[:100]}")


@torch.no_grad()
def jitter_snake(module: torch.nn.Module) -> torch.nn.Module:
    """Log-alpha / log-beta start at 0 (every alpha = 1); spread them."""
    from dmel_codec_tpu_torch.nn.snake import SnakeBeta

    for m in module.modules():
        if isinstance(m, SnakeBeta):
            for p in (m.alpha, m.beta):
                if p is not None:
                    p.normal_(0.0, 0.1)
    return module


@contextlib.contextmanager
def plain_kernels():
    """Route the vocoder's kernel calls to their plain versions."""
    from dmel_codec_tpu_torch.models import bigvgan
    from dmel_codec_tpu_torch.ops.anti_alias import anti_alias_activation_reference
    from dmel_codec_tpu_torch.ops.stage_fused import stage_reference

    saved = bigvgan.anti_alias_activation, bigvgan.amp_stage
    bigvgan.anti_alias_activation, bigvgan.amp_stage = anti_alias_activation_reference, stage_reference
    try:
        yield
    finally:
        bigvgan.anti_alias_activation, bigvgan.amp_stage = saved


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from dmel_codec_tpu_torch.dsp.spectrogram import LogMelSpectrogram
    from dmel_codec_tpu_torch.models.bigvgan import AMPBlock1, BigVGAN, BigVGANConfig, FusedBigVGAN
    from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
    from dmel_codec_tpu_torch.ops import library
    from dmel_codec_tpu_torch.ops.anti_alias import anti_alias_activation, anti_alias_activation_reference
    from dmel_codec_tpu_torch.ops.stage_fused import StageSpec, amp_stage, pack_stage, stage_reference
    from dmel_codec_tpu_torch.utils.precision import strict_float32

    dev = torch.device(DEVICE)
    strict_float32()

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # ---- 2. build
    path, build_s = library.build()
    library.load()
    log(f"built {path.name} in {build_s:.1f} s (0 = already built)")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    vcfg = BigVGANConfig()
    frames = (SECONDS * SR // HOP // 4) * 4
    shapes = {i: (c, t) for i, c, t in stage_shapes(vcfg, frames)}
    errs = {"K1": 0.0, "K2": 0.0}

    # ---- 3. K1 vs plain: the vocoder's shapes, then ragged ones (snake and
    # snakebeta, logscale on and off, T not a multiple of the tile, T = 1)
    log("K1 anti-aliased snake vs plain:")
    last = len(shapes) - 1
    k1_shapes = {"act_post": (BATCH, *shapes[last]), "s0": (BATCH, *shapes[0]), "s1": (BATCH, *shapes[1])}
    k1_cases = [(name, shape, True, True, (torch.float32, torch.bfloat16))
                for name, shape in k1_shapes.items()]
    k1_cases += [("ragged snake", (2, 3, 700), False, False, (torch.float32,)),
                 ("ragged snakebeta", (1, 5, 1), True, True, (torch.float32,)),
                 ("ragged snakebeta", (3, 7, 37), False, True, (torch.float32,))]
    for name, shape, logscale, with_beta, dts in k1_cases:
        c = shape[1]
        alpha = 0.3 * torch.randn(c, device=dev, generator=gen) + (0.0 if logscale else 1.0)
        beta = 0.3 * torch.randn(c, device=dev, generator=gen) + (0.0 if logscale else 1.0)
        beta = beta if with_beta else None
        x32 = torch.randn(shape, device=dev, generator=gen)
        for dt in dts:
            x = x32.to(dt)
            got = anti_alias_activation(x, alpha, beta, logscale)
            torch.cuda.synchronize()
            want = anti_alias_activation_reference(x, alpha, beta, logscale)
            e = check_close(f"{name} {list(shape)} {dt}", got, want, TOL[("K1", dt)])
            if dt == torch.float32:
                errs["K1"] = max(errs["K1"], e)
            del got, want

    # ---- 4. K2 vs plain: every fused width at B = 2, then ragged shapes
    # (T not a multiple of the 128-sample tile, C not a multiple of the
    # channel tile, T shorter than the conv reach)
    log("K2 fused AMP stage vs plain:")
    torch.manual_seed(1)

    def random_pack(c: int):
        spec = StageSpec(channels=c)
        blocks = [jitter_snake(AMPBlock1(c, k, d, spec.activation, spec.logscale))
                  for k, d in zip(spec.kernel_sizes, spec.dilations)]
        packed = pack_stage(blocks, spec)
        return spec, {"w": [w.to(dev) for w in packed["w"]], **{k: packed[k].to(dev) for k in ("b", "a", "ib")}}

    stage_packs = {i: random_pack(c) for i, (c, _) in shapes.items() if c <= FUSE_MAX_CHANNELS}
    k2_cases = [(f"s{i}", stage_packs[i], (2, *shapes[i]), (torch.float32, torch.bfloat16))
                for i in stage_packs]
    k2_cases += [("ragged", random_pack(40), (1, 40, 1000), (torch.float32,)),
                 ("short", stage_packs[last], (2, shapes[last][0], 50), (torch.float32,)),
                 ("one sample", stage_packs[last], (1, shapes[last][0], 1), (torch.float32,))]
    for name, (spec, packed), shape, dts in k2_cases:
        x32 = torch.randn(shape, device=dev, generator=gen)
        for dt in dts:
            x = x32.to(dt)
            got = amp_stage(x, packed, spec)
            torch.cuda.synchronize()
            want = stage_reference(x, packed, spec)
            e = check_close(f"{name} {list(shape)} {dt}", got, want, TOL[("K2", dt)])
            if dt == torch.float32:
                errs["K2"] = max(errs["K2"], e)
            del got, want

    # ---- 5. the main path
    log("main path: flagship DMelCodec + BigVGAN, seeded random weights, bf16")
    torch.manual_seed(0)
    ccfg = DMelCodecConfig(compute_dtype="bfloat16")
    codec = DMelCodec(ccfg).eval()
    voc32 = jitter_snake(BigVGAN(BigVGANConfig()).eval())
    codec = codec.to(device=dev, dtype=torch.bfloat16)
    voc16 = copy.deepcopy(voc32).to(device=dev, dtype=torch.bfloat16)
    voc32 = voc32.to(dev)
    mel_tf = LogMelSpectrogram().to(dev)
    vocoder = FusedBigVGAN(voc16, fuse_max_channels=FUSE_MAX_CHANNELS)
    n_fused = sum(spec is not None for spec, _ in vocoder.stages)
    n_unfused = len(vocoder.stages) - n_fused
    want_k1 = n_unfused * 18 + 1  # 18 acts per per-block stage + act_post
    want_k2 = n_fused * 18        # 18 act -> conv launches per fused stage
    lengths = torch.full((BATCH,), frames, device=dev)
    samples = frames * HOP
    t = torch.arange(SECONDS * SR, device=dev) / SR

    def audio_for(request: int) -> torch.Tensor:
        f0 = 110.0 * (1 + request) * (1 + torch.arange(BATCH, device=dev)[:, None] / BATCH)
        return 0.5 * torch.sin(2 * math.pi * f0 * t) + 0.1 * torch.sin(2 * math.pi * 3.1 * f0 * t)

    def front(audio):
        mels = mel_tf(audio)[:, :frames].to(torch.bfloat16)
        return codec.encode(mels, lengths)

    def mid(idx, ilen):
        return codec.decode(idx, ilen, generator=gen)

    anti_alias_activation.launches = amp_stage.launches = 0
    with torch.no_grad():
        outs = []
        for r in range(3):
            idx, ilen = front(audio_for(r))
            wav = vocoder(mid(idx, ilen))
            outs.append((idx, wav))
        torch.cuda.synchronize()
    launches = {"K1": anti_alias_activation.launches, "K2": amp_stage.launches}
    log(f"  launches over 3 requests: K1 {launches['K1']}, K2 {launches['K2']} "
        f"(expected {3 * want_k1} and {3 * want_k2})")
    for r, (idx, wav) in enumerate(outs):
        assert idx.shape == (BATCH, ccfg.dmel_groups * ccfg.n_codebooks, frames // 4), idx.shape
        assert 0 <= int(idx.min()) and int(idx.max()) < ccfg.codebook_size, (idx.min(), idx.max())
        assert wav.shape == (BATCH, samples), wav.shape
        assert torch.isfinite(wav).all() and wav.abs().max() <= 1.0
        log(f"  request {r}: indices {list(idx.shape)} in [{int(idx.min())}, {int(idx.max())}], "
            f"wave {list(wav.shape)} rms {wav.float().square().mean().sqrt().item():.4f}")
    assert launches == {"K1": 3 * want_k1, "K2": 3 * want_k2}, launches

    with torch.no_grad():
        audio = audio_for(0)
        idx, ilen = front(audio)
        gen_mel = mid(idx, ilen)
        reps = 5
        ms_front = cuda_ms(lambda: front(audio), reps)
        ms_mid = cuda_ms(lambda: mid(idx, ilen), reps)
        ms_voc = cuda_ms(lambda: vocoder(gen_mel), reps)
    total_ms = ms_front + ms_mid + ms_voc
    xrt = BATCH * SECONDS / (total_ms / 1e3)
    log(f"  xRT {xrt:.2f} ({BATCH} x {SECONDS} s per request, {total_ms:.2f} ms): "
        f"front end {ms_front:.2f} ms, decode {ms_mid:.2f} ms, vocoder {ms_voc:.2f} ms")
    with torch.no_grad():
        profile_once("one request", lambda: vocoder(mid(*front(audio))))
        # the vocoder stage by stage (each fed its real input), summing to its total
        x = vocoder.pre(gen_mel)
        parts = {"conv_pre": cuda_ms(lambda: vocoder.pre(gen_mel), reps)}
        for i in range(len(vocoder.stages)):
            parts[f"s{i}"] = cuda_ms(lambda i=i, x=x: vocoder.stage(i, x), reps)
            x = vocoder.stage(i, x)
        parts["act_post + conv_post"] = cuda_ms(lambda: vocoder.post(x), reps)
    log("  vocoder by stage: " + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items())
        + f" (sum {sum(parts.values()):.2f} ms)")

    # kernel vs plain time at the main-path shapes (bf16, B = 16), per request
    ms = {"K1": 0.0, "K2": 0.0}
    plain_ms = {"K1": 0.0, "K2": 0.0}
    with torch.no_grad():
        for name, shape, count in (("act_post", k1_shapes["act_post"], 1),
                                   ("s0", k1_shapes["s0"], 18), ("s1", k1_shapes["s1"], 18)):
            x = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
            a = 0.3 * torch.randn(shape[1], device=dev, generator=gen)
            k = cuda_ms(lambda: anti_alias_activation(x, a, a, True), 10)
            p = cuda_ms(lambda: anti_alias_activation_reference(x, a, a, True), 10)
            log(f"  K1 {name} {list(shape)} bf16: kernel {k:.3f} ms, plain {p:.3f} ms (x{count} per request)")
            ms["K1"] += count * k
            plain_ms["K1"] += count * p
        for i, (spec, packed) in stage_packs.items():
            c, t_len = shapes[i]
            x = torch.randn((BATCH, c, t_len), device=dev, generator=gen).to(torch.bfloat16)
            k = cuda_ms(lambda: amp_stage(x, packed, spec), 3)
            p = cuda_ms(lambda: stage_reference(x, packed, spec), 3)
            log(f"  K2 s{i} [{BATCH}, {c}, {t_len}] bf16: kernel {k:.3f} ms (18 launches), plain {p:.3f} ms")
            ms["K2"] += k
            plain_ms["K2"] += p
    log(f"  per request: K1 {ms['K1']:.3f} ms vs plain {plain_ms['K1']:.3f} ms; "
        f"K2 {ms['K2']:.3f} ms vs plain {plain_ms['K2']:.3f} ms")

    # ---- 6. stage-wise kernel vs plain, float32, same input per stage
    log("stage-wise vocoder error, float32, kernel vs plain on the same input:")
    # input: the log-mel of request 0's audio (the random codec's output is
    # near zero, which would make every stage's comparison trivially small)
    fused32 = FusedBigVGAN(voc32, fuse_max_channels=FUSE_MAX_CHANNELS)
    with torch.no_grad():
        x = fused32.pre(mel_tf(audio)[:, :frames])
    for i in range(len(fused32.stages)):
        got = fused32.stage(i, x)
        torch.cuda.synchronize()
        with plain_kernels():
            want = fused32.stage(i, x)
        kind = "K2" if fused32.stages[i][0] is not None else "K1"
        check_close(f"s{i} ({kind}) {list(got.shape)}", got, want, TOL[("K2", torch.float32)])
        x = got
    got = fused32.post(x)
    with plain_kernels():
        want = fused32.post(x)
    check_close(f"act_post + conv_post {list(got.shape)}", got, want, TOL[("K2", torch.float32)])

    kernels = [
        {"name": "anti_alias_activation (K1)", "route": "cuda", "source": K1_SOURCE,
         "replaces": "dmel_codec_tpu/ops/anti_alias.py:521", "launches": launches["K1"],
         "max_abs_err": errs["K1"], "ms": ms["K1"], "plain_ms": plain_ms["K1"]},
        {"name": "amp_stage act->conv (K2)", "route": "cuda", "source": K2_SOURCE,
         "replaces": "dmel_codec_tpu/ops/stage_fused.py:806", "launches": launches["K2"],
         "max_abs_err": errs["K2"], "ms": ms["K2"], "plain_ms": plain_ms["K2"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
