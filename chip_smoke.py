#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one CUDA card:
the codec (log-mel -> dMel tokens -> BigVGAN), the slow-fast LM in front of
it, the codec on long audio, window by window, LM training, codec GAN
training, the kernel probes, codec evaluation with the codec zoo, the host
data path, the parallel layer (data, tensor, FSDP, pipeline, sequence) and
the public modules beside the main path (FireflyGAN, the WaveNet diffusion
pathway, Snake and the resamplers).

    python3 chip_smoke.py        # from the root of a checkout; needs one GPU

Phases (any failure raises and exits non-zero; there is no CPU path):
  1. card name and power limit (nvidia-smi);
  2. build the CUDA kernels from dmel_codec_tpu_torch/csrc into build/;
  3. K1 (anti-aliased snake) against its plain version at the vocoder's
     shapes in a codec request and in a streaming window, float32 and
     bfloat16, at ragged lengths (T = 1..64, 700, 1000; x at an offset
     that is no 16-byte boundary: its head and tail path), and with bf16
     parameters (the coefficients the kernel rounds itself); its sinf
     without conversions against sinf over every float (no bit may differ
     but the sign); its launch (grid, threads, shared memory per block);
  4. K2 (fused AMP stage on the tensor cores: bf16 operands, or float32
     ones split into TF32 hi + lo) against its plain version at every fused
     width, B = 2 and a streaming window's B = 1, and at ragged shapes,
     float32 and bfloat16; then launch by launch against
     act_conv_reference: every (k, d) of the widest fused stage and of a
     ragged C = 40 under both bf16 contracts, alone, onto a residual and as
     a block's last launch, and in float32;
  5. the main path at the flagship width with seeded random bf16 weights:
     three requests of 16 clips x 4 s through log-mel -> DMelCodec.encode ->
     DMelCodec.decode -> serving BigVGAN, with output checks and kernel
     launch counts (every bf16 K2 launch on the tensor-core kernel); then
     xRT with its per-part split, a one-request torch.profiler breakdown
     (which must name K1's kernel and K2's tensor-core kernel), the vocoder
     stage by stage, each kernel's time beside its plain version at the
     main-path shapes (K2 also in float32), K2's and K2-v1's time by part
     in both dtypes (probes/stage_parts.py), and K1's instruction-issue
     floor counted from its SASS (probes/k1_floor.py);
  6. the float32 serving path, which a released (float32) checkpoint
     takes: stage-wise kernel-vs-plain error of the float32 vocoder, each
     stage fed the same input (every K2 launch on the split-TF32 kernel);
     then one codec request of 16 clips x 4 s through a float32 DMelCodec
     and vocoder, as `cli.stream_codec` builds them: launch counts, output
     checks, xRT with its per-part split, the vocoder stage by stage, a
     profile that must name the split-TF32 kernel;
  7. FA (causal GQA flash attention) against its plain version at the slow
     decoder's head layout, main-path and ragged lengths, and at head sizes
     16 to 128, float32 (split-TF32 products on the tensor cores) and
     bfloat16 (tensor cores);
  8. the teacher-forced LM forward at full width (slow 24 x 896, fast
     12 x 480, vocabulary 151936; seeded random bf16 weights) on a batch of
     2 x 2048 grid positions: FA launch count, finite losses, logits with
     the flash kernel on against off, both timed, and a profile of one
     forward with the kernel (its kernels and the device's idle share);
  9. LM serving through the entry point: `cli.infer_lm.main` on checkpoints
     written to a temporary directory, text prompt -> 128 frames (replays
     of the captured frame step) -> codec decode -> vocoder -> WAV, with
     output checks and K1 / K2 / FA launch counts; then one eager frame
     step with each fast decode under set_sync_debug_mode("error"), the
     captured graph against the eager step (the same tokens, greedy float32
     and seeded bf16, B = 1 and 16), `generate` (B = 1) and
     `generate_batched` (B = 16 and 64) over 128 frames: frames/s, the
     steady frame's ms beside one eager frame step's, the device's idle
     share and top kernels over two replays, the capture's seconds and the
     host's reads per generation; and greedy agreement of the three
     generation forms;
 10. FA, its plain version and PyTorch's scaled_dot_product_attention (a
     yardstick only: nothing in the port calls it) at the main-path shape,
     with FA's launch (grid, threads and shared memory per block);
 11. K2-v1 (the whole AMP stage in one launch on the tensor cores in
     clusters of 8 CTAs; bf16, or float32 on split-TF32 products) against its plain
     version at the two flagship widths it holds (C = 48 and 24), at a
     codec request's lengths and at a streaming window's (the path that
     launches it), float32 and bfloat16, ragged lengths and widths (C = 5,
     7, 40 in both dtypes), its refusal of a wider stage, its launch (grid,
     threads, shared memory, cluster), and its time beside K2's in v1 mode
     (the same contract, 18 launches) and v2 mode and the plain version's
     at both, in bf16 and in float32; K2 in v1 mode (what `use_v2=False` runs at the
     wider fused stages) against the same plain version at s2 (C = 192)
     and s3 (C = 96), and its time beside K2's v2 mode; K1 and K2 timed at
     the window's shapes too;
 12. window invariance of K1, K2-v1 and K2 (at three widths) in float32,
     of K1 and K2-v1 in bf16 and of K2 in bf16 at three widths: a kernel run
     on a slice of the signal gives the bits
     of its run on the whole signal, beyond its receptive field from the
     cuts;
 13. the streaming path at full width (models/streaming.py): chunked
     against one-shot on an 8 s clip in float32 (tokens equal, decode and
     vocoder within tolerance, both `use_v2`), a 10-minute clip through
     `chunked_vocode` in bfloat16 and in float32 with both `use_v2`
     (seconds, xRT, peak device memory, launch counts by kernel; a profile
     of two float32 windows must name both float32 kernels), 60 s
     through encode -> decode -> vocode, and `cli.stream_codec.main` on a
     WAV written here (a float32 vocoder: the split-TF32 kernels), and once
     more in a fresh process that turned TF32 on first: its `main` must
     turn TF32 off for cuBLAS and cuDNN itself (the float32 contract);
 14. the K1 ablation probe: each variant against its plain version, and
     the probe's own table of times;
 15. every kernel's bound on this card;
 16. FA's backward kernels (FA-dKV, FA-dQ) against their plain versions at
     the slow decoder's head layout (B = 2 x S = 2048 and the trainer's
     2 x 1024), ragged lengths, head sizes 16 to 128 and a group of one
     query head, float32 (FA-dQ split-TF32 on the tensor cores, FA-dKV on
     the CUDA cores) and bfloat16 (tensor cores); two runs
     bit-equal; the forward's log-sum-exp against the plain scores';
 17. LM training at full width through the trainer (float32 parameters,
     flash attention on, B = 2 x S = 1024 token-grid batches,
     accumulate_grad = 2, 4 micro-steps = 2 updates): launch counts of FA,
     FA-dKV and FA-dQ per micro-step, the loss and the first micro-step's
     gradients with the kernels on against `flash_attention=False`,
     parameters changing only on update steps, a LoRA step leaving the base
     untouched; then ms per micro-step, peak memory and tokens/s with the
     kernels (and a torch.profiler breakdown of one accumulation cycle, which
     must name the split-TF32 FA and FA-dQ kernels), without them and with
     `remat`, and at 2 x 2048 with and without `remat`;
 18. LM training through the entry point: `cli.train_lm.main` on 8 synthetic
     WAVs with a small LM (the flagship codec tokenizes), checkpoints, a
     resumed run, then `cli.infer_lm.main` on the result;
 19. FA-dKV and FA-dQ timed beside their plain versions and the backward of
     PyTorch's scaled_dot_product_attention (a yardstick only), their bounds
     and their launches (grid, threads and shared memory per block);
 20. the probe kernels P1 (channels-first anti-aliased snake with a
     run-time window), P2 / P3 (row-shifted sums of a resident plane) and
     P4 (11-tap conv as a tap matmul: wgmma where the shape allows, else
     mma.sync) against their plain versions at every shape, window, width
     (P4: C = 96 and 192) and plane count the probes' tables time and at
     ragged ones (P1: odd C, T of 7..257 around a unit, tasks of 1, 2 and
     64 units; P2 / P3: column counts off the float4 path on odd plane
     counts, rows = out_rows + 9, 4,096 planes), P1 against K1 in the
     interior, then the probes' own checks and tables of times (P2 / P3
     per call and on the device in a CUDA graph, the wrapper's host cost
     part by part; P4's launches counted by kernel), bounds (P1 by bytes,
     by operations and its SASS issue floor from phase 5) and the library
     calls' times (yardsticks only: P2 one depthwise F.conv1d, P3 one
     depthwise circular nn.Conv1d, P4 one F.conv1d);
 21. codec GAN training at full width through `CodecTrainer` (float32,
     B = 16 clips x 4 s from a numpy seed, one clip of half length, given
     decoder noise): 4 checked steps (nine finite metrics, nothing moves at
     the first update's lr 0, both networks move at the second), a second
     run from the same state and noise, `freeze_encoder`, then ms per step,
     seconds of audio per second, peak memory (split into what is
     allocated between steps and what a step adds), the step by kernel and part by part
     (torch.profiler over the trainer's ranges), the same with PyTorch's
     default TF32 convs, and the flagship's 210 s batch (52 x 4 s);
 22. codec training through the entry point: `cli.train_codec.main` on 8
     synthetic WAVs at the flagship width, checkpoints at 2 and 4, a resumed
     run to 6, then `cli.stream_codec.main` serving the `gen_params` it wrote;
 23. overfit: one fixed synthetic batch (sums of sines and noise bursts), a
     raised learning rate, up to 250 steps or 60 s: `val_loss` falls below
     a stated fraction of its start;
 24. evaluation: `cli.evaluate.main` (default device) on 8 synthetic 24 kHz
     clips of 2.5 to 6 s, a flagship float32 DMelCodec checkpoint and
     BigVGAN state_dict with seeded random weights, `compute_pesq`: finite
     means, K1 / K2 launch counts (every K2 launch on the split-TF32
     kernel), seconds of audio per second split into the codec's device time
     (CUDA events) and the host metrics; the same batches through
     `Evaluation.step` with the kernels and with their plain versions (the
     entropy equal, the other columns within stated tolerances); ECAPA-TDNN
     at speechbrain's voxceleb width from an `embedding_model.ckpt` (a
     finite spk_sim; the card against the CPU); SpeechTokenizer, EnCodec
     24 kHz and Firefly at their published widths through `Evaluation.run`
     on the clips resampled to their rates (codes inside their codebooks,
     one clip on the card against the CPU); `make_codec("dac" / "mimi")`
     raising its ImportError without transformers;
 25. the host path: `cli.preprocess` on 20 seeded WAVs (int16 / int32 /
     float32, mono and stereo, 16 / 24 / 44.1 kHz), the loader with the
     native C++ decode and with scipy (within 2e-5; the native build's
     seconds and each backend's seconds of audio decoded per second);
     `cli.convert vqgan` and `bigvgan` on made-up reference files at the
     flagship widths, then `cli.stream_codec` on what they wrote (codes
     equal and audio within 2e-5 of the modules built from the same
     state_dicts; K1 37 and K2 72 split-TF32 launches); `cli.train_lm
     --distributed` in a process group of one rank on NCCL at full width
     (float32, flash attention, 2 x 1024, accumulate_grad = 2, 2 updates;
     FA, FA-dKV and FA-dQ 24 launches each a micro-step) against the same
     run without (losses within 1e-6 relative, ms per micro-step of both);
     `cli.train_codec --distributed` on the preprocessed manifest through
     the native decode (ms per step, the loader's share of the loop's wall
     time). NCCL across two or more ranks needs a second card;
 26. the rest of the parallel layer in a process group of one rank on NCCL:
     `LMTrainer.shard_state` on `dp_tp_mesh(model=1, data=1)`, tensor
     parallel and tensor parallel + FSDP (every collective over a group of
     one), 4 micro-steps at full width against phase 17's plain trainer on
     the same seed and batches (losses within 1e-6 relative; FA, FA-dKV and
     FA-dQ 24 launches each a micro-step), then ms per micro-step and peak
     memory; FA, FA-dKV and FA-dQ against their plain versions at one rank's
     head layout under 2-way tensor parallelism, [2, 1024, 7 -> 1, 64],
     float32 and bf16; `pipelined_decoder` (1 stage, 2 microbatches) over
     the slow decoder, flash on, against the plain decoder (hidden state,
     gradients, 48 launches of each FA kernel); `time_sharded_encode` /
     `decode` on 2 x 60 s at the flagship codec width against the
     one-process encode / decode (tokens equal, mel within 1e-5), timed;
 27. the public modules beside the main path, float32, on the card against
     the same seeded weights on the CPU: `FireflyGAN` at the
     firefly-gan-base defaults (1 x 173 frames checked; 2 x 861 frames of
     128-band mel, about 20 s of 44.1 kHz audio, timed: seconds of audio
     per second), `WaveNet(is_diffusion=True)` at the codec decoder's width
     and depth with a condition and a step t (1 x 375 frames checked,
     16 x 375 timed), and `Snake`, `UpSample1d` and `DownSample1d` at s1's
     shape [16, 384, 5952], timed.
The comparison phases run with TF32 off for cuBLAS and cuDNN, as the entry
points run (each `main` calls `strict_float32`). The
line before the last is one JSON object describing the kernels; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# the CUDA-event timer and the card's published peaks, shared with the probes' tables
from dmel_codec_tpu_torch.probes.timing import PEAK_BF16, PEAK_BYTES, PEAK_F32, PEAK_TF32, cuda_ms

SECONDS, BATCH, SR, HOP = 4, 16, 24000, 256
FUSE_MAX_CHANNELS = 192
DEVICE = "cuda:0"
K1_SOURCE = "dmel_codec_tpu_torch/csrc/anti_alias.cu"
K2_TF32_SOURCE = "dmel_codec_tpu_torch/csrc/stage_fused_tf32.cu"
K2_TC_SOURCE = "dmel_codec_tpu_torch/csrc/stage_fused_tc.cu"
FA_SOURCE = "dmel_codec_tpu_torch/csrc/flash_attention.cu"
FA_BWD_SOURCE = "dmel_codec_tpu_torch/csrc/flash_attention_bwd.cu"
V1_SOURCE = "dmel_codec_tpu_torch/csrc/stage_fused_v1.cu"
PROBES_SOURCE = "dmel_codec_tpu_torch/csrc/probes.cu"
CODEC_TRAIN_BATCH, CODEC_TRAIN_BIG_BATCH, OVERFIT_SECONDS, OVERFIT_STEPS, OVERFIT_LR = 16, 52, 60.0, 250, 3e-3
LONG_MINUTES, CHAIN_SECONDS, CLI_SECONDS, EXACT_SECONDS = 10, 60, 20, 8
VOCODE_CHUNK, VOCODE_HALO = 480, 40
LM_BATCH, LM_SEQ, LM_FRAMES, SERVE_BATCH = 2, 2048, 128, 16
TRAIN_SEQ, TRAIN_ACCUMULATE, TRAIN_MICRO_STEPS = 1024, 2, 4
# K1's arithmetic per output sample: two 6-tap polyphase up FIRs (24 flops)
# and their gain (2), two snakes (mul, sin, mul, fma: 8), one 12-tap down
# FIR (24).
K1_FLOPS_PER_SAMPLE = 58


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


# Tolerances, relative to max(1, max |plain|):
#  K1 f32: sinf and the 6-tap FIR sums in another order than the plain
#    chain's cuDNN convs, ~1e-7 relative per op: 1e-6.
#  K1 bf16: both sides compute in float32 and round once; a result next to
#    a rounding boundary may round the other way: one bf16 ulp, 2^-7.
#  K2 f32: 36 chained ops, each ~1e-7 relative apart, amplified by the
#    random weights' gain: 2e-5. The split-TF32 products lose the split's
#    remainders (2^-22 of each operand) and A_lo B_lo: one conv measured
#    within 6e-6 of a float64 one, beside the float32 conv's 2.3e-6
#    (probes/tf32_split.py); 2e-5 holds.
#  K2 bf16: 54 bf16 rounding points on each side; a flip there is one ulp
#    (<= 2^-7) and flips compound down the chain: 5e-2.
#  K2 launch bf16 (one act -> conv launch against act_conv_reference): both
#    sides take the same bf16 operands and sum in float32 in another order
#    (the tensor cores; cuDNN's FIR convs and torch.sin in the plain
#    version), so an activation value next to a rounding boundary may round
#    the other way (2^-8 of itself, in one product of C x k) and the conv's
#    output, rounded to bf16 under v2 and in a bf16 out, may land one
#    rounding away: one bf16 ulp of max |out| for each of the two roundings
#    and as much again for the flips: 2^-6.
#  K2-v1 f32: as K2.
#  K2-v1 bf16: both sides keep the planes float32 and round only the 18
#    conv operands and the result; one bf16 ulp of the output for a result
#    next to a rounding boundary and one for operand flips that compound
#    down the chain: 2^-6.
#  Chunked vs one-shot, float32: the kernels give the same bits wherever
#    the window lies (phase 12); the cuDNN convs around them could pick
#    another algorithm (and so summation order) for another T, ~1e-7
#    relative per op over 20 layers: 1e-5 for the decode, 2e-5 (K2's own)
#    per vocoder stage, and 2e-5 absolute end to end, which the JAX package
#    asserts on its XLA path (scripts/bench_streaming.py:72; its kernel path
#    is off by 1.58e-1 there, BENCHMARKS.md:270-282). On an NVIDIA H100 with
#    torch 2.11 every one of these differences measured 0.
#  FA f32: the kernel's products are split-TF32 (hi + lo of each operand,
#    three TF32 products: the split's remainders and A_lo B_lo, 2^-22
#    relative each, are lost), the plain version's float32; exp of scores
#    up to ~5 that were summed in another order (1e-6 relative each) and
#    ~2000-term sums: 2e-5.
#  FA bf16: both sides compute in float32 from the same bf16 inputs and
#    round once, where a result next to a rounding boundary may round the
#    other way: one bf16 ulp, 2^-7. The kernel also rounds P to bf16 before
#    P V (the tensor cores take bf16; jax's kernel does the same), the plain
#    version does not: that moves an output by at most 2^-9 sum_t P_t |v_t|
#    <= 2^-9 max |v| before its rounding. `fa_rel` adds that term, per case.
#  FA-dKV / FA-dQ f32: the same recomputation from the same L and D
#    (FA-dQ's products split-TF32, as FA's); sums of up to ~2000 x 7 terms
#    in another order: 2e-5 (of max(1, max |grad|)).
#  FA-dKV / FA-dQ bf16: both sides compute in float32 from the same bf16
#    inputs and round once; a gradient is a sum over up to 14,000 products,
#    so a result may land two roundings away: two bf16 ulps, 2^-6. FA-dKV
#    also rounds P^T and dS^T to bf16 before its two accumulating products
#    (as jax's kernel does), and FA-dQ rounds scale * dS before dS K (as
#    jax's kernel does): 2^-9 relative per term, of random sign, so the
#    sum moves by ~2^-9 of its own size, under one ulp; 2^-6 holds.
#  LM logits, flash on vs off, bf16: the einsum path rounds scores and
#    probabilities to bf16 (2^-8 relative each) in each of 24 layers where
#    FA keeps them float32; the differences add up along the residual
#    stream (and through the 12 fast layers behind it): 1e-2 of max |logit|
#    on average, and 12 times that for the largest of ~10^8 logits.
TOL = {("K1", torch.float32): 1e-6, ("K1", torch.bfloat16): 2.0**-7,
       ("K2", torch.float32): 2e-5, ("K2", torch.bfloat16): 5e-2, ("K2 launch", torch.bfloat16): 2.0**-6,
       ("K2-v1", torch.float32): 2e-5, ("K2-v1", torch.bfloat16): 2.0**-6,
       ("FA", torch.float32): 2e-5, ("FA", torch.bfloat16): 2.0**-7,
       ("FA-bwd", torch.float32): 2e-5, ("FA-bwd", torch.bfloat16): 2.0**-6}
# LM training, kernels on vs `flash_attention=False`, float32: the loss is a
# mean over ~20,000 positions of values that agree to ~1e-6: 1e-4 relative.
# A parameter's gradient sums such differences over 2048 positions and up to
# 36 layers: 1e-3 of the tensor's largest gradient.
TOL_TRAIN_LOSS, TOL_TRAIN_GRAD = 1e-4, 1e-3
TOL_LM_MAX, TOL_LM_MEAN = 1.2e-1, 1e-2


def fa_rel(dt: torch.dtype, v: torch.Tensor, want: torch.Tensor) -> float:
    """FA's tolerance relative to max(1, max |plain|): TOL["FA"], and in bf16
    the bound 2^-9 max |v| of the kernel's rounding of P (comment above)."""
    if dt == torch.float32:
        return TOL[("FA", dt)]
    return TOL[("FA", dt)] + 2.0**-9 * v.float().abs().max().item() / max(1.0, want.float().abs().max().item())
TOL_CHUNKED_DECODE, TOL_CHUNKED_STAGE, TOL_CHUNKED_WAVE = 1e-5, 2e-5, 2e-5
# The probes, relative to max(1, max |plain|):
#  P1 f32: sinf and 6-tap sums in another order than the plain version's
#    sliced sums, ~1e-7 relative per op (K1's 1e-6 would do): 2e-5, the gate
#    of the JAX probe it replaces. P1 bf16: one bf16 ulp, as K1.
#  P1 vs K1 beyond 16 samples from the ends, f32: the same warp walker
#    (csrc/snake_units.cuh) in the same order (measured 0): 2e-5.
#  P2, P3: the plain version's additions in the same order: the same bits.
#  P4: bf16 operands are exact in float32, so only the order of 11 x C
#    float32 additions per output differs between the tensor cores and the
#    plain float32 product (TF32 off): ~1e-6 of max |y| measured at C = 96,
#    ~3e-6 at C = 192; 1e-4 of max |y| (1e-2 would still tell a wrong
#    fragment or descriptor layout apart).
TOL_P1 = {torch.float32: 2e-5, torch.bfloat16: 2.0**-7}
TOL_P4 = 1e-4
# Codec training: a second run from the same state, batches and noise. cuDNN
# may pick a backward algorithm that adds with atomics, so runs need not be
# bit-equal; the losses are means over ~10^5 values that agree to ~1e-6:
# 1e-4 relative. Overfit: the lowest val_loss reading (masked mel L1 at
# quality 2.0, every 50 steps) must fall below this fraction of its value at
# step 0, and the last reading below that value.
TOL_RERUN, OVERFIT_FRACTION = 1e-4, 0.3


# Run in a fresh process from the checkout's root: turn TF32 on (PyTorch
# lets cuDNN convs use it by default), run an entry point's main, print what
# the process allows afterwards (utils/precision.tf32_flags).
CLI_TF32_PROBE = """
import importlib, json, sys
import torch
torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
importlib.import_module("dmel_codec_tpu_torch.cli." + sys.argv[1]).main(sys.argv[2:])
from dmel_codec_tpu_torch.utils.precision import tf32_flags
print(json.dumps(tf32_flags()))
"""


def stage_shapes(vcfg, frames: int):
    t = frames
    for i, u in enumerate(vcfg.upsample_rates):
        t *= u
        yield i, vcfg.stage_channels(i), t


def fa_bound_ms(b: int, s: int, h: int, kh: int, hd: int, itemsize: int, rate: float | None = None):
    """Least time for causal attention on this card: q and the output once,
    k and v once, against 4 * hd flops per visible (query, key) pair at
    `rate` (default: the tensor-core rate of bf16 inputs, float32 the CUDA
    cores'; the split-TF32 kernels' three products: PEAK_TF32 / 3)."""
    nbytes = (2 * b * s * h * hd + 2 * b * s * kh * hd) * itemsize
    flops = 4 * hd * b * h * s * (s + 1) // 2
    by_ops = flops / (rate or (PEAK_BF16 if itemsize == 2 else PEAK_F32)) * 1e3
    by_bytes = nbytes / PEAK_BYTES * 1e3
    return max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes"


def stage_bound_ms(stages, batch: int, kernel_sizes, itemsize: int = 2, conv_rate: float | None = None):
    """Least time for fused AMP stages [(C, T), ...] in bf16 (itemsize 2)
    or float32 (4): per stage 18 convs of C x C x k (six of each kernel
    size) at `conv_rate` (default: the tensor-core rate of bf16 operands,
    float32 the CUDA cores'; the split-TF32 kernels' three products:
    PEAK_TF32 / 3), 18 float32 activations, the plane in and out once and
    the weights once. Returns {"bytes": ms, "operations": ms}."""
    conv = act = nbytes = 0.0
    for c, t_len in stages:
        n = batch * c * t_len
        conv += 2 * c * n * 6 * sum(kernel_sizes)
        act += 18 * K1_FLOPS_PER_SAMPLE * n
        nbytes += 2 * n * itemsize + 6 * sum(kernel_sizes) * c * c * itemsize
    conv_peak = conv_rate or (PEAK_BF16 if itemsize == 2 else PEAK_F32)
    return {"bytes": nbytes / PEAK_BYTES * 1e3,
            "operations": max(conv / conv_peak, act / PEAK_F32) * 1e3}


@torch.no_grad()
def stagewise_window_error(fused, mel: np.ndarray, dev) -> float:
    """The chunked-vs-one-shot gate of the serving vocoder, stage by stage:
    every stage runs on each window's slice of its one-shot input and is
    held against the same region of its one-shot output, beyond 128
    samples (more than a stage reaches) from a cut that is not a signal
    edge. Returns the largest error relative to max(1, max |one-shot|)."""
    from dmel_codec_tpu_torch.models.streaming import window_positions

    t = mel.shape[1]
    window = VOCODE_CHUNK + 2 * VOCODE_HALO
    xs = [fused.pre(torch.from_numpy(mel).to(dev))]
    for i in range(len(fused.stages)):
        xs.append(fused.stage(i, xs[-1]))
    worst = 0.0
    for _, pos in window_positions(t, VOCODE_CHUNK, VOCODE_HALO):
        rate = 1
        for i, u in enumerate(fused.config.upsample_rates):
            out = fused.stage(i, xs[i][:, :, pos * rate : (pos + window) * rate].contiguous())
            rate *= u
            lo = 0 if pos == 0 else 128
            hi = out.shape[2] - (0 if pos + window == t else 128)
            want = xs[i + 1][:, :, pos * rate + lo : pos * rate + hi]
            worst = max(worst, max_err(out[:, :, lo:hi], want) / max(1.0, want.abs().max().item()))
    return worst


def set_flash(model: torch.nn.Module, on: bool) -> None:
    """Switch the slow decoder between the flash kernel and the einsum path."""
    from dmel_codec_tpu_torch.models.transformer import Attention, Decoder

    for m in model.slow_decoder.modules():
        if isinstance(m, (Attention, Decoder)):
            m.config = dataclasses.replace(m.config, flash_attention=on)


def profile_once(what: str, fn, parts: str = "", kernels: dict | None = None, totals: dict | None = None) -> dict:
    """Device kernel time by name over one call (torch.profiler, CUDA
    activity). Busy share = summed kernel time / the call's wall time under
    the profiler (its own host overhead inflates the idle share). A
    `record_function` range shows on the device's timeline too, under its
    own name, from its first kernel's start to its last kernel's end: those
    are left out of the kernels' sum. The ranges whose name starts with
    `parts` (if given) are logged and returned as {part: ms}; a range nested
    in one of them (the optimizer's own) takes its kernels from it, so a
    part ends where the last range that began inside it ends. `kernels`,
    if given, receives {kernel name: ms} of the call, `totals` {"wall_ms",
    "busy_ms", "idle"}."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # one small kernel first: the device tracing may miss what is launched right after it starts
        torch.zeros(1, device=DEVICE).add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    host_names = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    by_name, ranges = defaultdict(lambda: [0.0, 0]), []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name in host_names:  # a range's span on the device, not a kernel
                ranges.append([e.time_range.start, e.time_range.end, e.name])
            else:
                by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
                by_name[e.name][1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    if kernels is not None:
        kernels.update({name: v[0] for name, v in by_name.items()})
    if not by_name:
        log(f"  profile of {what}: no device time recorded (not measured)")
        return {}
    if totals is not None:
        totals.update(wall_ms=wall_ms, busy_ms=busy_ms, idle=1 - busy_ms / wall_ms)
    log(f"  profile of {what}: wall {wall_ms:.2f} ms, kernels {busy_ms:.2f} ms, "
        f"device idle share {1 - busy_ms / wall_ms:.3f}")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"    {ms:9.3f} ms  x{n:<5d} {name[:100]}")
    spans = sorted(r for r in ranges if parts and r[2].startswith(parts))
    for start, end, name in ranges:
        inside = [r for r in spans if r[0] <= start] if not (parts and name.startswith(parts)) else []
        if inside:
            inside[-1][1] = max(inside[-1][1], end)
    by_part = {name[len(parts):]: (end - start) / 1e3 for start, end, name in spans}
    if by_part:
        log(f"  {what} by part (each range's span on the device, {sum(by_part.values()):.2f} ms in all): "
            + "; ".join(f"{k} {v:.2f} ms ({v / sum(by_part.values()):.1%})" for k, v in by_part.items()))
    return by_part


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
    from dmel_codec_tpu_torch.ops.stage_fused import stage_reference, stage_reference_v1

    def plain_stage(x, packed, spec, v1=False):
        return (stage_reference_v1 if v1 else stage_reference)(x, packed, spec)

    saved = bigvgan.anti_alias_activation, bigvgan.amp_stage, bigvgan.amp_stage_v1
    bigvgan.anti_alias_activation, bigvgan.amp_stage = anti_alias_activation_reference, plain_stage
    bigvgan.amp_stage_v1 = stage_reference_v1
    try:
        yield
    finally:
        bigvgan.anti_alias_activation, bigvgan.amp_stage, bigvgan.amp_stage_v1 = saved


# Phase 24, evaluation. Tolerances, absolute in each column's unit:
#  kernel path vs plain path (the same checkpoint, batches and decoder
#    noise): the float32 vocoder's kernels sit within 2e-6 of their plain
#    versions per stage (phase 6), so the waveforms differ by ~1e-5 of their
#    peak; the harness's columns move by far less than these bounds, which
#    still tell a wrong kernel apart (any column off by a percent):
#    si_snr 1e-3 dB, mel_l1 1e-4, stoi 1e-4, f0_corr 1e-3, pesq 1e-3. The
#    encoder runs no kernel: codebook_entropy_mean must be equal.
#  ECAPA on the card vs the same module on the CPU: float32 convs (TF32
#    off) in another summation order through ~12 layers: 1e-4 of max |CPU|.
#  zoo, card vs CPU: a code may flip where two codes (RVQ) or two levels
#    (FSQ) are within the float32 rounding of a tie, and an RVQ flip moves
#    the later layers' residuals: at most 1 % of the codes may differ;
#    audio decoded from the same codes, float32 convs and LSTMs in another
#    order: 1e-4 of max(1, max |CPU|).
TOL_EVAL_PLAIN = {"si_snr": 1e-3, "mel_l1": 1e-4, "stoi": 1e-4, "f0_corr": 1e-3, "pesq": 1e-3}
TOL_ECAPA, TOL_ZOO_CODES, TOL_ZOO_AUDIO = 1e-4, 1e-2, 1e-4
EVAL_CLIPS, EVAL_MAX_DURATION = 8, 30.0


def eval_clips(seed: int):
    """8 clips at 24 kHz, 2.5 to 6 s: sums of four sines with a vibrato and
    two 0.1 s noise bursts each, from a numpy seed."""
    rng = np.random.default_rng(seed)
    clips = []
    for i in range(EVAL_CLIPS):
        t = np.arange(int((2.5 + 0.5 * i) * SR)) / SR
        x = np.zeros(t.size)
        for amp, freq in zip(rng.uniform(0.05, 0.3, 4), rng.uniform(100.0, 3000.0, 4)):
            x += amp * np.sin(2 * math.pi * freq * (t + 0.002 * np.sin(2 * math.pi * 5.0 * t)))
        for start in rng.integers(0, t.size - SR // 10, 2):
            x[start : start + SR // 10] += 0.2 * rng.standard_normal(SR // 10)
        clips.append(x.astype(np.float32))
    return clips


class CodecTimer:
    """Wraps an adapter's (or an adapter class's) encode and decode: CUDA
    events around each call (its device work, copies included), summed."""

    def __init__(self, target):
        self.target, self.ms, self.saved = target, 0.0, {}

    def __enter__(self):
        for name in ("encode", "decode"):
            fn = self.saved[name] = getattr(self.target, name)

            def timed(*args, _fn=fn, **kwargs):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                result = _fn(*args, **kwargs)
                end.record()
                end.synchronize()
                self.ms += start.elapsed_time(end)
                return result

            setattr(self.target, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            if isinstance(self.target, type):
                setattr(self.target, name, fn)
            else:
                delattr(self.target, name)


def evaluation_phase(dev) -> dict:
    """Phase 24: the evaluation entry point and harness on the card (see the
    module docstring). Returns the numbers for the JSON line."""
    import io

    from scipy.io import wavfile

    from dmel_codec_tpu_torch.cli import evaluate
    from dmel_codec_tpu_torch.cli.common import load_codec_adapter
    from dmel_codec_tpu_torch.data.audio import resample_audio
    from dmel_codec_tpu_torch.data.loader import BucketBatcher, DataLoader
    from dmel_codec_tpu_torch.data.manifest import load_manifest
    from dmel_codec_tpu_torch.eval import ecapa
    from dmel_codec_tpu_torch.eval.codecs import DMelCodecAdapter, make_codec
    from dmel_codec_tpu_torch.eval.evaluation import Evaluation
    from dmel_codec_tpu_torch.eval.metrics import detect_f0
    from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
    from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
    from dmel_codec_tpu_torch.ops.anti_alias import anti_alias_activation
    from dmel_codec_tpu_torch.ops.stage_fused import amp_stage
    from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager

    out: dict = {}
    clips = eval_clips(24)
    audio_s = sum(c.size for c in clips) / SR
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        with open(tmp / "test.jsonl", "w") as f:
            for i, clip in enumerate(clips):
                wavfile.write(tmp / f"clip{i}.wav", SR, clip)
                f.write(json.dumps({"id": f"e{i}", "audio_path": str(tmp / f"clip{i}.wav"),
                                    "duration": clip.size / SR, "text": ""}) + "\n")
        torch.manual_seed(24)
        CheckpointManager(str(tmp / "codec")).save(0, {"gen_params": DMelCodec(DMelCodecConfig()).state_dict()})
        torch.save(jitter_snake(BigVGAN(BigVGANConfig())).state_dict(), tmp / "bigvgan_generator.pt")
        (tmp / "eval.yaml").write_text(
            f"codec_ckpt_dir: {tmp / 'codec'}\nvocoder_ckpt: {tmp / 'bigvgan_generator.pt'}\n"
            f"test_manifest: {tmp / 'test.jsonl'}\nmax_duration: {EVAL_MAX_DURATION}\nwhisper_path: null\n"
            "compute_pesq: true\ncompute_spk_sim: false\n")
        cuts = load_manifest(str(tmp / "test.jsonl"))
        n_batches = len(BucketBatcher(cuts, EVAL_MAX_DURATION, shuffle=False).batches())

        # (a) the entry point on the card: flagship float32 codec + vocoder
        log(f"evaluation: cli.evaluate.main on {EVAL_CLIPS} synthetic clips ({audio_s:.1f} s of 24 kHz audio, "
            f"{n_batches} batches), flagship float32 DMelCodec + BigVGAN with seeded random weights, compute_pesq")
        run_s = []
        real_run = Evaluation.run

        def timed_run(self, batches_):
            t0_ = time.perf_counter()
            result_ = real_run(self, batches_)
            run_s.append(time.perf_counter() - t0_)
            return result_

        anti_alias_activation.launches = amp_stage.launches = 0
        amp_stage.launches_by_kernel.update(act_conv_tc_kernel=0, act_conv_tf32_kernel=0)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with CodecTimer(DMelCodecAdapter) as timer, contextlib.redirect_stdout(buf):
            Evaluation.run = timed_run
            try:
                evaluate.main(["--config", str(tmp / "eval.yaml")])  # the default device: the card
            finally:
                Evaluation.run = real_run
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {"K1": anti_alias_activation.launches, "K2": amp_stage.launches, **amp_stage.launches_by_kernel}
        means = json.loads(buf.getvalue())
        log("  means: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(means.items())))
        # the adapter's FusedBigVGAN fuses the stages of at most 192 channels
        vcfg = BigVGANConfig()
        n_fused = sum(vcfg.stage_channels(i) <= FUSE_MAX_CHANNELS for i in range(len(vcfg.upsample_rates)))
        want_k1, want_k2 = (len(vcfg.upsample_rates) - n_fused) * 18 + 1, n_fused * 18
        host_s = run_s[0] - timer.ms / 1e3
        log(f"  launches {launches} (expected K1 {n_batches} x {want_k1}, K2 {n_batches} x {want_k2}, all on "
            f"act_conv_tf32_kernel); wall {wall_s:.2f} s with loading, Evaluation.run {run_s[0]:.2f} s = codec "
            f"{timer.ms / 1e3:.2f} s (CUDA events around encode + decode) + host metrics {host_s:.2f} s; "
            f"{audio_s / run_s[0]:.2f} s of audio per s ({audio_s / (timer.ms / 1e3):.2f} through the codec alone)")
        # f0_corr (Pearson's r of the two pitch tracks over frames voiced in
        # both) is left out by the harness, as by the JAX one, where it is
        # undefined: checked in (c) when it is missing here
        required = {"si_snr", "mel_l1", "stoi", "codebook_entropy_mean", "pesq"}
        assert required <= set(means) <= required | {"f0_corr"}, means
        assert all(math.isfinite(v) for v in means.values()), means
        assert launches == {"K1": n_batches * want_k1, "K2": n_batches * want_k2, "act_conv_tc_kernel": 0,
                            "act_conv_tf32_kernel": n_batches * want_k2}, launches
        out["cli"] = {"means": means, "launches": launches, "batches": n_batches, "audio_s": audio_s,
                      "wall_s": wall_s, "run_s": run_s[0], "codec_s": timer.ms / 1e3, "host_s": host_s,
                      "audio_s_per_s": audio_s / run_s[0], "codec_audio_s_per_s": audio_s / (timer.ms / 1e3)}

        # (b) the same batches through Evaluation.step, kernels against plain
        batches = list(DataLoader(cuts, max_duration=EVAL_MAX_DURATION, shuffle=False))
        runs = []
        for plain in (False, True):
            adapter = load_codec_adapter(str(tmp / "codec"), vocoder_ckpt=str(tmp / "bigvgan_generator.pt"))
            with plain_kernels() if plain else contextlib.nullcontext():
                runs.append([Evaluation(adapter, compute_pesq=True, device=dev).step(b) for b in batches])
            del adapter
        assert all(g.keys() == w.keys() for g, w in zip(*runs)), runs
        diffs = {k: max(abs(g[k] - w[k]) for g, w in zip(*runs)) for k in runs[0][0]}
        log("  kernel path vs plain path, largest difference per column over the batches: "
            + ", ".join(f"{k} {v:.3e}" for k, v in sorted(diffs.items()))
            + f" (tolerances {TOL_EVAL_PLAIN}; entropy must be equal)")
        assert diffs["codebook_entropy_mean"] == 0.0, diffs
        assert all(v <= TOL_EVAL_PLAIN[k] for k, v in diffs.items() if k != "codebook_entropy_mean"), diffs
        out["kernel_vs_plain"] = diffs

        # the pitch tracks of the reconstructions: a random vocoder's output is
        # smooth, so the tracker may find one lag in every voiced frame, and a
        # constant track leaves Pearson's r undefined
        adapter = load_codec_adapter(str(tmp / "codec"), vocoder_ckpt=str(tmp / "bigvgan_generator.pt"))
        pitches = set()
        distinct = []
        for b in batches:
            rec = adapter.rec_audio_from_audio(b["audios"], b["audio_lengths"])
            for i, n in enumerate(b["audio_lengths"]):
                f0 = detect_f0(rec[i, : min(n, rec.shape[1])], SR)
                distinct.append(len(np.unique(f0[f0 > 0])))
                pitches |= set(np.unique(f0[f0 > 0]).round(2).tolist())
        log(f"  the reconstructions' pitch tracks: {distinct} distinct F0 values over the voiced frames of each clip "
            f"({sorted(pitches)[:6]} Hz); f0_corr {'in the means' if 'f0_corr' in means else 'undefined, so left out'}")
        if "f0_corr" not in means:
            assert max(distinct) <= 1, distinct
        out["cli"]["rec_f0_distinct"] = distinct

        # (c) ECAPA at speechbrain's voxceleb width, seeded random weights
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(25)
            torch.save(ecapa.ECAPA_TDNN().state_dict(), tmp / "embedding_model.ckpt")
        spk = Evaluation(adapter, compute_pesq=False, spk_weights_path=str(tmp / "embedding_model.ckpt"),
                         device=dev)
        spk_sim = spk.run(batches[:1]).means["spk_sim"]
        model = spk.spk_params
        clip16 = torch.from_numpy(resample_audio(clips[0], SR, 16000)).to(dev)
        ecapa_ms = cuda_ms(lambda: ecapa.embed(model, ecapa.ecapa_fbank(clip16)), reps=10)
        fb = ecapa.ecapa_fbank(clip16)
        got = ecapa.embed(model, fb)
        want = ecapa.embed(copy.deepcopy(model).cpu(), fb.cpu())
        ecapa_err = max_err(got.cpu(), want) / want.abs().max().item()
        log(f"  ECAPA-TDNN C = 1024, embedding 192, scale 8 ({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M): "
            f"spk_sim {spk_sim:.4f} over batch 0, {ecapa_ms:.2f} ms per {clips[0].size / SR:.1f} s clip (fbank + "
            f"embed), card vs CPU {ecapa_err:.3e} of max |CPU| (tol {TOL_ECAPA:g})")
        assert math.isfinite(spk_sim) and -1.0 <= spk_sim <= 1.0, spk_sim
        assert ecapa_err <= TOL_ECAPA, ecapa_err
        out["ecapa"] = {"spk_sim": spk_sim, "ms_per_clip": ecapa_ms, "clip_s": clips[0].size / SR,
                        "card_vs_cpu": ecapa_err}
        del adapter, spk, model

    # (d) the zoo at its published widths, seeded random weights
    out["zoo"] = {}
    for name in ("speechtokenizer", "encodec", "fishspeech"):
        codec = make_codec(name, seed=0)  # the default device: the card
        sr = codec.sample_rate
        zoo_batches = []
        for b in batches:
            parts = [resample_audio(b["audios"][i, : b["audio_lengths"][i]], SR, sr) for i in range(len(b["texts"]))]
            audios = np.zeros((len(parts), max(p.size for p in parts)), np.float32)
            for i, p in enumerate(parts):
                audios[i, : p.size] = p
            zoo_batches.append({"audios": audios, "audio_lengths": np.array([p.size for p in parts]),
                                "texts": b["texts"]})
        codes, _ = codec.encode(zoo_batches[0]["audios"], zoo_batches[0]["audio_lengths"])
        with CodecTimer(codec) as timer:
            t0 = time.perf_counter()
            means = Evaluation(codec, compute_pesq=True, device=dev).run(zoo_batches).means
            run = time.perf_counter() - t0
        clip = zoo_batches[0]["audios"][:1, :sr]
        cpu_codec = make_codec(name, copy.deepcopy(codec.model).cpu(), device="cpu")
        got_codes, _ = codec.encode(clip)
        want_codes, _ = cpu_codec.encode(clip)
        flipped = float(np.mean(got_codes != want_codes))
        want_audio = torch.from_numpy(cpu_codec.decode(want_codes)[0])
        audio_err = max_err(torch.from_numpy(codec.decode(want_codes)[0]), want_audio)
        scale = max(1.0, want_audio.abs().max().item())
        n_params = sum(p.numel() for p in codec.model.parameters()) / 1e6
        log(f"  {name} ({n_params:.1f} M, {sr} Hz, codes {list(codes.shape)} of {codec.config.codebook_size}): "
            + ", ".join(f"{k} {v:.4f}" for k, v in sorted(means.items()))
            + f"; Evaluation.run {run:.2f} s = {audio_s / run:.2f} s of audio per s (codec {timer.ms / 1e3:.2f} s: "
            f"{audio_s / (timer.ms / 1e3):.2f}); 1 s on the card vs the CPU: {flipped:.4%} of {got_codes.size} codes "
            f"differ (tol {TOL_ZOO_CODES:.0%}), audio from the same codes {audio_err:.3e} (tol {TOL_ZOO_AUDIO * scale:.1e})")
        assert 0 <= codes.min() and codes.max() < codec.config.codebook_size, (codes.min(), codes.max())
        assert {"si_snr", "mel_l1", "codebook_entropy_mean", "pesq"} <= set(means), means
        assert all(math.isfinite(v) for v in means.values()), means
        assert flipped <= TOL_ZOO_CODES and audio_err <= TOL_ZOO_AUDIO * scale, (flipped, audio_err)
        out["zoo"][name] = {"params_m": n_params, "sample_rate": sr, "means": means, "run_s": run,
                            "audio_s_per_s": audio_s / run, "codec_s": timer.ms / 1e3,
                            "codes_flipped": flipped, "audio_err": audio_err}
        del codec, cpu_codec
        gc.collect()
        torch.cuda.empty_cache()

    # (e) the adapters that wrap HF transformers raise their guarded error
    # where it cannot be imported (blocked here, whether or not it is installed)
    saved = sys.modules.get("transformers")
    sys.modules["transformers"] = None
    try:
        for name in ("dac", "mimi"):
            try:
                make_codec(name)
            except ImportError as e:
                log(f"  make_codec({name!r}) without transformers raises ImportError: {e}")
                assert f"codec '{name}' needs transformers" in str(e), e
            else:
                raise AssertionError(f"make_codec({name!r}) built without transformers")
    finally:
        if saved is None:
            del sys.modules["transformers"]
        else:
            sys.modules["transformers"] = saved
    return out


# Phase 25, the host data path, the converter and data-parallel training.
# Tolerances:
#  native vs python decode: the same samples through two Kaiser polyphase
#    FIRs that sum in another order: 2e-5 (tests/test_native_audio.py).
#  convert -> stream_codec against the modules built from the same
#    state_dicts: the same weights through the same code on one card: the
#    codes equal, the audio within 2e-5 (phase 13's chunked tolerance).
#  train_lm --distributed at world size 1 against the run without: every
#    all-reduce of one rank returns its input, so only the backward's own
#    nondeterminism can move the losses after the first update: 1e-6
#    relative.
HOST_WAVS, HOST_RATES, LM_CLIP_SECONDS, LM_DIST_RTOL = 20, (16000, 24000, 44100), 42.0, 1e-6


def free_port() -> int:
    import socket

    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        return s_.getsockname()[1]


@contextlib.contextmanager
def timed_calls(owner, name: str, record: list, before=None):
    """Time every call of `owner.name` (synchronised CUDA, ms) into `record`;
    `before(*args)` sees the arguments first."""
    real = getattr(owner, name)

    def timed(*args, **kwargs):
        if before is not None:
            before(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = real(*args, **kwargs)
        torch.cuda.synchronize()
        record.append((time.perf_counter() - t0) * 1e3)
        return result

    setattr(owner, name, timed)
    try:
        yield
    finally:
        setattr(owner, name, real)


@contextlib.contextmanager
def torchrun_env(world: int = 1):
    """The variables torchrun sets, for one process of a `world`-rank group."""
    env = {"RANK": "0", "WORLD_SIZE": str(world), "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def host_path_phase(dev, card: str) -> dict:
    """(a) cli.preprocess on seeded WAVs, then the loader with the native and
    the scipy backend; (b) cli.convert vqgan / bigvgan on made-up reference
    files at the flagship widths, then cli.stream_codec on what they wrote
    against the modules built from the same state_dicts; (c) cli.train_lm
    --distributed in a process group of one rank on NCCL at full width
    against the same run without; (d) cli.train_codec --distributed on (a)'s
    manifest. Every number is printed beside the card."""
    import torch.distributed as dist
    from scipy.io import wavfile

    from dmel_codec_tpu_torch.cli import convert, preprocess, stream_codec, train_codec, train_lm
    from dmel_codec_tpu_torch.data import audio as audio_mod
    from dmel_codec_tpu_torch.data.loader import DataLoader
    from dmel_codec_tpu_torch.data.manifest import load_manifest
    from dmel_codec_tpu_torch.dsp.spectrogram import LogMelSpectrogram
    from dmel_codec_tpu_torch.models import streaming
    from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, FusedBigVGAN
    from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
    from dmel_codec_tpu_torch.models.discriminator import MelDiscriminator
    from dmel_codec_tpu_torch.native import build as native_build
    from dmel_codec_tpu_torch.ops import flash_attention as fa_ops
    from dmel_codec_tpu_torch.ops.anti_alias import anti_alias_activation
    from dmel_codec_tpu_torch.ops.stage_fused import amp_stage
    from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
    from dmel_codec_tpu_torch.train.codec_trainer import CodecTrainer
    from dmel_codec_tpu_torch.train.lm_trainer import LMTrainer

    def say(msg: str) -> None:
        log(f"  [{card}] {msg}")

    out = {"card": card}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # ---- (a) preprocess, then the loader with both decode backends
        log("host path (a): cli.preprocess on seeded WAVs, the loader with the native and the scipy backend")
        wav_dir = tmp / "wavs"
        wav_dir.mkdir()
        rng = np.random.default_rng(25)
        formats = [(np.int16, 1), (np.int32, 2), (np.float32, 1), (np.int16, 2), (np.float32, 2), (np.int32, 1)]
        for i in range(HOST_WAVS):
            dtype, channels = formats[i % len(formats)]
            sr = HOST_RATES[i % len(HOST_RATES)]
            t_ = np.arange(int(sr * (2.0 + 0.1 * i))) / sr
            x = 0.3 * np.sin(2 * math.pi * (150 + 40 * i) * t_) + 0.05 * rng.standard_normal(len(t_))
            x = np.stack([x, 0.8 * x], axis=1) if channels == 2 else x
            scale = {np.int16: 32767, np.int32: 2**31 - 1, np.float32: 1.0}[dtype]
            wavfile.write(wav_dir / f"clip{i:02d}.wav", sr, (x * scale).astype(dtype))
        manifest = tmp / "train.jsonl"
        preprocess.main(["--wav-dir", str(wav_dir), "--out", str(manifest), "--seed", "0"])
        cuts = load_manifest(str(manifest))
        audio_s = sum(c.duration for c in cuts)
        assert len(cuts) == HOST_WAVS, len(cuts)
        real_dir = native_build.BUILD_DIR
        native_build.BUILD_DIR = tmp / "native_build"
        try:
            t0 = time.perf_counter()
            native_build.build()
            build_s = time.perf_counter() - t0
        finally:
            native_build.BUILD_DIR = real_dir
        decoded, rate = {}, {}
        for backend in ("native", "python"):
            decoded[backend] = [audio_mod.load_audio(c.audio_path, SR, backend=backend) for c in cuts]  # warm
            t0 = time.perf_counter()
            for _ in range(3):
                [audio_mod.load_audio(c.audio_path, SR, backend=backend) for c in cuts]
            rate[backend] = 3 * audio_s / (time.perf_counter() - t0)
        assert all(a.shape == b.shape for a, b in zip(decoded["native"], decoded["python"]))
        clip_err = max(float(np.abs(a - b).max()) for a, b in zip(decoded["native"], decoded["python"]))
        batches = {b: list(DataLoader(cuts, sample_rate=SR, max_duration=16.0, shuffle=False, audio_backend=b))
                   for b in ("native", "python")}
        assert len(batches["native"]) == len(batches["python"]) > 1
        loader_err = 0.0
        for a, b in zip(batches["native"], batches["python"]):
            assert np.array_equal(a["audio_lengths"], b["audio_lengths"]) and a["audios"].shape == b["audios"].shape
            loader_err = max(loader_err, float(np.abs(a["audios"] - b["audios"]).max()))
        say(f"preprocess: {len(cuts)} cuts, {audio_s:.2f} s of audio (int16 / int32 / float32, mono and stereo, "
            f"{', '.join(str(r) for r in HOST_RATES)} Hz); native build {build_s:.2f} s; decode and resample to 24 kHz, "
            f"one thread: native {rate['native']:.1f} s of audio per s, python {rate['python']:.1f}; native vs python "
            f"max |diff| {clip_err:.3e} per clip, {loader_err:.3e} over {len(batches['native'])} loader batches "
            f"(tol 2e-5)")
        assert clip_err <= 2e-5 and loader_err <= 2e-5
        out["preprocess"] = {"cuts": len(cuts), "audio_s": audio_s, "native_build_s": build_s,
                             "native_audio_s_per_s": rate["native"], "python_audio_s_per_s": rate["python"],
                             "max_abs_diff": max(clip_err, loader_err)}

        # ---- (b) convert, then serve what it wrote
        log("host path (b): cli.convert vqgan + bigvgan on made-up flagship files, then cli.stream_codec on them")
        ccfg, vcfg = DMelCodecConfig(), BigVGANConfig()
        torch.manual_seed(26)
        gen_sd, disc_sd = DMelCodec(ccfg).state_dict(), MelDiscriminator().state_dict()
        vocoder = BigVGAN(vcfg)
        with torch.no_grad():
            jitter_snake(vocoder)
        torch.save({"state_dict": {**gen_sd, **{f"discriminator.{k}": v for k, v in disc_sd.items()},
                                   "gt_mel_transform.window": torch.ones(1024)}, "epoch": 0}, tmp / "vqgan.ckpt")
        (tmp / "release").mkdir()
        (tmp / "release" / "config.json").write_text(json.dumps(
            {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(vcfg).items()}))
        torch.save({"generator": vocoder.state_dict()}, tmp / "release" / "bigvgan_generator.pt")
        t0 = time.perf_counter()
        convert.main(["vqgan", "--ckpt", str(tmp / "vqgan.ckpt"), "--out", str(tmp / "codec")])  # the card
        convert.main(["bigvgan", "--dir", str(tmp / "release"), "--out", str(tmp / "vocoder")])
        convert_s = time.perf_counter() - t0
        clip = 0.4 * np.sin(2 * math.pi * 220.0 * np.arange(SECONDS * SR) / SR).astype(np.float32)
        wavfile.write(tmp / "in.wav", SR, clip)
        anti_alias_activation.launches = amp_stage.launches = 0
        amp_stage.launches_by_kernel.update(act_conv_tc_kernel=0, act_conv_tf32_kernel=0)
        stream_codec.main(["--in", str(tmp / "in.wav"), "--tokens-out", str(tmp / "tokens.npy"), "--out",
                           str(tmp / "out.wav"), "--codec-ckpt", str(tmp / "codec"), "--vocoder-dir", str(tmp / "vocoder")])
        torch.cuda.synchronize()
        served = {"K1": anti_alias_activation.launches, "K2": amp_stage.launches,
                  "act_conv_tf32_kernel": amp_stage.launches_by_kernel["act_conv_tf32_kernel"]}
        tokens = np.load(tmp / "tokens.npy")
        _, wav = wavfile.read(tmp / "out.wav")
        # the same modules, built here from the same state_dicts, through stream_codec's steps
        codec = DMelCodec(ccfg)
        codec.load_state_dict(gen_sd)
        codec = codec.to(dev).eval()
        audio = audio_mod.load_audio(str(tmp / "in.wav"), target_sr=SR)
        mels = LogMelSpectrogram(sample_rate=SR, hop_length=ccfg.hop_length, n_mels=ccfg.n_mels)(
            torch.from_numpy(audio)[None]).numpy()
        down = ccfg.downsample_total
        want_tokens = streaming.chunked_encode(codec, mels, 1024, streaming.DEFAULT_HALO_FRAMES, device=dev)
        mel = streaming.chunked_decode(codec, want_tokens, chunk_tokens=1024 // down,
                                       halo_tokens=streaming.DEFAULT_HALO_FRAMES // down, seed=0, device=dev)
        want_wav = streaming.chunked_vocode(FusedBigVGAN(vocoder.to(dev).eval()), mel, device=dev)[0]
        wav_err = float(np.abs(wav - want_wav).max())
        say(f"convert vqgan + bigvgan {convert_s:.2f} s; stream_codec on a {SECONDS} s clip: tokens {list(tokens.shape)} "
            f"equal {bool(np.array_equal(tokens, want_tokens))}, audio max |diff| {wav_err:.3e} (tol 2e-5) against the "
            f"modules built from the same state_dicts; launches {served}")
        assert np.array_equal(tokens, want_tokens) and wav.shape == want_wav.shape and wav_err <= 2e-5
        assert served == {"K1": 37, "K2": 72, "act_conv_tf32_kernel": 72}, served
        out["convert"] = {"seconds": convert_s, "launches": served, "audio_max_abs_diff": wav_err}
        del codec, vocoder, gen_sd, disc_sd

        # ---- (c) LM training, data-parallel in a group of one rank, at full width
        log("host path (c): cli.train_lm --distributed (NCCL, world size 1) against the same run without, full width")
        rng = np.random.default_rng(27)
        with open(tmp / "lm.jsonl", "w") as f:
            for i in range(2):
                t_ = np.arange(int(SR * LM_CLIP_SECONDS)) / SR
                x = 0.3 * np.sin(2 * math.pi * (180 + 50 * i) * t_) + 0.05 * rng.standard_normal(len(t_))
                wavfile.write(tmp / f"lm{i}.wav", SR, x.astype(np.float32))
                f.write(json.dumps({"id": f"lm{i}", "audio_path": str(tmp / f"lm{i}.wav"), "duration": LM_CLIP_SECONDS,
                                    "text": f"tone number {i}"}) + "\n")
        counters_fa = {"FA": fa_ops.flash_attention, "FA-dKV": fa_ops.flash_attention_dkv,
                       "FA-dQ": fa_ops.flash_attention_dq}
        # the full-width state and its moments take 11 GB a checkpoint: on the roomier of the two scratch disks
        roomier = max((str(tmp), "/dev/shm"), key=lambda d: shutil.disk_usage(d).free if Path(d).is_dir() else 0)
        ckpt_root = Path(tempfile.mkdtemp(dir=roomier))
        say(f"LM checkpoints under {roomier} ({shutil.disk_usage(roomier).free / 2**30:.1f} GiB free)")
        runs = {}
        try:
            for name in ("distributed", "single"):
                (tmp / f"lm_{name}.yaml").write_text(
                    f"codec_ckpt_dir: {tmp / 'codec'}\ntext_tokenizer_path: null\n"
                    "slow_lm: {flash_attention: true}\n"
                    "train: {accumulate_grad: 2, num_warmup_steps: 0}\n"
                    f"fit: {{max_steps: 4, val_interval: 1000, log_every: 1, ckpt_dir: {ckpt_root / ('lm_ckpt_' + name)}, "
                    f"log_dir: {tmp / ('lm_logs_' + name)}, seed: 1, keep_checkpoints: 1}}\n"
                    f"data: {{train_manifest: {tmp / 'lm.jsonl'}, max_duration: 90.0, audio_backend: native}}\n")
                for fn in counters_fa.values():
                    fn.launches = 0
                step_ms, shapes = [], []
                argv = ["--config", str(tmp / f"lm_{name}.yaml")] + (["--distributed"] if name == "distributed" else [])
                env = torchrun_env() if name == "distributed" else contextlib.nullcontext()
                with env, timed_calls(LMTrainer, "train_step", step_ms,
                                      before=lambda _self, _state, batch: shapes.append(tuple(batch["valid"].shape))):
                    train_lm.main(argv)  # the default device: the card
                torch.cuda.synchronize()
                assert not dist.is_initialized()  # the entry point destroyed the group it made
                losses = [json.loads(line)["train/loss"] for line in open(tmp / f"lm_logs_{name}" / "metrics.jsonl")]
                runs[name] = {"micro_step_ms": float(np.mean(step_ms[1:])), "losses": losses, "shapes": shapes,
                              "launches": {k: fn.launches for k, fn in counters_fa.items()}}
                assert CheckpointManager(str(ckpt_root / f"lm_ckpt_{name}")).all_steps() == [4]
                shutil.rmtree(ckpt_root / f"lm_ckpt_{name}")
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            shutil.rmtree(ckpt_root, ignore_errors=True)
        d_, s_ = runs["distributed"], runs["single"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(d_["losses"], s_["losses"]))
        say(f"train_lm 4 micro-steps of {d_['shapes'][0]} (accumulate 2, 2 updates): --distributed "
            f"{d_['micro_step_ms']:.2f} ms per micro-step, without {s_['micro_step_ms']:.2f}; losses {d_['losses']} "
            f"vs {s_['losses']}: max rel diff {rel:.3e} (tol {LM_DIST_RTOL:g}); launches {d_['launches']} / "
            f"{s_['launches']}")
        assert d_["shapes"] == s_["shapes"] == [(2, TRAIN_SEQ)] * 4, (d_["shapes"], s_["shapes"])
        assert len(d_["losses"]) == len(s_["losses"]) == 4 and rel <= LM_DIST_RTOL
        assert d_["launches"] == s_["launches"] == {k: 24 * 4 for k in counters_fa}, (d_["launches"], s_["launches"])
        out["train_lm"] = {k: {kk: v[kk] for kk in ("micro_step_ms", "losses", "launches")} for k, v in runs.items()}
        out["train_lm"]["max_rel_loss_diff"] = rel

        # ---- (d) codec training, data-parallel in a group of one rank, on (a)'s manifest
        log("host path (d): cli.train_codec --distributed (NCCL, world size 1) on (a)'s manifest, native decode")
        (tmp / "codec_dist.yaml").write_text(
            "train: {learning_rate: 1.0e-4, num_warmup_steps: 1}\n"
            f"fit: {{max_steps: 2, val_interval: 1000, log_every: 1, ckpt_dir: {tmp / 'codec_ckpt'}, "
            f"log_dir: {tmp / 'codec_logs'}, seed: 1, keep_checkpoints: 1}}\n"
            f"data: {{train_manifest: {manifest}, max_duration: 16.0, audio_backend: native}}\n")
        step_ms, waits, marks = [], [], {}
        real_epoch = DataLoader.epoch

        def timed_epoch(self, epoch=0):
            it = real_epoch(self, epoch)
            try:
                while True:
                    t0 = time.perf_counter()
                    marks.setdefault("first", t0)
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    waits.append(time.perf_counter() - t0)
                    yield batch
            finally:
                it.close()

        DataLoader.epoch = timed_epoch
        try:
            with torchrun_env(), timed_calls(CodecTrainer, "train_step", step_ms,
                                             before=lambda *_: marks.__setitem__("last", time.perf_counter())):
                train_codec.main(["--config", str(tmp / "codec_dist.yaml"), "--distributed"])
        finally:
            DataLoader.epoch = real_epoch
        torch.cuda.synchronize()
        assert not dist.is_initialized()
        loop_s = marks["last"] - marks["first"] + step_ms[-1] / 1e3
        share = sum(waits) / loop_s
        records = [json.loads(line) for line in open(tmp / "codec_logs" / "metrics.jsonl")]
        say(f"train_codec 2 steps: {step_ms[0]:.2f} / {step_ms[1]:.2f} ms; the loader's share of the loop's wall "
            f"time {share:.3f} ({sum(waits) * 1e3:.1f} of {loop_s * 1e3:.1f} ms waiting for {len(waits)} batches); "
            f"generator loss {[round(r['train/generator/loss'], 5) for r in records]}")
        assert [r["step"] for r in records] == [1, 2]
        assert all(math.isfinite(v) for r in records for v in r.values())
        out["train_codec"] = {"step_ms": step_ms, "loader_wall_share": share, "loop_s": loop_s}
    out["seconds"] = time.perf_counter() - t_phase
    say(f"phase 25 in {out['seconds']:.1f} s")
    return out


# Phase 26, the rest of the parallel layer at world size 1 (one card; NCCL).
# Tolerances:
#  the laid-out trainer (tensor parallel over a model group of one, with and
#    without FSDP over a data group of one) against phase 17's plain trainer,
#    the same seed and batches: the losses within 1e-6 relative. They cannot
#    be bit-equal: the vocab-parallel cross entropy sums -log softmax as
#    log(sum exp(x - max)) + max - x[label] where F.cross_entropy takes
#    log_softmax, and the layout's global norm adds the squares by kind
#    before the root, each ~1e-7 relative in float32; the kernels, the
#    GEMMs and the collectives over one rank change no bit.
#  the GPipe decoder (one stage, 2 microbatches of 1) against the plain
#    decoder on the batch of 2: the same kernels, but float32 GEMMs of half
#    the rows may take another cuBLAS kernel and sum in another order
#    (~1e-7 relative per op, over 24 blocks): the hidden state within 1e-4
#    of max(1, max |plain|), each gradient within TOL_TRAIN_GRAD of its
#    tensor's largest (phase 17's reason).
#  time-sharded encode / decode at world size 1 against the one-process
#    encode / decode: the same modules on the same window: tokens equal,
#    the mel within 1e-5 (TOL_CHUNKED_DECODE).
TOL_PARALLEL_LOSS, TOL_PIPELINE_OUT = 1e-6, 1e-4
PARALLEL_STEPS, SHARDED_SECONDS = 6, 60


def parallel_phase(dev, card: str, flash_cfg, train_cfg, batches, plain_losses, plain_stats, counters_fa) -> dict:
    """(a) `LMTrainer.shard_state` on `dp_tp_mesh(model=1, data=1)` with and
    without `fsdp`, TRAIN_MICRO_STEPS checked micro-steps against phase 17's
    plain trainer, then timed; (b) FA, FA-dKV, FA-dQ at one rank's head
    layout under 2-way tensor parallelism against their plain versions;
    (c) `pipelined_decoder` (1 stage, M = 2) over the slow decoder, flash
    on, against the plain decoder; (d) `time_sharded_encode` / `decode` on
    a 60 s clip at the flagship codec width against the one-process ones.
    NCCL across ranks is not exercised (one card)."""
    import torch.distributed as dist

    from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
    from dmel_codec_tpu_torch.models.transformer import Decoder
    from dmel_codec_tpu_torch.ops import flash_attention as fa_ops
    from dmel_codec_tpu_torch.parallel import (
        dp_tp_mesh, pipelined_decoder, stage_mesh, time_sharded_decode, time_sharded_encode,
    )
    from dmel_codec_tpu_torch.train.lm_trainer import LMTrainer

    def say(msg: str) -> None:
        log(f"  [{card}] {msg}")

    def reset_counts() -> None:
        for fn in counters_fa.values():
            fn.launches = 0

    def counts() -> dict:
        return {n_: fn.launches for n_, fn in counters_fa.items()}

    out = {"card": card}
    t_phase = time.perf_counter()
    n_layers = flash_cfg.slow.num_layers
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
                            device_id=dev)
    try:
        # ---- (a) the laid-out LM train step
        log(f"parallel (a): LMTrainer.shard_state on dp_tp_mesh(model=1, data=1) (NCCL, world 1), full width, "
            f"float32, {LM_BATCH} x {TRAIN_SEQ}, accumulate_grad = {TRAIN_ACCUMULATE}")
        for fsdp in (False, True):
            what = "tensor parallel + FSDP" if fsdp else "tensor parallel"
            gc.collect()
            torch.cuda.empty_cache()
            trainer = LMTrainer(flash_cfg, train_cfg, device=dev)
            state = trainer.shard_state(trainer.init_state(0), dp_tp_mesh(model=1, data=1), fsdp=fsdp)
            cut = sum(a_ is not None for spec in trainer.layout.specs.values() for a_ in spec)
            reset_counts()
            losses = []
            for i in range(TRAIN_MICRO_STEPS):
                state, metrics = trainer.train_step(state, batches[i % 2])
                torch.cuda.synchronize()
                want_n = (i + 1) * n_layers
                assert counts() == {"FA": want_n, "FA-dKV": want_n, "FA-dQ": want_n}, (what, i, counts())
                vals = {k_: float(v_) for k_, v_ in metrics.items()}
                assert all(math.isfinite(x) for x in vals.values()), vals
                losses.append({k_: vals[k_] for k_ in plain_losses[i]})
                rel = max(abs(losses[i][k_] - w_) / max(abs(w_), 1e-30) for k_, w_ in plain_losses[i].items())
                say(f"{what}, micro-step {i + 1}: loss {vals['train/loss']:.6f} (phase 17 "
                    f"{plain_losses[i]['train/loss']:.6f}), grad norm {vals['train/grad_norm']:.6f}; largest "
                    f"relative difference of the three losses {rel:.3e} (tol {TOL_PARALLEL_LOSS:.0e})")
                assert rel <= TOL_PARALLEL_LOSS, (what, i, losses[i], plain_losses[i])
            launches = counts()
            say(f"{what}: {cut} dimensions cut over an axis, launches over {TRAIN_MICRO_STEPS} micro-steps {launches} "
                f"({n_layers} each per micro-step)")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            events = []
            for i in range(PARALLEL_STEPS):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                trainer.train_step(state, batches[i % 2])
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            times = [s_.elapsed_time(e_) for s_, e_ in events[2:]]
            step_ms, peak = sum(times) / len(times), torch.cuda.max_memory_allocated() / 2**30
            say(f"{what}: {step_ms:.2f} ms per micro-step (last 4: {', '.join(f'{t_:.2f}' for t_ in times)}), peak "
                f"{peak:.2f} GiB; phase 17's plain trainer {plain_stats[0]:.2f} ms, {plain_stats[1]:.2f} GiB")
            out["fsdp" if fsdp else "tp"] = {"losses": losses, "launches": launches, "ms": step_ms, "peak_gib": peak,
                                             "plain_ms": plain_stats[0], "plain_peak_gib": plain_stats[1]}
            del trainer, state

        # ---- (b) FA, FA-dKV, FA-dQ at one rank's heads under 2-way tensor parallelism
        slow = flash_cfg.slow
        heads, kv_heads, hd = slow.num_heads // 2, slow.num_kv_heads // 2, slow.head_dim
        log(f"parallel (b): FA / FA-dKV / FA-dQ at a TP = 2 rank's layout [{LM_BATCH}, {TRAIN_SEQ}, "
            f"{heads} -> {kv_heads}, {hd}] vs plain")
        gen = torch.Generator(device=dev).manual_seed(26)
        out["tp2_layout"] = {}
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, g = (torch.randn((LM_BATCH, TRAIN_SEQ, n_, hd), device=dev, generator=gen).to(dt)
                          for n_ in (heads, kv_heads, kv_heads, heads))
            reset_counts()
            ins = [t_.clone().requires_grad_() for t_ in (q, k, v)]
            got_out = fa_ops.flash_attention(*ins)
            got = torch.autograd.grad(got_out, ins, g)
            torch.cuda.synchronize()
            assert counts() == {"FA": 1, "FA-dKV": 1, "FA-dQ": 1}, counts()
            out_p, lse_p = fa_ops.flash_attention_forward_reference(q, k, v)
            dk_p, dv_p = fa_ops.flash_attention_dkv_reference(q, k, v, out_p, lse_p, g)
            dq_p = fa_ops.flash_attention_dq_reference(q, k, v, out_p, lse_p, g)
            tag = f"[{LM_BATCH}, {TRAIN_SEQ}, {heads} -> {kv_heads}, {hd}] {dt}"
            out["tp2_layout"][str(dt)] = {
                "FA": check_close(f"FA {tag}", got_out.detach(), out_p, fa_rel(dt, v, out_p)),
                "FA-dQ": check_close(f"FA-dQ {tag}", got[0], dq_p, TOL[("FA-bwd", dt)]),
                "FA-dKV": max(check_close(f"FA-dKV dk {tag}", got[1], dk_p, TOL[("FA-bwd", dt)]),
                              check_close(f"FA-dKV dv {tag}", got[2], dv_p, TOL[("FA-bwd", dt)])),
            }
            del q, k, v, g, ins, got_out, got, out_p, lse_p, dk_p, dv_p, dq_p

        # ---- (c) the GPipe decoder, one stage
        log(f"parallel (c): pipelined_decoder over the slow decoder (1 stage, M = 2), flash on, float32, "
            f"{LM_BATCH} x {TRAIN_SEQ}")
        gc.collect()
        torch.cuda.empty_cache()
        with torch.random.fork_rng(devices=[dev]):
            torch.manual_seed(26)
            decoder = Decoder(slow).to(dev)
        x = torch.randn((LM_BATCH, TRAIN_SEQ, slow.hidden_size), device=dev, generator=gen)
        w = torch.randn(x.shape, device=dev, generator=gen)
        fn = pipelined_decoder(decoder, stage_mesh(1), 2)
        xp = x.clone().requires_grad_()
        reset_counts()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        got = fn(xp)
        (got * w).sum().backward()
        t1.record()
        torch.cuda.synchronize()
        pipe_launches = counts()
        assert pipe_launches == {"FA": 2 * slow.num_layers, "FA-dKV": 2 * slow.num_layers,
                                 "FA-dQ": 2 * slow.num_layers}, pipe_launches
        got_grads = {n_: p_.grad.clone() for n_, p_ in decoder.named_parameters()}
        decoder.zero_grad(set_to_none=True)
        xr = x.clone().requires_grad_()
        want, _ = decoder(xr)
        (want * w).sum().backward()
        torch.cuda.synchronize()
        e_out = check_close("pipelined decoder hidden vs the plain decoder", got.detach(), want.detach(),
                            TOL_PIPELINE_OUT)
        worst = max(((n_, max_err(got_grads[n_], p_.grad) / max(p_.grad.abs().max().item(), 1e-30))
                     for n_, p_ in decoder.named_parameters()), key=lambda t_: t_[1])
        e_x = max_err(xp.grad, xr.grad) / max(xr.grad.abs().max().item(), 1e-30)
        say(f"pipelined decoder: {pipe_launches} launches (2 microbatches x {slow.num_layers} blocks), "
            f"{t0.elapsed_time(t1):.2f} ms forward + backward; gradients vs plain: worst {worst[1]:.3e} of the "
            f"tensor's largest at {worst[0]}, input {e_x:.3e} (tol {TOL_TRAIN_GRAD:.0e})")
        assert worst[1] <= TOL_TRAIN_GRAD and e_x <= TOL_TRAIN_GRAD, (worst, e_x)
        out["pipeline"] = {"launches": pipe_launches, "max_abs_err": e_out, "grad_rel_err": worst[1],
                           "input_grad_rel_err": e_x, "ms": t0.elapsed_time(t1)}
        del decoder, x, w, xp, xr, got, want, got_grads

        # ---- (d) time-sharded encode / decode, world 1
        log(f"parallel (d): time_sharded_encode / decode on a {SHARDED_SECONDS} s clip at the flagship codec width, "
            f"float32")
        gc.collect()
        torch.cuda.empty_cache()
        ccfg = DMelCodecConfig()
        with torch.random.fork_rng(devices=[dev]):
            torch.manual_seed(27)
            codec = DMelCodec(ccfg).to(dev).eval()
        t_frames = (SHARDED_SECONDS * SR // HOP // 4) * 4
        mels = torch.randn((2, t_frames, ccfg.n_mels), device=dev, generator=gen)
        lengths = torch.tensor([t_frames, t_frames * 3 // 4], device=dev)
        times_ = {}

        def timed(name, fn_):
            """fn_'s result; its ms, the mean of 3 calls after one untimed (cuDNN picks its algorithms there)."""
            r_ = fn_()
            times_[name] = cuda_ms(fn_, 3, warm=False)
            return r_

        with torch.no_grad():
            want_idx, want_len = timed("encode", lambda: codec.encode(mels, lengths))
            got_idx, got_len = timed("sharded encode", lambda: time_sharded_encode(codec)(mels, lengths))
            assert torch.equal(got_idx, want_idx) and torch.equal(got_len, want_len)
            noise = torch.randn((2, t_frames, ccfg.concat_dim), device=dev, generator=gen)
            want_mel = timed("decode", lambda: codec.decode(want_idx, want_len, noise))
            got_mel = timed("sharded decode", lambda: time_sharded_decode(codec)(want_idx, want_len, noise))
        e_mel = check_close(f"time-sharded decode vs one-process, {list(want_mel.shape)}", got_mel, want_mel,
                            TOL_CHUNKED_DECODE)
        say(f"time-sharded at world 1: tokens {list(got_idx.shape)} equal; " + ", ".join(
            f"{k_} {v_:.2f} ms" for k_, v_ in times_.items()))
        out["sequence"] = {"tokens_equal": True, "mel_max_abs_err": e_mel, "ms": times_}
        del codec, mels, noise, want_idx, got_idx, want_mel, got_mel
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    say(f"phase 26 in {out['seconds']:.1f} s")
    return out


# Phase 27, the public modules beside the main path: fish-speech's
# firefly-gan-base vocoder (`FireflyGAN`), the WaveNet's diffusion-step
# pathway at the codec decoder's width and depth, and the unfused `Snake`,
# `UpSample1d` and `DownSample1d` at s1's shape. Each runs on the card and,
# on the same seeded weights and inputs, on the CPU (float32, TF32 off).
# Tolerances, relative to max |CPU| (random weights keep the outputs small:
# FireflyGAN's waveform peaks near 4e-3, the WaveNet's near 5e-2):
#  FireflyGAN: ~100 float32 convs (ConvNeXt, then 5 HiFiGAN stages) in
#    cuDNN's summation order against the CPU's, ~1e-7 relative per op: 1e-4,
#    phase 24's tolerance for the same backbone and head;
#  WaveNet: 20 gated layers of 700-channel float32 convs: 1e-4;
#  Snake: sinf against the CPU's sin, one op: 1e-5;
#  UpSample1d / DownSample1d: one 12-tap depthwise conv: 1e-5.
FIREFLY_FRAMES, FIREFLY_BATCH, FIREFLY_CHECK_FRAMES, FIREFLY_SR = 861, 2, 173, 44100
TOL_FIREFLY, TOL_WAVENET, TOL_SNAKE, TOL_RESAMPLE = 1e-4, 1e-4, 1e-5, 1e-5
S1_SHAPE = (16, 384, 5952)


def public_modules_phase(dev, card: str) -> dict:
    """(a) FireflyGAN at the firefly-gan-base defaults: 2 x 861 frames of
    128-band mel timed (seconds of audio per second), 1 x 173 frames on the
    card against the CPU; (b) WaveNet(is_diffusion=True) at the codec
    decoder's width and depth with a condition and a step t in [0, 1000),
    B = 1 on the card against the CPU, then B = 16 timed; (c) Snake,
    UpSample1d and DownSample1d at s1's shape on the card against the CPU,
    timed."""
    from dmel_codec_tpu_torch.models import DMelCodecConfig, FireflyGAN
    from dmel_codec_tpu_torch.nn import DownSample1d, Snake, UpSample1d, WaveNet

    def say(msg: str) -> None:
        log(f"  [{card}] {msg}")

    def card_vs_cpu(what: str, module: torch.nn.Module, args: tuple, rel: float) -> tuple:
        """(the card's output, max abs error against the CPU); fails beyond rel * max |CPU|."""
        with torch.no_grad():
            want = module(*args)
            got = copy.deepcopy(module).to(dev)(*(a.to(dev) for a in args))
        assert got.shape == want.shape and torch.isfinite(got).all(), (what, got.shape, want.shape)
        err = max_err(got.cpu(), want)
        scale = want.abs().max().item()
        say(f"{what}: card vs CPU max abs err {err:.3e} (tol {rel * scale:.3e}, max|CPU| {scale:.3g})")
        if not err <= rel * scale:
            raise AssertionError(f"{what}: the card disagrees with the CPU")
        return got, err

    out = {"card": card}
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(27)

    # ---- (a) FireflyGAN
    torch.manual_seed(27)
    firefly = FireflyGAN().eval()
    with torch.no_grad():
        for name, p in firefly.named_parameters():
            if name.endswith("gamma"):  # layer scales spread around 1: their init, 1e-6, would hide the blocks
                p.copy_(1 + 0.05 * torch.randn(p.shape, generator=gen))
    mel = torch.randn(1, FIREFLY_CHECK_FRAMES, 128, generator=gen)
    wave, err = card_vs_cpu(f"FireflyGAN 1 x {FIREFLY_CHECK_FRAMES} frames", firefly, (mel,), TOL_FIREFLY)
    assert wave.shape == (1, FIREFLY_CHECK_FRAMES * 512) and wave.abs().max().item() > 1e-3
    on_card = copy.deepcopy(firefly).to(dev)
    big = torch.randn(FIREFLY_BATCH, FIREFLY_FRAMES, 128, generator=gen).to(dev)
    with torch.no_grad():
        ms = cuda_ms(lambda: on_card(big), reps=5)
    audio_s = FIREFLY_BATCH * FIREFLY_FRAMES * 512 / FIREFLY_SR
    out["firefly_gan"] = {"check_frames": FIREFLY_CHECK_FRAMES, "max_abs_err": err, "tol": TOL_FIREFLY,
                          "batch": FIREFLY_BATCH, "frames": FIREFLY_FRAMES, "ms": ms, "audio_s": audio_s,
                          "audio_s_per_s": audio_s / (ms / 1e3),
                          "params": sum(p.numel() for p in firefly.parameters())}
    say(f"FireflyGAN {FIREFLY_BATCH} x {FIREFLY_FRAMES} frames ({audio_s:.2f} s of 44.1 kHz audio): {ms:.3f} ms, "
        f"{audio_s / (ms / 1e3):.1f} s of audio per s")
    del firefly, on_card, big

    # ---- (b) WaveNet(is_diffusion=True) at the codec decoder's width and depth
    ccfg = DMelCodecConfig()
    c, frames = ccfg.concat_dim, (SECONDS * SR // HOP // 4) * 4
    wavenet = WaveNet(input_channels=c, output_channels=ccfg.n_mels, residual_channels=c,
                      residual_layers=ccfg.decoder_layers, condition_channels=c, is_diffusion=True).eval()
    x, cond = torch.randn(1, c, frames, generator=gen), torch.randn(1, c, frames, generator=gen)
    t = torch.from_numpy(np.random.default_rng(27).uniform(0, 1000, size=1).astype(np.float32))
    y, err = card_vs_cpu(f"WaveNet(is_diffusion) {c} x {ccfg.decoder_layers} layers, 1 x {frames} frames, "
                         f"t = {t.item():.3f}", wavenet, (x, cond, t), TOL_WAVENET)
    assert y.shape == (1, ccfg.n_mels, frames)
    on_card = copy.deepcopy(wavenet).to(dev)
    xb, cb = (torch.randn(BATCH, c, frames, generator=gen).to(dev) for _ in range(2))
    tb = torch.from_numpy(np.random.default_rng(28).uniform(0, 1000, size=BATCH).astype(np.float32)).to(dev)
    with torch.no_grad():
        ms = cuda_ms(lambda: on_card(xb, cb, tb), reps=5)
        moved = max_err(on_card(xb, cb, tb), on_card(xb, cb))
    assert moved > 0.0, "the step t does not reach the output"
    out["wavenet_diffusion"] = {"channels": c, "layers": ccfg.decoder_layers, "frames": frames, "max_abs_err": err,
                                "tol": TOL_WAVENET, "batch": BATCH, "ms": ms, "step_moves_output_by": moved}
    say(f"WaveNet(is_diffusion) {BATCH} x {frames} frames: {ms:.3f} ms; the step moves the output by {moved:.3e}")
    del wavenet, on_card, xb, cb

    # ---- (c) Snake, UpSample1d and DownSample1d at s1's shape
    x = torch.randn(*S1_SHAPE, generator=gen)
    snake = Snake(S1_SHAPE[1], alpha_logscale=True)
    with torch.no_grad():
        snake.alpha.copy_(0.3 * torch.randn(S1_SHAPE[1], generator=gen))
    xd = x.to(dev)
    for name, module, tol in (("snake", snake, TOL_SNAKE), ("upsample", UpSample1d(2), TOL_RESAMPLE),
                              ("downsample", DownSample1d(2), TOL_RESAMPLE)):
        y, err = card_vs_cpu(f"{type(module).__name__} {list(S1_SHAPE)}", module, (x,), tol)
        on_card = copy.deepcopy(module).to(dev)
        with torch.no_grad():
            ms = cuda_ms(lambda: on_card(xd))
        out[name] = {"shape": list(S1_SHAPE), "out_shape": list(y.shape), "max_abs_err": err, "tol": tol, "ms": ms}
        say(f"{type(module).__name__} {list(S1_SHAPE)} -> {list(y.shape)}: {ms:.4f} ms")
    del x, xd
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    say(f"phase 27 in {out['seconds']:.1f} s")
    return out

# Phase 9's generation: LM_FRAMES frames at each batch size it times; GEN_CHECK_FRAMES where the captured
# graph is held to the eager step (the eager loop is the slow side of that check)
GEN_BATCHES, GEN_CHECK_FRAMES = (1, SERVE_BATCH, 64), 32


def infer_prompts(cfg, b: int):
    """b text prompts ("who are you? 0", ...) left-padded with modality-pad rows -> ([b, S], [b, S, C])."""
    from dmel_codec_tpu_torch.lm.inputs import TokenGridBuilder
    from dmel_codec_tpu_torch.lm.tokenizer import ByteTokenizer

    gridder = TokenGridBuilder(config=cfg)
    grids = [gridder.build_infer_grid(text_ids=ByteTokenizer().encode(f"who are you? {i}")) for i in range(b)]
    s = max(len(t) for t, _ in grids)
    text = np.full((b, s), cfg.text_pad_id, np.int64)
    audio = np.full((b, s, cfg.audio_codebook_count), cfg.slow_audio_pad_id, np.int64)
    for i, (t, a) in enumerate(grids):
        text[i, s - len(t):], audio[i, s - len(t):] = t, a
    return text, audio


@torch.no_grad()
def generation_phase(dev, lm, grid) -> dict:
    """Phase 9 after the entry point. (a) The frame step reads nothing on the host: one eager frame with
    each fast decode under torch.cuda.set_sync_debug_mode("error"). (b) The captured graph against the
    eager step on the card: the same tokens, greedy float32 and seeded bf16, B = 1 and 16. (c) frames/s
    over LM_FRAMES frames at B = 1, 16 and 64 (bf16 weights and cache, the default sampler), the steady
    frame's ms (replays back to back) beside one eager frame step's, the device's idle share and top
    kernels over two replays, the capture's seconds and the host's reads per generation. (d) Greedy
    agreement of the three generation forms."""
    from dmel_codec_tpu_torch.lm import generate as gen_mod
    from dmel_codec_tpu_torch.lm.generate import InferenceConfig, SlowFastGenerator

    lm_cfg, k = lm.config, gen_mod.FRAMES_PER_GRAPH
    out = {"frames_per_replay": k}
    log(f"  generation: {k} frames a replay of the captured frame step")

    # (a) no host sync in a frame step
    for b, fast_kv_cache in ((SERVE_BATCH, False), (1, True)):
        gen = SlowFastGenerator(lm, InferenceConfig(cache_dtype="bfloat16", fast_kv_cache=fast_kv_cache))
        loop, g = gen._new_loop(b), torch.Generator(device=dev).manual_seed(0)
        text_b, audio_b = (torch.as_tensor(np.stack([x] * b), device=dev) for x in grid)
        gen._prefill(loop, text_b, audio_b, g, gen._fast_decode_growing)
        gen._step(loop, g, gen._fast_decode)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            gen._step(loop, g, gen._fast_decode)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        log(f"  one eager frame step at B = {b} ({'KV-cached' if fast_kv_cache else 'fixed'} fast decode) under "
            f"set_sync_debug_mode('error'): no synchronizing call")
        del gen, loop

    # (b) the graph against the eager step
    lm32 = copy.deepcopy(lm).float()
    many = infer_prompts(lm_cfg, SERVE_BATCH)
    out["graph_vs_eager"] = {}
    for label, model, kw, seed in (("greedy float32", lm32, dict(top_k=1), None),
                                   ("seeded bf16", lm, dict(cache_dtype="bfloat16"), 5)):
        gen = SlowFastGenerator(model, InferenceConfig(max_new_tokens=GEN_CHECK_FRAMES, **kw))

        def rng():
            return None if seed is None else torch.Generator(device=dev).manual_seed(seed)

        for b in (1, SERVE_BATCH):
            if b == 1:
                graph = [gen.generate(*grid, rng())]
                eager = [gen._generate_one(*grid, rng(), gen._fast_decode_growing, gen._fast_decode, graphed=False)]
            else:
                graph = list(zip(*gen.generate_batched(*many, rng())))
                texts, audios, lengths = gen._generate(*many, rng(), gen._fast_decode_fixed, gen._fast_decode_fixed,
                                                       graphed=False)
                eager = [(audios[i, : lengths[i]], texts[i, : lengths[i]]) for i in range(b)]
            same = all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) for x, y in zip(graph, eager))
            frames = [len(t) for _, t in graph]
            log(f"  {label}, B = {b}, {GEN_CHECK_FRAMES} frames: captured graph vs eager step, same tokens: {same} "
                f"(frames per row {sorted(set(frames))})")
            assert same, (label, b)
            out["graph_vs_eager"][f"{label} B={b}"] = {"same_tokens": same, "frames": frames}
        del gen
    del lm32
    torch.cuda.empty_cache()

    # (c) frames/s, the steady frame, the device's idle share
    icfg = InferenceConfig(max_new_tokens=LM_FRAMES, cache_dtype="bfloat16")
    for b in GEN_BATCHES:
        gen = SlowFastGenerator(lm, icfg)
        first_only = SlowFastGenerator(lm, dataclasses.replace(icfg, max_new_tokens=1))
        text_b, audio_b = np.stack([grid[0]] * b), np.stack([grid[1]] * b)
        g = torch.Generator(device=dev).manual_seed(3)

        def run(gen_):
            return gen_.generate(*grid, g) if b == 1 else gen_.generate_batched(text_b, audio_b, g)

        first_ms = cuda_ms(lambda: run(gen), 1, warm=False)
        capture_s = gen.stats["capture_s"]
        prefill_ms = cuda_ms(lambda: run(first_only), 3)
        got = []
        total_ms = cuda_ms(lambda: got.append(run(gen)), 2, warm=False)
        n = got[-1][0].shape[0] if b == 1 else max(len(a) for a in got[-1][0])
        assert 2 <= n <= LM_FRAMES and gen.stats["graphed"], (n, gen.stats)
        fps = (n - 1) / ((total_ms - prefill_ms) / 1e3)
        (entry,) = gen._graphs.values()
        frame_ms = cuda_ms(entry.graph.replay, 8) / k
        eager_ms = cuda_ms(lambda: gen._step(entry.loop, g, gen._fast_decode), 3)
        totals, kernels = {}, {}
        profile_once(f"two replays ({2 * k} frames) at B = {b}", lambda: [entry.graph.replay() for _ in range(2)],
                     kernels=kernels, totals=totals)
        top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
        log(f"  B = {b}: first call {first_ms:.2f} ms with the capture ({capture_s:.2f} s); prefill + first frame "
            f"({len(grid[0])} positions) {prefill_ms:.2f} ms; {n} frames in {total_ms:.2f} ms: {fps:.2f} frames/s "
            f"per row, {b * fps:.2f} aggregate; steady frame {frame_ms:.3f} ms (replays back to back), one eager "
            f"frame step {eager_ms:.2f} ms; host reads per generation {gen.stats['host_reads']}")
        out[f"B={b}"] = {"frames": n, "frames_per_s": fps, "generation_ms": total_ms, "prefill_ms": prefill_ms,
                         "frame_ms": frame_ms, "eager_frame_ms": eager_ms, "first_call_ms": first_ms,
                         "capture_s": capture_s, "host_reads": gen.stats["host_reads"],
                         "device_idle": totals.get("idle"), "top_kernels_ms": top}
        del gen, first_only, entry
        torch.cuda.empty_cache()

    # (d) greedy: the three generation forms give the same tokens (float32, so
    # that batch shape cannot move an argmax among near-uniform logits)
    lm32 = copy.deepcopy(lm).float()
    greedy = SlowFastGenerator(lm32, InferenceConfig(max_new_tokens=16, top_k=1))
    a1, t1 = greedy.generate(*grid, None)
    a2, t2 = greedy.generate_stepwise(*grid, None)
    a3, t3 = greedy.generate_batched(np.stack([grid[0]] * 2), np.stack([grid[1]] * 2), None)
    same = all(np.array_equal(a1, a) and np.array_equal(t1, t) for a, t in ((a2, t2), (a3[0], t3[0]), (a3[1], t3[1])))
    log(f"  greedy generate / generate_stepwise / generate_batched: {len(t1)} frames, same tokens: {same}")
    assert same and len(t1) == 16
    out["three_forms_same"] = same
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from dmel_codec_tpu_torch.cli import infer_lm, stream_codec, train_codec, train_lm
    from dmel_codec_tpu_torch.dsp.spectrogram import LogMelSpectrogram
    from dmel_codec_tpu_torch.lm.generate import InferenceConfig, SlowFastGenerator
    from dmel_codec_tpu_torch.lm.inputs import TokenGridBuilder, pad_grids_to_batch
    from dmel_codec_tpu_torch.lm.tokenizer import ByteTokenizer
    from dmel_codec_tpu_torch.models.lm import ChatMusicLM, SlowFastLMConfig
    from dmel_codec_tpu_torch.ops import flash_attention as fa_ops
    from dmel_codec_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference
    from dmel_codec_tpu_torch.models.bigvgan import AMPBlock1, BigVGAN, BigVGANConfig, FusedBigVGAN
    from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
    from dmel_codec_tpu_torch.models import streaming
    from dmel_codec_tpu_torch.ops import anti_alias, library
    from dmel_codec_tpu_torch.ops.anti_alias import anti_alias_activation, anti_alias_activation_reference
    from dmel_codec_tpu_torch.ops.stage_fused import (
        V1_MAX_CHANNELS, StageSpec, act_conv, act_conv_reference, amp_stage, amp_stage_v1, conv_site, pack_stage,
        stage_reference, stage_reference_v1, v1_launch_config,
    )
    from dmel_codec_tpu_torch.probes import act_variants, cf_act, k1_floor, stage_parts, sublane_ops
    from dmel_codec_tpu_torch.train.codec_trainer import CodecTrainConfig, CodecTrainer
    from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
    from dmel_codec_tpu_torch.train.lm_trainer import LMTrainConfig, LMTrainer
    from dmel_codec_tpu_torch.train.lora import LoRAConfig
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
    # what one streaming window (B = 1) gives the same kernels
    win_shapes = {i: (c, t) for i, c, t in stage_shapes(vcfg, VOCODE_CHUNK + 2 * VOCODE_HALO)}
    errs = {"K1": 0.0, "K2": 0.0}

    # ---- 3. K1 vs plain: the vocoder's shapes, then ragged ones (snake and
    # snakebeta, logscale on and off, T not a multiple of the tile, T = 1)
    log("K1 anti-aliased snake vs plain:")
    last = len(shapes) - 1
    k1_shapes = {"act_post": (BATCH, *shapes[last]), "s0": (BATCH, *shapes[0]), "s1": (BATCH, *shapes[1])}
    k1_win_shapes = {"act_post": (1, *win_shapes[last]), "s0": (1, *win_shapes[0]), "s1": (1, *win_shapes[1])}
    k1_cases = [(name, shape, True, True, (torch.float32, torch.bfloat16))
                for name, shape in k1_shapes.items()]
    k1_cases += [(f"window {name}", shape, True, True, (torch.float32, torch.bfloat16))
                 for name, shape in k1_win_shapes.items()]
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
    # bf16 parameters (the bf16 vocoder's): the kernel rounds their exps and
    # 1 / (beta + eps) to bf16 itself, as the plain version computes them in
    # bf16; on float32 x a coefficient one bf16 ulp off would move the output
    # by ~2^-8 of the snake term, far beyond K1's float32 tolerance
    for logscale, with_beta in ((True, True), (True, False), (False, True)):
        c = k1_shapes["s0"][1]
        alpha = (0.3 * torch.randn(c, device=dev, generator=gen) + (0.0 if logscale else 1.0)).bfloat16()
        beta = (0.3 * torch.randn(c, device=dev, generator=gen) + (0.0 if logscale else 1.0)).bfloat16()
        beta = beta if with_beta else None
        x32 = torch.randn((2, c, 700), device=dev, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            got = anti_alias_activation(x32.to(dt), alpha, beta, logscale)
            torch.cuda.synchronize()
            want = anti_alias_activation_reference(x32.to(dt), alpha, beta, logscale)
            e = check_close(f"bf16 parameters, {'snakebeta' if with_beta else 'snake'}, logscale {logscale}, "
                            f"x [2, {c}, 700] {dt}", got, want, TOL[("K1", dt)])
            if dt == torch.float32:
                errs["K1"] = max(errs["K1"], e)
            del got, want

    # ragged lengths, every T up to 64 (a row shorter than a lane's run, a
    # unit, the halo), and x at an offset that is no 16-byte boundary (the
    # kernel's head and tail path, element by element)
    for t_len in range(1, 65):
        alpha = 0.3 * torch.randn(3, device=dev, generator=gen)
        x32 = torch.randn((2, 3, t_len), device=dev, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            got = anti_alias_activation(x32.to(dt), alpha, alpha, True)
            want = anti_alias_activation_reference(x32.to(dt), alpha, alpha, True)
            scale = max(1.0, want.float().abs().max().item())
            assert max_err(got, want) <= TOL[("K1", dt)] * scale, (t_len, dt, max_err(got, want))
    log("  T = 1..64 [2, 3, T], float32 and bf16: within tolerance")
    flat = torch.randn(3 * 7 * 1000 + 8, device=dev, generator=gen)
    for off in (1, 3):
        alpha = 0.3 * torch.randn(7, device=dev, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            x = flat.to(dt)[off: off + 3 * 7 * 1000].view(3, 7, 1000)
            e = check_close(f"x at element offset {off} [3, 7, 1000] {dt}", anti_alias_activation(x, alpha, None, True),
                            anti_alias_activation_reference(x, alpha, None, True), TOL[("K1", dt)])
            if dt == torch.float32:
                errs["K1"] = max(errs["K1"], e)
    k1_sin_bad = anti_alias.sin_replica_mismatches()
    log(f"  K1's sinf without conversions against sinf, every float below 105615: {k1_sin_bad} differ beyond the sign")
    assert k1_sin_bad == 0, k1_sin_bad
    k1_launch = anti_alias.launch_config(torch.empty(k1_shapes["s1"], device=dev, dtype=torch.bfloat16).normal_(),
                                         torch.zeros(k1_shapes["s1"][1], device=dev))
    log(f"  launch at s1 {list(k1_shapes['s1'])} bf16: grid {k1_launch['grid']} blocks of {k1_launch['threads']} threads, "
        f"{k1_launch['smem_bytes']} bytes of shared memory, {k1_launch['units_per_row']} units of "
        f"{32 * anti_alias.RUN} per row in tasks of {k1_launch['units_per_task']}, 16-byte vectors "
        f"{bool(k1_launch['vec'])}")

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
    k2_cases += [(f"window s{i}", stage_packs[i], (1, *win_shapes[i]), (torch.float32, torch.bfloat16))
                 for i in stage_packs]
    ragged_pack = random_pack(40)
    k2_cases += [("ragged", ragged_pack, (1, 40, 1000), (torch.float32, torch.bfloat16)),
                 ("short", stage_packs[last], (2, shapes[last][0], 50), (torch.float32, torch.bfloat16)),
                 ("one sample", stage_packs[last], (1, shapes[last][0], 1), (torch.float32, torch.bfloat16)),
                 ("ragged short", ragged_pack, (2, 40, 50), (torch.bfloat16,))]
    errs["K2 bf16"] = 0.0
    for name, (spec, packed), shape, dts in k2_cases:
        x32 = torch.randn(shape, device=dev, generator=gen)
        for dt in dts:
            x = x32.to(dt)
            got = amp_stage(x, packed, spec)
            torch.cuda.synchronize()
            want = stage_reference(x, packed, spec)
            e = check_close(f"{name} {list(shape)} {dt}", got, want, TOL[("K2", dt)])
            key = "K2" if dt == torch.float32 else "K2 bf16"
            errs[key] = max(errs[key], e)
            del got, want
    # each launch against its plain version: the 18 convs (every (k, d)) of the
    # widest fused stage and of the ragged C = 40 under both bf16 contracts,
    # alone, onto a residual, and as a block's last launch (residual, running
    # sum, mean, bf16 out); float32 launches (the CUDA-core kernel) alone
    log("K2 launch by launch vs act_conv_reference:")
    errs["K2 launch"] = 0.0
    for (spec, packed), shape in ((stage_packs[min(stage_packs)], (2, shapes[min(stage_packs)][0], 777)),
                                  (ragged_pack, (1, 40, 300))):
        planes = [torch.randn(shape, device=dev, generator=gen) for _ in range(3)]
        src, res, acc_in = planes[0].bfloat16(), planes[1].bfloat16(), planes[2]
        worst = {}
        for n in range(18):
            for v1 in (False, True):
                for how, kw in (("alone", {}), ("onto res", {"res": res}),
                                ("last", {"res": res, "acc_in": acc_in, "mean_of": 3, "out_dtype": torch.bfloat16})):
                    got = act_conv(src, packed, spec, n, torch.bfloat16, v1=v1, **kw)
                    torch.cuda.synchronize()
                    want = act_conv_reference(src, packed, spec, n, torch.bfloat16, v1=v1, **kw)
                    e = max_err(got, want) / max(1.0, want.float().abs().max().item())
                    worst[(v1, how)] = max(worst.get((v1, how), 0.0), e)
                    if not e <= TOL[("K2 launch", torch.bfloat16)]:
                        raise AssertionError(f"launch {n} {conv_site(spec, n)} v1={v1} {how}: kernel disagrees ({e:.3e})")
            if n % 2 == 0:
                got = act_conv(planes[0], packed, spec, n, torch.float32)
                torch.cuda.synchronize()
                e = check_close(f"  float32 launch {n} {conv_site(spec, n)} {list(shape)}", got,
                                act_conv_reference(planes[0], packed, spec, n, torch.float32), TOL[("K2", torch.float32)])
                errs["K2"] = max(errs["K2"], e)
        for (v1, how), e in worst.items():
            log(f"  C = {spec.channels} {list(shape)} bf16, 18 launches, {'v1' if v1 else 'v2'} {how}: largest error "
                f"{e:.3e} of max(1, max|plain|) (tol {TOL[('K2 launch', torch.bfloat16)]:.2e})")
            errs["K2 launch"] = max(errs["K2 launch"], e)

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
    amp_stage.launches_by_kernel.update(act_conv_tc_kernel=0, act_conv_tf32_kernel=0)
    with torch.no_grad():
        outs = []
        for r in range(3):
            idx, ilen = front(audio_for(r))
            wav = vocoder(mid(idx, ilen))
            outs.append((idx, wav))
        torch.cuda.synchronize()
    launches = {"K1": anti_alias_activation.launches, "K2": amp_stage.launches}
    k2_by_kernel = dict(amp_stage.launches_by_kernel)
    log(f"  launches over 3 requests: K1 {launches['K1']}, K2 {launches['K2']} "
        f"(expected {3 * want_k1} and {3 * want_k2}); K2 by kernel {k2_by_kernel}")
    # every bf16 K2 launch runs on the bf16 tensor-core kernel
    assert k2_by_kernel == {"act_conv_tc_kernel": 3 * want_k2, "act_conv_tf32_kernel": 0}, k2_by_kernel
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
        request_kernels = {}
        profile_once("one request", lambda: vocoder(mid(*front(audio))), kernels=request_kernels)
    tc_names = [name for name in request_kernels if "act_conv_tc_kernel" in name]
    k1_names = [name for name in request_kernels if "anti_alias_kernel" in name]
    if request_kernels:  # the profiler recorded device time: it must name K1's kernel and K2's tensor-core kernel
        assert tc_names and not any("act_conv_tf32_kernel" in name for name in request_kernels), list(request_kernels)
        assert k1_names, list(request_kernels)
        log(f"  profiled K2: {sum(request_kernels[n] for n in tc_names):.2f} ms in {tc_names[0][:60]}")
        log(f"  profiled K1: {sum(request_kernels[n] for n in k1_names):.2f} ms in {k1_names[0][:60]}")
    with torch.no_grad():
        # the vocoder stage by stage (each fed its real input), summing to its total
        x = vocoder.pre(gen_mel)
        parts = {"conv_pre": cuda_ms(lambda: vocoder.pre(gen_mel), reps)}
        for i in range(len(vocoder.stages)):
            parts[f"s{i}"] = cuda_ms(lambda i=i, x=x: vocoder.stage(i, x), reps)
            x = vocoder.stage(i, x)
        parts["act_post + conv_post"] = cuda_ms(lambda: vocoder.post(x), reps)
    log("  vocoder by stage: " + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items())
        + f" (sum {sum(parts.values()):.2f} ms)")

    # kernel vs plain time at the main-path shapes (bf16, B = 16, and the
    # float32 vocoder's), per request
    ms = {"K1": 0.0, "K2": 0.0, "K2 float32": 0.0}
    plain_ms = {"K1": 0.0, "K2": 0.0, "K2 float32": 0.0}
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
            x32 = x.float()
            k32 = [cuda_ms(lambda: amp_stage(x32, packed, spec), 3)]
            p32 = cuda_ms(lambda: stage_reference(x32, packed, spec), 1)
            k32.append(cuda_ms(lambda: amp_stage(x32, packed, spec), 3))
            log(f"  K2 s{i} [{BATCH}, {c}, {t_len}] bf16: kernel {k:.3f} ms (18 launches), plain {p:.3f} ms; float32: "
                f"kernel {k32[0]:.3f} / {k32[1]:.3f} ms (split-TF32), plain {p32:.3f} ms")
            ms["K2"] += k
            plain_ms["K2"] += p
            ms["K2 float32"] += sum(k32) / 2
            plain_ms["K2 float32"] += p32
    log(f"  per request: K1 {ms['K1']:.3f} ms vs plain {plain_ms['K1']:.3f} ms; "
        f"K2 {ms['K2']:.3f} ms vs plain {plain_ms['K2']:.3f} ms; K2 float32 {ms['K2 float32']:.3f} ms vs plain "
        f"{plain_ms['K2 float32']:.3f} ms")
    log("  K2 and K2-v1 by part (the kernels with parts removed; ms per request or window, s2..s5 / s4 + s5):")
    parts_ms = {}  # {"K2 bf16 request": {part: ms}, ...}
    for (what, *shape), row in stage_parts.main().items():
        group = what.rsplit(" ", 1)[0]
        for part, v in row.items():
            parts_ms.setdefault(group, {}).setdefault(part, 0.0)
            parts_ms[group][part] += v
    for group, row in parts_ms.items():
        log(f"    {group}: " + ", ".join(f"{p} {v:.3f}" for p, v in row.items()))
    k1_issue = k1_floor.main()

    # ---- 6. the float32 serving path: stage-wise kernel vs plain, float32, same input per stage
    log("stage-wise vocoder error, float32, kernel vs plain on the same input:")
    # input: the log-mel of request 0's audio (the random codec's output is
    # near zero, which would make every stage's comparison trivially small)
    fused32 = FusedBigVGAN(voc32, fuse_max_channels=FUSE_MAX_CHANNELS)
    with torch.no_grad():
        x = fused32.pre(mel_tf(audio)[:, :frames])
    amp_stage.launches_by_kernel.update(act_conv_tc_kernel=0, act_conv_tf32_kernel=0)
    for i in range(len(fused32.stages)):
        got = fused32.stage(i, x)
        torch.cuda.synchronize()
        with plain_kernels():
            want = fused32.stage(i, x)
        kind = "K2" if fused32.stages[i][0] is not None else "K1"
        e = check_close(f"s{i} ({kind}) {list(got.shape)}", got, want, TOL[("K2", torch.float32)])
        if kind == "K2":
            errs["K2"] = max(errs["K2"], e)
        x = got
    # every float32 K2 launch on the split-TF32 kernel
    assert amp_stage.launches_by_kernel == {"act_conv_tc_kernel": 0, "act_conv_tf32_kernel": want_k2}, \
        amp_stage.launches_by_kernel
    got = fused32.post(x)
    with plain_kernels():
        want = fused32.post(x)
    check_close(f"act_post + conv_post {list(got.shape)}", got, want, TOL[("K2", torch.float32)])

    # one float32 codec request: a float32 DMelCodec and vocoder, as
    # cli.stream_codec builds them with no checkpoint (a released BigVGAN
    # generator is float32 too)
    log(f"float32 codec request: DMelCodec + BigVGAN in float32, {BATCH} x {SECONDS} s, TF32 off")
    torch.manual_seed(0)
    codec32 = DMelCodec(DMelCodecConfig()).eval().to(dev)

    def front32(audio_):
        return codec32.encode(mel_tf(audio_)[:, :frames], lengths)

    def mid32(idx_, ilen_):
        return codec32.decode(idx_, ilen_, generator=gen)

    anti_alias_activation.launches = amp_stage.launches = 0
    amp_stage.launches_by_kernel.update(act_conv_tc_kernel=0, act_conv_tf32_kernel=0)
    with torch.no_grad():
        idx32, ilen32 = front32(audio)
        wav32 = fused32(mid32(idx32, ilen32))
        torch.cuda.synchronize()
    f32_launches = {"K1": anti_alias_activation.launches, "K2": amp_stage.launches, **amp_stage.launches_by_kernel}
    log(f"  launches: {f32_launches}; indices {list(idx32.shape)}, wave {list(wav32.shape)} {wav32.dtype} rms "
        f"{wav32.square().mean().sqrt().item():.4f}")
    assert f32_launches == {"K1": want_k1, "K2": want_k2, "act_conv_tc_kernel": 0, "act_conv_tf32_kernel": want_k2}, \
        f32_launches
    assert idx32.shape == (BATCH, ccfg.dmel_groups * ccfg.n_codebooks, frames // 4)
    assert wav32.shape == (BATCH, samples) and wav32.dtype == torch.float32
    assert torch.isfinite(wav32).all() and wav32.abs().max() <= 1.0
    with torch.no_grad():
        gen_mel32 = mid32(idx32, ilen32)
        ms_front32 = cuda_ms(lambda: front32(audio), reps)
        ms_mid32 = cuda_ms(lambda: mid32(idx32, ilen32), reps)
        ms_voc32 = cuda_ms(lambda: fused32(gen_mel32), reps)
        x = fused32.pre(gen_mel32)
        parts32 = {"conv_pre": cuda_ms(lambda: fused32.pre(gen_mel32), reps)}
        for i in range(len(fused32.stages)):
            parts32[f"s{i}"] = cuda_ms(lambda i=i, x=x: fused32.stage(i, x), reps)
            x = fused32.stage(i, x)
        parts32["act_post + conv_post"] = cuda_ms(lambda: fused32.post(x), reps)
        request32_kernels = {}
        profile_once("one float32 request", lambda: fused32(mid32(*front32(audio))), kernels=request32_kernels)
    total32 = ms_front32 + ms_mid32 + ms_voc32
    float32_request = {"xrt": BATCH * SECONDS / (total32 / 1e3), "front_ms": ms_front32, "decode_ms": ms_mid32,
                       "vocoder_ms": ms_voc32, "vocoder_by_stage_ms": parts32, "launches": f32_launches}
    log(f"  xRT {float32_request['xrt']:.2f} ({total32:.2f} ms): front end {ms_front32:.2f} ms, decode "
        f"{ms_mid32:.2f} ms, vocoder {ms_voc32:.2f} ms")
    log("  float32 vocoder by stage: " + ", ".join(f"{k} {v:.2f} ms" for k, v in parts32.items())
        + f" (sum {sum(parts32.values()):.2f} ms)")
    tf32_names = [name for name in request32_kernels if "act_conv_tf32_kernel" in name]
    if request32_kernels:  # the profiler recorded device time: it must name the split-TF32 kernel, and no bf16 one
        assert tf32_names and not any("act_conv_tc_kernel" in name for name in request32_kernels), list(request32_kernels)
        float32_request["profiled_k2_ms"] = sum(request32_kernels[n] for n in tf32_names)
        log(f"  profiled K2 float32: {float32_request['profiled_k2_ms']:.2f} ms in {tf32_names[0][:70]}")
    del codec32, idx32, ilen32, wav32, gen_mel32

    # ---- 7. FA vs plain
    log("FA causal GQA flash attention vs plain:")
    fa_cases = [(2, 512, 14, 2, 64), (2, 2048, 14, 2, 64), (1, 4096, 14, 2, 64), (3, 513, 14, 2, 64),
                (1, 1500, 14, 2, 64), (2, 1, 14, 2, 64), (2, 700, 10, 2, 48), (1, 100, 4, 2, 16),
                (1, 77, 4, 2, 80), (1, 300, 4, 2, 128)]
    errs["FA"] = 0.0
    for b, sq, h, kh, hd in fa_cases:
        q32, k32, v32 = (torch.randn((b, sq, n, hd), device=dev, generator=gen) for n in (h, kh, kh))
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
            got = flash_attention(q, k, v)
            torch.cuda.synchronize()
            want = flash_attention_reference(q, k, v)
            e = check_close(f"q {[b, sq, h, hd]} kv heads {kh} {dt}", got, want, fa_rel(dt, v, want))
            if dt == torch.float32:
                errs["FA"] = max(errs["FA"], e)
            del got, want

    # ---- 8. the teacher-forced forward at full width
    log(f"LM forward: ChatMusicLM at full width, seeded random bf16 weights, B = {LM_BATCH} x S = {LM_SEQ}")
    torch.manual_seed(0)
    lm_cfg = SlowFastLMConfig()
    with torch.device(dev):
        lm = ChatMusicLM(lm_cfg)
    lm = lm.to(torch.bfloat16).eval()
    n_params = sum(p.numel() for p in lm.parameters())
    log(f"  {n_params / 1e6:.1f} M parameters; slow {lm_cfg.slow.num_layers} x {lm_cfg.slow.hidden_size}, "
        f"fast {lm_cfg.fast.num_layers} x {lm_cfg.fast.hidden_size}, vocabulary {lm_cfg.slow.vocab_size}")
    gridder = TokenGridBuilder(config=lm_cfg)
    rng = np.random.default_rng(0)
    # a grid is text + audio + 14 positions long: one fills S, one is padded to it
    grids = [gridder.build_train_grid(rng.integers(0, 151643, size=lt), rng.integers(0, 175, size=(la, 10)))
             for lt, la in ((34, LM_SEQ - 48), (20, LM_SEQ - 148))]
    batch = {k: torch.as_tensor(v, device=dev) for k, v in pad_grids_to_batch(grids, lm_cfg, pad_to=LM_SEQ).items()}
    assert batch["text_tokens"].shape == (LM_BATCH, LM_SEQ) and bool(batch["valid"][0].all())

    def forward():
        emb = lm.embed_inputs(batch["text_tokens"], batch["audio_tokens"])
        emb = emb * batch["valid"][..., None].to(emb.dtype)
        return lm(emb, batch["text_labels"], batch["audio_labels"])

    with torch.no_grad():
        set_flash(lm, True)
        flash_attention.launches = 0
        out_on = forward()
        torch.cuda.synchronize()
        launches["FA"] = flash_attention.launches
        set_flash(lm, False)
        out_off = forward()
        torch.cuda.synchronize()
        assert flash_attention.launches == launches["FA"]  # the einsum path launches none
        log(f"  FA launches in one forward: {launches['FA']} (expected {lm_cfg.slow.num_layers}: "
            f"the fast decoder's S = 11 stays on the einsum path)")
        assert launches["FA"] == lm_cfg.slow.num_layers, launches
        for name, out in (("flash on", out_on), ("flash off", out_off)):
            assert out["text_logits"].shape == (LM_BATCH, LM_SEQ, lm_cfg.slow.vocab_size)
            assert out["audio_logits"].shape == (LM_BATCH * (LM_SEQ - 1), 11, lm_cfg.audio_vocab)
            losses = {k: out[k].item() for k in ("loss", "text_loss", "audio_loss")}
            assert all(math.isfinite(x) and x > 0 for x in losses.values()), losses
            log(f"  {name}: " + ", ".join(f"{k} {x:.4f}" for k, x in losses.items()))
        for k in ("text_logits", "audio_logits"):
            diff = (out_on[k].float() - out_off[k].float()).abs()
            scale = max(1.0, out_off[k].float().abs().max().item())
            log(f"  {k} flash on vs off: max abs diff {diff.max().item():.3e}, mean {diff.mean().item():.3e} "
                f"(tol {TOL_LM_MAX * scale:.3e} / {TOL_LM_MEAN * scale:.3e}, max|logit| {scale:.3g})")
            assert diff.max().item() <= TOL_LM_MAX * scale and diff.mean().item() <= TOL_LM_MEAN * scale
            del diff
        assert abs(out_on["loss"].item() - out_off["loss"].item()) <= 1e-2 * out_off["loss"].item()
        del out_on, out_off
        torch.cuda.reset_peak_memory_stats()
        ms_off_1 = cuda_ms(forward, 3)
        set_flash(lm, True)
        ms_on_1 = cuda_ms(forward, 3)
        ms_on_2 = cuda_ms(forward, 3)
        peak_on = torch.cuda.max_memory_allocated() / 2**30
        profile_once("one LM forward, flash on", forward)
        set_flash(lm, False)
        ms_off_2 = cuda_ms(forward, 3)
    log(f"  forward ms (off, on, on, off): {ms_off_1:.2f}, {ms_on_1:.2f}, {ms_on_2:.2f}, {ms_off_2:.2f}; "
        f"peak device memory {peak_on:.2f} GiB")

    # ---- 9. LM serving through the entry point
    log(f"LM serving: infer_lm.main, text prompt -> {LM_FRAMES} frames -> codec decode -> vocoder -> WAV")
    prompt = "who are you?"
    seed = 3
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        CheckpointManager(str(tmp / "lm")).save(0, {"step": 0, "params": lm.state_dict()})
        CheckpointManager(str(tmp / "codec")).save(0, {"gen_params": codec.state_dict()})
        torch.save({"generator": voc16.state_dict()}, tmp / "vocoder.pt")
        (tmp / "infer.yaml").write_text(
            f"lm_ckpt_dir: {tmp / 'lm'}\ncodec_ckpt_dir: {tmp / 'codec'}\nvocoder_ckpt: {tmp / 'vocoder.pt'}\n"
            "text_tokenizer_path: null\nsilence_length: 3\ninference:\n"
            f"  temperature: 0.7\n  top_k: 50\n  top_p: 0.8\n  windows_penalty: 1.2\n  windows_length: 16\n"
            f"  max_new_tokens: {LM_FRAMES}\n  max_seq_len: 4096\n  cache_dtype: bfloat16\n"
        )
        anti_alias_activation.launches = amp_stage.launches = flash_attention.launches = 0
        amp_stage.launches_by_kernel.update(act_conv_tc_kernel=0, act_conv_tf32_kernel=0)
        t0 = time.perf_counter()
        infer_lm.main(["--config", str(tmp / "infer.yaml"), "--prompt", prompt, "--out", str(tmp / "out.wav"),
                       "--seed", str(seed), "--device", DEVICE])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        serve_launches = {"K1": anti_alias_activation.launches, "K2": amp_stage.launches,
                          "FA": flash_attention.launches}
        from scipy.io import wavfile
        wav_sr, wav = wavfile.read(tmp / "out.wav")
    icfg = InferenceConfig(max_new_tokens=LM_FRAMES, cache_dtype="bfloat16")
    generator_ = SlowFastGenerator(lm, icfg)
    grid = gridder.build_infer_grid(text_ids=ByteTokenizer().encode(prompt))
    audio_ids, text_ids = generator_.generate(*grid, torch.Generator(device=dev).manual_seed(seed))
    n_frames = audio_ids.shape[0]
    log(f"  infer_lm: {wall_s:.2f} s wall with loading; WAV {wav.shape} at {wav_sr} Hz, rms "
        f"{float(np.sqrt(np.mean(np.square(wav)))):.4f}; the same seed generates {n_frames} frames; "
        f"launches K1 {serve_launches['K1']}, K2 {serve_launches['K2']} {amp_stage.launches_by_kernel}, "
        f"FA {serve_launches['FA']} "
        f"(expected {want_k1}, {want_k2}, 0: the prompt is shorter than flash_min_seq)")
    assert wav_sr == SR and wav.dtype == np.float32 and np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    # infer_lm drops the last generated frame; a frame is 4 mel frames of 256 samples
    assert wav.shape == ((n_frames - 1) * 4 * HOP,), (wav.shape, n_frames)
    assert (audio_ids >= 0).all() and (audio_ids < lm_cfg.audio_vocab).all() and text_ids.shape == (n_frames,)
    assert serve_launches == {"K1": want_k1, "K2": want_k2, "FA": 0}, serve_launches

    del generator_
    generation = generation_phase(dev, lm, grid)

    # ---- 10. FA, plain and the library call at the main-path shape; bounds
    hd, heads, kv_heads = lm_cfg.slow.head_dim, lm_cfg.slow.num_heads, lm_cfg.slow.num_kv_heads
    q, k, v = (torch.randn((LM_BATCH, LM_SEQ, n, hd), device=dev, generator=gen).to(torch.bfloat16)
               for n in (heads, kv_heads, kv_heads))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    with torch.no_grad():
        fa_ms = [cuda_ms(lambda: flash_attention_reference(q, k, v), 10), cuda_ms(lambda: flash_attention(q, k, v), 20),
                 cuda_ms(sdpa, 20), cuda_ms(lambda: flash_attention(q, k, v), 20)]
        check_close("library call vs FA", sdpa().transpose(1, 2), flash_attention(q, k, v), 2.0**-6)
    n_fa = launches["FA"]
    ms["FA"], plain_ms["FA"], library_fa = n_fa * (fa_ms[1] + fa_ms[3]) / 2, n_fa * fa_ms[0], n_fa * fa_ms[2]
    fa_bound, fa_by = fa_bound_ms(LM_BATCH, LM_SEQ, heads, kv_heads, hd, 2)
    fa_launch = fa_ops.launch_config("FA", q)
    log(f"  FA {[LM_BATCH, LM_SEQ, heads, hd]} bf16, per launch: plain {fa_ms[0]:.3f} ms, kernel {fa_ms[1]:.4f} / "
        f"{fa_ms[3]:.4f} ms, scaled_dot_product_attention {fa_ms[2]:.4f} ms, bound {fa_bound:.4f} ms by {fa_by} "
        f"(x{n_fa} per forward); launch: grid {fa_launch['grid']}, {fa_launch['threads']} threads and "
        f"{fa_launch['smem_bytes']} bytes of shared memory per block")


    # ---- 11. K2-v1 vs plain: the flagship widths it holds, then ragged
    # lengths (one sample, shorter than the halo, not a multiple of any
    # tile) and widths that are no multiple of its 8-channel groups
    log("K2-v1 whole-stage kernel vs plain:")
    s4, s5 = last - 1, last
    assert shapes[s4][0] == V1_MAX_CHANNELS == 48 and shapes[s5][0] == 24, shapes
    v1_cases = [(f"s{i}", stage_packs[i], (2, *shapes[i]), (torch.float32, torch.bfloat16)) for i in (s4, s5)]
    v1_cases += [(f"window s{i}", stage_packs[i], (1, *win_shapes[i]), (torch.float32, torch.bfloat16))
                 for i in (s4, s5)]
    v1_cases += [(f"ragged T = {t_len}", stage_packs[s5], (b, 24, t_len), (torch.float32, torch.bfloat16))
                 for b, t_len in ((1, 1), (3, 37), (2, 50), (2, 700), (1, 1000))]
    v1_cases += [("ragged C = 5", random_pack(5), (1, 5, 700), (torch.float32, torch.bfloat16)),
                 ("ragged C = 7", random_pack(7), (3, 7, 37), (torch.float32, torch.bfloat16)),
                 ("ragged C = 40", random_pack(40), (1, 40, 1000), (torch.float32, torch.bfloat16)),
                 ("ragged C = 40, two clusters", random_pack(40), (1, 40, 9000), (torch.bfloat16,))]
    errs["K2-v1"] = errs["K2-v1 bf16"] = 0.0
    for name, (spec, packed), shape, dts in v1_cases:
        x32 = torch.randn(shape, device=dev, generator=gen)
        for dt in dts:
            x = x32.to(dt)
            got = amp_stage_v1(x, packed, spec)
            torch.cuda.synchronize()
            want = stage_reference_v1(x, packed, spec)
            e = check_close(f"{name} {list(shape)} {dt}", got, want, TOL[("K2-v1", dt)])
            key = "K2-v1" if dt == torch.float32 else "K2-v1 bf16"
            errs[key] = max(errs[key], e)
            del got, want
    v1_launch = {}
    for i in (s4, s5):
        spec, packed = stage_packs[i]
        cfg = v1_launch_config(torch.randn((1, *win_shapes[i]), device=dev, generator=gen).bfloat16(), packed, spec)
        v1_launch[f"s{i}"] = cfg
        log(f"  bf16 launch at a window's s{i} [1, {spec.channels}, {win_shapes[i][1]}]: grid {cfg['grid']} in clusters of "
            f"{cfg['cluster']}, {cfg['threads']} threads and {cfg['smem_bytes']} bytes of shared memory a block, "
            f"{cfg['tile']} columns a block")
    # K2 in v1 mode: what FusedBigVGAN(use_v2=False) runs at the fused stages
    # wider than K2-v1 takes (route "K2/v1"), held against K2-v1's plain version
    log("K2 in v1 mode (route K2/v1) vs plain (stage_reference_v1):")
    s2, s3 = s4 - 2, s4 - 1
    assert shapes[s2][0] == 192 and shapes[s3][0] == 96, shapes
    v1_mode_cases = [(f"s{i}", i, (2, *shapes[i])) for i in (s2, s3)]
    v1_mode_cases += [(f"window s{i}", i, (1, *win_shapes[i])) for i in (s2, s3)]
    errs["K2/v1"] = 0.0
    for name, i, shape in v1_mode_cases:
        spec, packed = stage_packs[i]
        x32 = torch.randn(shape, device=dev, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            before = dict(amp_stage.launches_by_kernel)
            got = amp_stage(x, packed, spec, v1=True)
            torch.cuda.synchronize()
            kernel = "act_conv_tc_kernel" if dt == torch.bfloat16 else "act_conv_tf32_kernel"
            assert amp_stage.launches_by_kernel[kernel] == before[kernel] + 18, (kernel, amp_stage.launches_by_kernel)
            want = stage_reference_v1(x, packed, spec)
            e = check_close(f"{name} {list(shape)} {dt}", got, want, TOL[("K2-v1", dt)])
            if dt == torch.float32:
                errs["K2/v1"] = max(errs["K2/v1"], e)
            del got, want
    with torch.no_grad():
        for i in (s2, s3):
            spec, packed = stage_packs[i]
            c, t_len = win_shapes[i]
            x = torch.randn((1, c, t_len), device=dev, generator=gen).to(torch.bfloat16)
            t_modes = [cuda_ms(lambda: amp_stage(x, packed, spec), 3), cuda_ms(lambda: amp_stage(x, packed, spec, v1=True), 3),
                       cuda_ms(lambda: amp_stage(x, packed, spec, v1=True), 3), cuda_ms(lambda: amp_stage(x, packed, spec), 3)]
            log(f"  window s{i} [1, {c}, {t_len}] bf16, 18 launches: K2 v2 mode {t_modes[0]:.3f} / {t_modes[3]:.3f} ms, "
                f"v1 mode {t_modes[1]:.3f} / {t_modes[2]:.3f} ms")
    try:
        amp_stage_v1(torch.zeros((1, 96, 256), device=dev), stage_packs[s4 - 1][1], stage_packs[s4 - 1][0])
    except ValueError as exc:
        log(f"  C = 96 on the card is refused: {exc}")
    else:
        raise AssertionError("amp_stage_v1 took a stage wider than V1_MAX_CHANNELS")
    # times at a codec request's shapes (B = 16), then at a streaming
    # window's (B = 1), which is what the path that launches K2-v1 gives it;
    # beside K2 in v1 mode (the same contract in 18 launches) and in v2 mode
    v1_times = {(what, dname): {"K2-v1": 0.0, "K2 v1 mode": 0.0, "K2": 0.0, "plain": 0.0}
                for what in ("request", "window") for dname in ("bf16", "float32")}
    with torch.no_grad():
        for (what, dname), total in v1_times.items():
            bsz, shp = (BATCH, shapes) if what == "request" else (1, win_shapes)
            dt = torch.bfloat16 if dname == "bf16" else torch.float32
            for i in (s4, s5):
                spec, packed = stage_packs[i]
                c, t_len = shp[i]
                x = torch.randn((bsz, c, t_len), device=dev, generator=gen).to(dt)
                t_v1 = [cuda_ms(lambda: amp_stage_v1(x, packed, spec), 3)]
                t_k2v1 = cuda_ms(lambda: amp_stage(x, packed, spec, v1=True), 3)
                t_k2 = cuda_ms(lambda: amp_stage(x, packed, spec), 3)
                t_v1.append(cuda_ms(lambda: amp_stage_v1(x, packed, spec), 3))
                t_plain = cuda_ms(lambda: stage_reference_v1(x, packed, spec), 3 if dname == "bf16" or what == "window" else 1)
                log(f"  {what} s{i} [{bsz}, {c}, {t_len}] {dname}: K2-v1 {t_v1[0]:.3f} / {t_v1[1]:.3f} ms (1 launch), "
                    f"K2 in v1 mode {t_k2v1:.3f} ms and v2 mode {t_k2:.3f} ms (18 launches each), plain {t_plain:.3f} ms")
                total["K2-v1"] += sum(t_v1) / 2
                total["K2 v1 mode"] += t_k2v1
                total["K2"] += t_k2
                total["plain"] += t_plain
        for (what, dname), total in v1_times.items():
            log(f"  s{s4} + s{s5} per {what}, {dname}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in total.items())
                + f"; K2-v1 / K2 in v1 mode {total['K2-v1'] / total['K2 v1 mode']:.3f}")
        v1_request, v1_window = v1_times[("request", "bf16")], v1_times[("window", "bf16")]
        ms["K2-v1"], plain_ms["K2-v1"] = v1_window["K2-v1"], v1_window["plain"]

        # K1 and K2 at the window's shapes, as the streaming path launches them
        win_ms = {"K1": 0.0, "K2": 0.0}
        win_plain_ms = {"K1": 0.0, "K2": 0.0}
        for name, count in (("act_post", 1), ("s0", 18), ("s1", 18)):
            shape = k1_win_shapes[name]
            x = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
            a = 0.3 * torch.randn(shape[1], device=dev, generator=gen)
            k = cuda_ms(lambda: anti_alias_activation(x, a, a, True), 10)
            p = cuda_ms(lambda: anti_alias_activation_reference(x, a, a, True), 10)
            log(f"  window K1 {name} {list(shape)} bf16: kernel {k:.3f} ms, plain {p:.3f} ms (x{count} per window)")
            win_ms["K1"] += count * k
            win_plain_ms["K1"] += count * p
        for i, (spec, packed) in stage_packs.items():
            c, t_len = win_shapes[i]
            x = torch.randn((1, c, t_len), device=dev, generator=gen).to(torch.bfloat16)
            k = cuda_ms(lambda: amp_stage(x, packed, spec), 3)
            p = cuda_ms(lambda: stage_reference(x, packed, spec), 3)
            log(f"  window K2 s{i} [1, {c}, {t_len}] bf16: kernel {k:.3f} ms (18 launches), plain {p:.3f} ms")
            win_ms["K2"] += k
            win_plain_ms["K2"] += p
    log(f"  per window: K1 {win_ms['K1']:.3f} ms vs plain {win_plain_ms['K1']:.3f} ms; "
        f"K2 {win_ms['K2']:.3f} ms vs plain {win_plain_ms['K2']:.3f} ms")

    # ---- 12. window invariance
    log("window invariance, float32 (and bf16 for K1, K2 and K2-v1): a kernel on x[:, :, 777:3001] against that region "
        "of its run on x (beyond its reach from the cuts); expected: the same bits")
    cut_a, cut_b = 777, 3001
    alpha24 = 0.3 * torch.randn(24, device=dev, generator=gen)
    inv_cases = [("K1", 24, 6, lambda v: anti_alias_activation(v, alpha24, alpha24, True)),
                 ("K1 bf16", 24, 6, lambda v: anti_alias_activation(v.bfloat16(), alpha24, alpha24, True))]
    for i in (s5, s4):
        spec, packed = stage_packs[i]
        inv_cases += [(f"K2 C = {spec.channels}", spec.channels, spec.receptive,
                       lambda v, sp=spec, pk=packed: amp_stage(v, pk, sp)),
                      (f"K2-v1 C = {spec.channels}", spec.channels, spec.receptive,
                       lambda v, sp=spec, pk=packed: amp_stage_v1(v, pk, sp))]
    # float32: K2's split-TF32 kernel at s2 too (16 warps, two column groups)
    spec, packed = stage_packs[s2]
    inv_cases += [(f"K2 C = {spec.channels}", spec.channels, spec.receptive, lambda v, sp=spec, pk=packed: amp_stage(v, pk, sp))]
    # bf16: K2's tensor-core kernel at s5, s4 and s2 (its tiles start at other samples on the slice),
    # K2-v1's cluster kernel at s5 and s4
    for i in (s5, s4, s2):
        spec, packed = stage_packs[i]
        inv_cases += [(f"K2 bf16 C = {spec.channels}", spec.channels, spec.receptive,
                       lambda v, sp=spec, pk=packed: amp_stage(v.bfloat16(), pk, sp))]
    for i in (s5, s4):
        spec, packed = stage_packs[i]
        inv_cases += [(f"K2-v1 bf16 C = {spec.channels}", spec.channels, spec.receptive,
                       lambda v, sp=spec, pk=packed: amp_stage_v1(v.bfloat16(), pk, sp))]
    for name, c, reach, fn in inv_cases:
        x = torch.randn((2, c, 5000), device=dev, generator=gen)
        whole, part = fn(x), fn(x[:, :, cut_a:cut_b].contiguous())
        diff = max_err(part[:, :, reach:-reach], whole[:, :, cut_a + reach : cut_b - reach])
        log(f"  {name}: max abs difference {diff:.3e} over {cut_b - cut_a - 2 * reach} samples")
        if diff != 0.0:
            raise AssertionError(f"{name}: the result depends on where the window lies")

    # ---- 13. the streaming path at full width
    log(f"streaming, chunked vs one-shot on a {EXACT_SECONDS} s clip, float32, flagship codec + vocoder:")
    torch.manual_seed(0)
    codec32 = DMelCodec(DMelCodecConfig()).eval().to(dev)
    rng = np.random.default_rng(1)
    frames_x = (EXACT_SECONDS * SR // HOP // 4) * 4
    mel_x = (0.5 * rng.standard_normal((1, frames_x, vcfg.num_mels))).astype(np.float32)
    noise_x = rng.standard_normal((1, frames_x, ccfg.concat_dim)).astype(np.float32)
    with torch.no_grad():
        idx_one, ilen_one = codec32.encode(torch.from_numpy(mel_x).to(dev), torch.full((1,), frames_x, device=dev))
        mel_one = codec32.decode(idx_one, ilen_one, torch.from_numpy(noise_x).to(dev))
    idx_chunked = streaming.chunked_encode(codec32, mel_x, chunk_frames=256)
    flips = int((idx_chunked != idx_one.cpu().numpy()).sum())
    log(f"  chunked_encode (3 windows of 256 + 2 x 128): {idx_chunked.shape[2]} tokens x {idx_chunked.shape[1]}, "
        f"{flips} differ from one-shot encode")
    assert idx_chunked.shape == tuple(idx_one.shape) and flips == 0
    mel_chunked = streaming.chunked_decode(codec32, idx_chunked, noise=noise_x, chunk_tokens=64)
    check_close("chunked_decode (3 windows of 64 + 2 x 32 tokens) vs one-shot decode",
                torch.from_numpy(mel_chunked), mel_one.cpu(), TOL_CHUNKED_DECODE)
    for use_v2 in (True, False):
        fused = FusedBigVGAN(voc32, fuse_max_channels=FUSE_MAX_CHANNELS, use_v2=use_v2)
        with torch.no_grad():
            one_shot = fused(torch.from_numpy(mel_x).to(dev)).cpu().numpy()
        chunked = streaming.chunked_vocode(fused, mel_x, VOCODE_CHUNK, VOCODE_HALO)
        end_to_end = float(np.abs(chunked - one_shot).max())
        stagewise = stagewise_window_error(fused, mel_x, dev)
        log(f"  chunked_vocode use_v2={use_v2} routes {fused.routes}: stage by stage max relative error "
            f"{stagewise:.3e} (tol {TOL_CHUNKED_STAGE:.0e}); end to end max |chunked - one-shot| {end_to_end:.3e} "
            f"(tol {TOL_CHUNKED_WAVE:.0e}; the JAX package's kernel path: 1.58e-1)")
        assert chunked.shape == one_shot.shape == (1, frames_x * HOP)
        if not (stagewise <= TOL_CHUNKED_STAGE and end_to_end <= TOL_CHUNKED_WAVE):
            raise AssertionError("the chunked vocoder disagrees with its one-shot run")
    # free what the earlier phases hold, so that peak memory below is the streaming path's
    del codec32, mel_one, idx_one
    lm = batch = None  # noqa: F841
    gc.collect()
    torch.cuda.empty_cache()

    minutes_frames = LONG_MINUTES * 60 * SR // HOP
    window = VOCODE_CHUNK + 2 * VOCODE_HALO
    n_windows = -(-minutes_frames // VOCODE_CHUNK)
    log(f"streaming, {LONG_MINUTES} minutes through chunked_vocode, B = 1, bf16 and float32: {minutes_frames} mel "
        f"frames, {n_windows} windows of {VOCODE_CHUNK} + 2 x {VOCODE_HALO}")
    mel_long = (0.5 * rng.standard_normal((1, minutes_frames, vcfg.num_mels))).astype(np.float32)
    stream_stats = {}
    counters = {"K1": anti_alias_activation, "K2": amp_stage, "K2-v1": amp_stage_v1}
    for voc, dname in ((voc16, "bf16"), (voc32, "float32")):
        k2_kernel, v1_kernel = (("act_conv_tc_kernel", "stage_v1_tc_kernel") if dname == "bf16"
                                else ("act_conv_tf32_kernel", "stage_v1_tf32_kernel"))
        for use_v2 in (True, False):
            fused = FusedBigVGAN(voc, fuse_max_channels=FUSE_MAX_CHANNELS, use_v2=use_v2)
            streaming.chunked_vocode(fused, mel_long[:, : 2 * window], VOCODE_CHUNK, VOCODE_HALO)  # warm-up
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            amp_stage.launches_by_kernel.update(act_conv_tc_kernel=0, act_conv_tf32_kernel=0)
            amp_stage_v1.launches_by_kernel.update(stage_v1_tc_kernel=0, stage_v1_tf32_kernel=0)
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            wav = streaming.chunked_vocode(fused, mel_long, VOCODE_CHUNK, VOCODE_HALO)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            counts = {name: fn.launches for name, fn in counters.items()}
            by_kernel = {**amp_stage.launches_by_kernel, **amp_stage_v1.launches_by_kernel}
            assert wav.shape == (1, minutes_frames * HOP) and np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
            n_v1 = fused.routes.count("K2-v1")
            n_k2 = fused.routes.count("K2") + fused.routes.count("K2/v1")
            assert use_v2 or "K2" not in fused.routes, fused.routes  # use_v2=False runs v1 at every fused stage
            assert counts == {"K1": n_windows * want_k1, "K2": n_windows * 18 * n_k2, "K2-v1": n_windows * n_v1}, counts
            # every K2 and K2-v1 launch on the kernel of the vocoder's dtype
            assert by_kernel[k2_kernel] == counts["K2"] and by_kernel[v1_kernel] == counts["K2-v1"], by_kernel
            assert sum(by_kernel.values()) == counts["K2"] + counts["K2-v1"], by_kernel
            stream_stats[(dname, use_v2)] = {"seconds": seconds, "xrt": LONG_MINUTES * 60 / seconds, "peak": peak,
                                             "resident": resident, **counts}
            log(f"  {dname} use_v2={use_v2}: {seconds:.3f} s, xRT {LONG_MINUTES * 60 / seconds:.2f} with host staging; "
                f"peak device memory {peak / 2**20:.1f} MiB ({resident / 2**20:.1f} MiB resident before the run, "
                f"{(peak - resident) / 2**20:.1f} MiB the run's own); launches K1 {counts['K1']}, K2 {counts['K2']}, "
                f"K2-v1 {counts['K2-v1']} ({by_kernel}); rms {float(np.sqrt(np.mean(np.square(wav)))):.4f}")
            del wav
    # the float32 kernels by name in a profile of two float32 windows with use_v2=False
    fused = FusedBigVGAN(voc32, fuse_max_channels=FUSE_MAX_CHANNELS, use_v2=False)
    stream_kernels = {}
    profile_once("two float32 windows, use_v2=False",
                 lambda: streaming.chunked_vocode(fused, mel_long[:, : 2 * window], VOCODE_CHUNK, VOCODE_HALO),
                 kernels=stream_kernels)
    if stream_kernels:  # the profiler recorded device time: it must name both float32 kernels, and no bf16 one
        names = list(stream_kernels)
        assert any("stage_v1_tf32_kernel" in n for n in names) and any("act_conv_tf32_kernel" in n for n in names), names
        assert not any("stage_v1_tc_kernel" in n or "act_conv_tc_kernel" in n for n in names), names
    launches["K2-v1"] = stream_stats[("bf16", False)]["K2-v1"]
    launches["K2-v1 float32"] = stream_stats[("float32", False)]["K2-v1"]
    assert launches["K2-v1"] > 0 and launches["K2-v1 float32"] > 0
    with torch.no_grad():
        mel_dev = torch.from_numpy(mel_x).to(device=dev, dtype=torch.bfloat16)
        vocoder(mel_dev)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        vocoder(mel_dev)
        torch.cuda.synchronize()
        own = torch.cuda.max_memory_allocated() - resident
    scaled = own * minutes_frames / frames_x
    log(f"  one-shot, {EXACT_SECONDS} s clip, bf16, use_v2=True: the run's own peak {own / 2**20:.1f} MiB; scaled by "
        f"frames to {LONG_MINUTES} minutes: {scaled / 2**30:.2f} GiB (+ {resident / 2**20:.1f} MiB resident)")

    log(f"streaming, {CHAIN_SECONDS} s through chunked_encode -> chunked_decode -> chunked_vocode, bf16:")
    t_axis = torch.arange(CHAIN_SECONDS * SR, device=dev) / SR
    tone = 0.5 * torch.sin(2 * math.pi * 220.0 * t_axis) + 0.1 * torch.sin(2 * math.pi * 3.1 * 220.0 * t_axis)
    mel_chain = mel_tf(tone[None]).cpu().numpy()
    frames_c = (mel_chain.shape[1] // 4) * 4
    t0 = time.perf_counter()
    idx_c = streaming.chunked_encode(codec, mel_chain)
    t1 = time.perf_counter()
    gen_c = streaming.chunked_decode(codec, idx_c, seed=0)
    t2 = time.perf_counter()
    wav_c = streaming.chunked_vocode(vocoder, gen_c, VOCODE_CHUNK, VOCODE_HALO)
    t3 = time.perf_counter()
    log(f"  {mel_chain.shape[1]} frames -> tokens {list(idx_c.shape)} in {t1 - t0:.3f} s -> mel {list(gen_c.shape)} in "
        f"{t2 - t1:.3f} s -> wave {list(wav_c.shape)} in {t3 - t2:.3f} s; xRT {CHAIN_SECONDS / (t3 - t0):.2f}")
    assert idx_c.shape == (1, ccfg.dmel_groups * ccfg.n_codebooks, frames_c // 4)
    assert 0 <= idx_c.min() and idx_c.max() < ccfg.codebook_size
    assert gen_c.shape == (1, frames_c, ccfg.n_mels) and np.isfinite(gen_c).all()
    assert wav_c.shape == (1, frames_c * HOP) and np.isfinite(wav_c).all() and np.abs(wav_c).max() <= 1.0

    log(f"streaming through the entry point: stream_codec.main on a {CLI_SECONDS} s WAV, default device, --use-v1")
    from scipy.io import wavfile
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        wavfile.write(tmp / "in.wav", SR, tone[: CLI_SECONDS * SR].cpu().numpy())
        for fn in counters.values():
            fn.launches = 0
        amp_stage.launches_by_kernel.update(act_conv_tc_kernel=0, act_conv_tf32_kernel=0)
        amp_stage_v1.launches_by_kernel.update(stage_v1_tc_kernel=0, stage_v1_tf32_kernel=0)
        t0 = time.perf_counter()
        stream_codec.main(["--in", str(tmp / "in.wav"), "--tokens-out", str(tmp / "tokens.npy"),
                           "--out", str(tmp / "out.wav"), "--use-v1"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        cli_counts = {name: fn.launches for name, fn in counters.items()}
        # the entry point's vocoder is float32 (no --vocoder-dir): the split-TF32 kernels
        cli_by_kernel = {**amp_stage.launches_by_kernel, **amp_stage_v1.launches_by_kernel}
        assert cli_by_kernel == {"act_conv_tc_kernel": 0, "act_conv_tf32_kernel": cli_counts["K2"],
                                 "stage_v1_tc_kernel": 0, "stage_v1_tf32_kernel": cli_counts["K2-v1"]}, cli_by_kernel
        tokens = np.load(tmp / "tokens.npy")
        wav_sr, wav = wavfile.read(tmp / "out.wav")
    frames_cli = (CLI_SECONDS * SR // HOP // 4) * 4
    log(f"  {wall_s:.2f} s wall with building the models; tokens {list(tokens.shape)}, WAV {wav.shape} at {wav_sr} Hz, "
        f"rms {float(np.sqrt(np.mean(np.square(wav)))):.4f}; launches {cli_counts} ({cli_by_kernel})")
    assert tokens.shape == (1, ccfg.dmel_groups * ccfg.n_codebooks, frames_cli // 4)
    assert wav_sr == SR and wav.dtype == np.float32 and wav.shape == (frames_cli * HOP,)
    assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    assert all(n > 0 for n in cli_counts.values()), cli_counts
    cli_counts_stream = dict(cli_counts)  # phase 22 serves a trained checkpoint the same way

    # the entry point pins float32 itself: a fresh process turns TF32 on,
    # runs stream_codec's main (encode only) and reports what it allows after
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        wavfile.write(tmp / "in.wav", SR, tone[: 4 * SR].cpu().numpy())
        proc = subprocess.run([sys.executable, "-c", CLI_TF32_PROBE, "stream_codec", "--in", str(tmp / "in.wav"),
                               "--tokens-out", str(tmp / "tokens.npy")],
                              cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"stream_codec.main in a fresh process failed:\n{proc.stderr[-4000:]}")
        flags = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"  stream_codec.main in a fresh process that turned TF32 on: afterwards {flags}")
    assert flags["cuda.matmul.allow_tf32"] is False and flags["cudnn.allow_tf32"] is False, flags
    assert flags.get("cudnn.conv.fp32_precision") != "tf32", flags

    # ---- 14. the K1 ablation probe
    log("K1 ablation probe vs plain:")
    errs["probe"] = 0.0
    for shape, with_beta in (((2, 24, 3000), True), ((3, 7, 37), False), ((1, 5, 1), True)):
        c = shape[1]
        alpha = 0.3 * torch.randn(c, device=dev, generator=gen)
        beta = 0.3 * torch.randn(c, device=dev, generator=gen) if with_beta else None
        x32 = torch.randn(shape, device=dev, generator=gen)
        for variant in act_variants.VARIANTS:
            for dt in (torch.float32, torch.bfloat16):
                got = act_variants.run_variant(x32.to(dt), alpha, beta, variant)
                torch.cuda.synchronize()
                want = act_variants.variant_reference(x32.to(dt), alpha, beta, variant)
                e = check_close(f"{variant} {list(shape)} {dt}", got, want, TOL[("K1", dt)])
                if dt == torch.float32:
                    errs["probe"] = max(errs["probe"], e)
    act_variants.run_variant.launches = 0
    probe_table = act_variants.main()
    launches["probe"] = act_variants.run_variant.launches
    assert launches["probe"] > 0
    probe_shape = k1_shapes["s1"]
    assert probe_shape in probe_table, (probe_shape, list(probe_table))
    with torch.no_grad():
        x = torch.randn(probe_shape, device=dev, generator=gen).to(torch.bfloat16)
        a = 0.3 * torch.randn(probe_shape[1], device=dev, generator=gen)
        probe_plain = {v: cuda_ms(lambda v=v: act_variants.variant_reference(x, a, a, v), 5)
                       for v in act_variants.VARIANTS}
    log(f"  plain versions at {list(probe_shape)} bf16: " + ", ".join(f"{v} {t:.3f} ms" for v, t in probe_plain.items()))

    # ---- 15. bounds, from the shapes of this run (bf16)
    k1_bytes = k1_flops = 0.0
    for shape, count in ((k1_shapes["act_post"], 1), (k1_shapes["s0"], 18), (k1_shapes["s1"], 18)):
        k1_bytes += count * 2 * math.prod(shape) * 2
        k1_flops += count * K1_FLOPS_PER_SAMPLE * math.prod(shape)
    k1_bound = {"bytes": k1_bytes / PEAK_BYTES * 1e3, "operations": k1_flops / PEAK_F32 * 1e3}
    ksizes = vcfg.resblock_kernel_sizes
    k2_bound = stage_bound_ms([shapes[i] for i in stage_packs], BATCH, ksizes)
    # float32: at the CUDA cores' rate, and at the split-TF32 kernels' (three TF32 products)
    k2_f32_bound = stage_bound_ms([shapes[i] for i in stage_packs], BATCH, ksizes, itemsize=4)
    k2_tf32_bound = stage_bound_ms([shapes[i] for i in stage_packs], BATCH, ksizes, 4, PEAK_TF32 / 3)
    k2_tf32_win_bound = stage_bound_ms([win_shapes[i] for i in stage_packs], 1, ksizes, 4, PEAK_TF32 / 3)
    v1_f32_bound = stage_bound_ms([win_shapes[s4], win_shapes[s5]], 1, ksizes, itemsize=4)
    v1_tf32_bound = stage_bound_ms([win_shapes[s4], win_shapes[s5]], 1, ksizes, 4, PEAK_TF32 / 3)
    v1_tf32_request_bound = stage_bound_ms([shapes[s4], shapes[s5]], BATCH, ksizes, 4, PEAK_TF32 / 3)
    # K2-v1: the logical work of its two stages (no halo), as K2's, at the
    # streaming window's shapes (its `ms`) and at a codec request's
    v1_bound = stage_bound_ms([win_shapes[s4], win_shapes[s5]], 1, ksizes)
    v1_request_bound = stage_bound_ms([shapes[s4], shapes[s5]], BATCH, ksizes)
    # the probe's four variants at one shape: the plane in and out once each
    # launch; operations where the variant keeps them (full 58 per sample,
    # no_snake 50, no_fir 4, copy 0)
    n_probe = math.prod(probe_shape)
    probe_bound = {"bytes": 4 * 2 * n_probe * 2 / PEAK_BYTES * 1e3,
                   "operations": (58 + 50 + 4) * n_probe / PEAK_F32 * 1e3}
    bounds = {}
    for name, bound in (("K1", k1_bound), ("K2", k2_bound), ("K2-v1", v1_bound), ("probe", probe_bound),
                        ("K2 float32", k2_tf32_bound), ("K2-v1 float32", v1_tf32_bound)):
        by = max(bound, key=bound.get)
        bounds[name] = (bound[by], by)
        log(f"  {name} bound: {bound['bytes']:.4f} ms by bytes, {bound['operations']:.4f} ms by operations")

    # ---- 16. FA-dKV and FA-dQ vs plain
    log("FA backward kernels (FA-dKV, FA-dQ) vs plain:")
    trainer_shape = (LM_BATCH, TRAIN_SEQ, heads, kv_heads, hd)
    bwd_cases = [(LM_BATCH, LM_SEQ, heads, kv_heads, hd), trainer_shape, (2, 1, heads, kv_heads, hd),
                 (3, 37, heads, kv_heads, hd), (2, 700, heads, kv_heads, hd), (1, 1000, heads, kv_heads, hd),
                 (2, 700, 10, 2, 48), (1, 300, 4, 2, 128), (1, 130, 4, 4, 16)]
    errs["FA-dKV"] = errs["FA-dQ"] = 0.0
    counters_fa = {"FA": flash_attention, "FA-dKV": fa_ops.flash_attention_dkv, "FA-dQ": fa_ops.flash_attention_dq}
    for b, sq, h, kh, d in bwd_cases:
        q32, k32, v32 = (torch.randn((b, sq, n, d), device=dev, generator=gen) for n in (h, kh, kh))
        g32 = torch.randn((b, sq, h, d), device=dev, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, g = (t.to(dt, copy=True).requires_grad_() for t in (q32, k32, v32, g32))
            for fn in counters_fa.values():
                fn.launches = 0
            out = flash_attention(q, k, v)  # under autograd: the forward stores L
            got = torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
            again = torch.autograd.grad(out, (q, k, v), g)
            torch.cuda.synchronize()
            assert {n_: fn.launches for n_, fn in counters_fa.items()} == {"FA": 1, "FA-dKV": 2, "FA-dQ": 2}
            q, k, v, g = (t.detach() for t in (q, k, v, g))
            out_k, lse = fa_ops._launch(q, k, v, with_lse=True)
            out_p, lse_p = fa_ops.flash_attention_forward_reference(q, k, v)
            tag = f"q {[b, sq, h, d]} kv heads {kh} {dt}"
            assert torch.equal(out_k, out.detach())  # the L store changes no bit of the output
            e_out = check_close(f"out (with the L store) {tag}", out_k, out_p, fa_rel(dt, v, out_p))
            check_close(f"L {[b, h, sq]} hd {d} {dt}", lse, lse_p, TOL[("FA", torch.float32)])
            # the plain backward takes the plain forward's out and L, so
            # nothing of the kernels enters the numbers they are held against
            dk_p, dv_p = fa_ops.flash_attention_dkv_reference(q, k, v, out_p, lse_p, g)
            dq_p = fa_ops.flash_attention_dq_reference(q, k, v, out_p, lse_p, g)
            e_q = check_close(f"dq {tag}", got[0], dq_p, TOL[("FA-bwd", dt)])
            e_kv = max(check_close(f"dk {tag}", got[1], dk_p, TOL[("FA-bwd", dt)]),
                       check_close(f"dv {tag}", got[2], dv_p, TOL[("FA-bwd", dt)]))
            if not all(torch.equal(a_, b_) for a_, b_ in zip(got, again)):
                raise AssertionError(f"{tag}: two runs of the backward kernels differ")
            if dt == torch.float32:
                errs["FA-dQ"], errs["FA-dKV"] = max(errs["FA-dQ"], e_q), max(errs["FA-dKV"], e_kv)
                errs["FA"] = max(errs["FA"], e_out)
            del got, again, out, out_k, out_p, lse, lse_p, dk_p, dv_p, dq_p
    log("  two runs of FA-dKV and FA-dQ gave the same bits in every case")
    # an independent derivation: autograd through the plain forward (softmax
    # backward), at the trainer's shape and a ragged one
    for b, sq in ((LM_BATCH, TRAIN_SEQ), (2, 700)):
        q, k, v, g = (torch.randn((b, sq, n, hd), device=dev, generator=gen)
                      for n in (heads, kv_heads, kv_heads, heads))
        ins = [t.requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(flash_attention(*ins), ins, g)
        want = torch.autograd.grad(flash_attention_reference(*ins), ins, g)
        for name, a_, w_ in zip(("dq", "dk", "dv"), got, want):
            check_close(f"{name} vs autograd of the plain forward, {[b, sq, heads, hd]} float32", a_, w_,
                        TOL[("FA-bwd", torch.float32)])
        del q, k, v, g, ins, got, want

    # ---- 17. LM training at full width
    log(f"LM training: LMTrainer at full width, float32 parameters, flash attention on, "
        f"B = {LM_BATCH} x S = {TRAIN_SEQ}, accumulate_grad = {TRAIN_ACCUMULATE}")
    gc.collect()
    torch.cuda.empty_cache()
    train_cfg = LMTrainConfig(accumulate_grad=TRAIN_ACCUMULATE, num_warmup_steps=0)
    flash_cfg = dataclasses.replace(lm_cfg, text_weight=0.01,
                                    slow=dataclasses.replace(lm_cfg.slow, flash_attention=True))
    trainer = LMTrainer(flash_cfg, train_cfg, device=dev)
    state = trainer.init_state(0)
    n_train = sum(p.numel() for p in state.params.values())
    assert n_train == n_params and all(p.dtype == torch.float32 and p.is_cuda for p in state.params.values())

    def decoder_options(**changes) -> None:
        """Switch options of the trainer's decoders (both for `remat`, the slow one for flash)."""
        from dmel_codec_tpu_torch.models.transformer import Attention, Decoder

        decoders = [trainer.model.slow_decoder] + ([trainer.model.fast_decoder] if "remat" in changes else [])
        for decoder in decoders:
            for m in decoder.modules():
                if isinstance(m, (Attention, Decoder)):
                    m.config = dataclasses.replace(m.config, **changes)

    def token_batches(seq: int, n: int, seed: int):
        rng_ = np.random.default_rng(seed)
        out = []
        for _ in range(n):
            grids_ = [gridder.build_train_grid(rng_.integers(0, 151643, size=lt), rng_.integers(0, 175, size=(la, 10)))
                      for lt, la in ((34, seq - 48), (20, seq - 148))]
            out.append(trainer.device_batch(pad_grids_to_batch(grids_, lm_cfg, pad_to=seq)))
        return out

    train_batches = token_batches(TRAIN_SEQ, 2, seed=4)
    assert train_batches[0]["text_tokens"].shape == (LM_BATCH, TRAIN_SEQ)
    names = list(state.params)
    n_layers = lm_cfg.slow.num_layers

    def reset_counts():
        for fn in counters_fa.values():
            fn.launches = 0

    def counts():
        return {n_: fn.launches for n_, fn in counters_fa.items()}

    # the first micro-step's loss and gradients, kernels on against flash_attention=False
    reset_counts()
    (loss_on, _), grads_on = trainer.loss_fn(state.params, train_batches[0], wrt=list(state.params.values()))
    torch.cuda.synchronize()
    assert counts() == {"FA": n_layers, "FA-dKV": n_layers, "FA-dQ": n_layers}, counts()
    decoder_options(flash_attention=False)
    (loss_off, _), grads_off = trainer.loss_fn(state.params, train_batches[0], wrt=list(state.params.values()))
    torch.cuda.synchronize()
    assert counts() == {"FA": n_layers, "FA-dKV": n_layers, "FA-dQ": n_layers}  # the einsum path launches none
    decoder_options(flash_attention=True)
    loss_on, loss_off = loss_on.item(), loss_off.item()
    log(f"  loss, kernels on {loss_on:.6f} vs flash_attention=False {loss_off:.6f} "
        f"(tol {TOL_TRAIN_LOSS:.0e} relative)")
    assert math.isfinite(loss_on) and abs(loss_on - loss_off) <= TOL_TRAIN_LOSS * abs(loss_off)
    worst = ("", 0.0)
    for name, g_on, g_off in zip(names, grads_on, grads_off):
        rel = max_err(g_on, g_off) / max(g_off.abs().max().item(), 1e-30)
        if rel > worst[1]:
            worst = (name, rel)
    log(f"  gradients of {len(names)} tensors, kernels on vs off: worst max error relative to the tensor's "
        f"largest gradient {worst[1]:.3e} at {worst[0]} (tol {TOL_TRAIN_GRAD:.0e})")
    assert worst[1] <= TOL_TRAIN_GRAD, worst
    del grads_on, grads_off

    # 4 micro-steps = 2 updates through train_step
    snapshot = {n_: p.detach().clone() for n_, p in state.params.items()}
    plain_losses = []  # phase 26 holds the laid-out trainer to these
    reset_counts()
    for i in range(TRAIN_MICRO_STEPS):
        state, metrics = trainer.train_step(state, train_batches[i % 2])
        torch.cuda.synchronize()
        seen = counts()
        want_n = (i + 1) * n_layers
        assert seen == {"FA": want_n, "FA-dKV": want_n, "FA-dQ": want_n}, (i, seen)
        vals = {k_: float(v_) for k_, v_ in metrics.items()}
        assert all(math.isfinite(x) for x in vals.values()), vals
        plain_losses.append({k_: vals[k_] for k_ in ("train/loss", "train/text_loss", "train/audio_loss")})
        changed = sum(not torch.equal(snapshot[n_], p) for n_, p in state.params.items())
        is_update = (i + 1) % TRAIN_ACCUMULATE == 0
        log(f"  micro-step {i + 1}: loss {vals['train/loss']:.4f} (text {vals['train/text_loss']:.4f}, audio "
            f"{vals['train/audio_loss']:.4f}), grad norm {vals['train/grad_norm']:.4f}, lr {vals['train/lr']:.2e}, "
            f"top-1 {vals['train/audio_top1_acc']:.4f}; {changed} of {len(names)} tensors changed "
            f"({'an update' if is_update else 'no update'} step)")
        assert changed == (len(names) if is_update else 0), (i, changed)
        if is_update:
            snapshot = {n_: p.detach().clone() for n_, p in state.params.items()}
        if i == 0:
            assert abs(vals["train/loss"] - loss_on) <= 1e-5 * abs(loss_on)
    launches.update({"FA-dKV": seen["FA-dKV"], "FA-dQ": seen["FA-dQ"], "FA train": seen["FA"]})
    log(f"  launches over {TRAIN_MICRO_STEPS} micro-steps: {seen} ({n_layers} each per micro-step)")
    assert state.step == TRAIN_MICRO_STEPS and state.opt_state.gradient_step == TRAIN_MICRO_STEPS // TRAIN_ACCUMULATE

    # a LoRA update changes no base parameter
    lora_state = trainer.init_lora_state(1, LoRAConfig(), base_params=state.params)
    for i in range(TRAIN_ACCUMULATE):
        lora_state, metrics = trainer.lora_train_step(lora_state, train_batches[i % 2])
    torch.cuda.synchronize()
    base_changed = sum(not torch.equal(snapshot[n_], p) for n_, p in state.params.items())
    moved = sum(bool(ab["b"].abs().sum() > 0) for ab in lora_state.lora.values())
    log(f"  LoRA, {TRAIN_ACCUMULATE} micro-steps = 1 update: loss {float(metrics['train/loss']):.4f}, "
        f"{moved} of {len(lora_state.lora)} adapters moved, {base_changed} base tensors changed")
    assert base_changed == 0 and moved == len(lora_state.lora) and lora_state.opt_state.gradient_step == 1
    del lora_state, snapshot

    def time_micro_steps(batches_, what: str, fa_per_step: int):
        """ms per micro-step (CUDA events around each of 6 micro-steps; the
        mean of the last 4, which are two whole accumulation cycles: an
        update step costs an AdamW pass more than the one before it), the
        run's peak device memory, tokens/s."""
        assert state.step % TRAIN_ACCUMULATE == 0  # every variant starts on a cycle's first micro-step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        events = []
        for i in range(6):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            trainer.train_step(state, batches_[i % 2])
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        times = [s_.elapsed_time(e_) for s_, e_ in events[2:]]
        step_ms = sum(times) / len(times)
        tokens = batches_[0]["text_tokens"].numel()
        peak = torch.cuda.max_memory_allocated() / 2**30
        assert counts()["FA"] == 6 * fa_per_step and counts()["FA-dKV"] == counts()["FA-dQ"] == 6 * min(fa_per_step, n_layers)
        log(f"  {what}: {step_ms:.2f} ms per micro-step (last 4: {', '.join(f'{t_:.2f}' for t_ in times)}; every "
            f"second one updates), {tokens / step_ms * 1e3:.0f} tokens/s, peak device memory {peak:.2f} GiB")
        return step_ms, peak

    train_stats = {}
    train_stats["kernels"] = time_micro_steps(train_batches, f"{LM_BATCH} x {TRAIN_SEQ}, kernels on", n_layers)
    cycle_kernels = {}
    profile_once(f"one accumulation cycle ({TRAIN_ACCUMULATE} micro-steps, 1 update), kernels on",
                 lambda: [trainer.train_step(state, b_) for b_ in train_batches], kernels=cycle_kernels)
    # the float32 FA and FA-dQ launches run the split-TF32 kernels; the
    # CUDA-core kernels they replaced are gone
    assert cycle_kernels, "the profiler recorded no device time for the train step"
    fa_names = {kernel: [n_ for n_ in cycle_kernels if re.search(rf"(?<![A-Za-z_]){kernel}[<I]", n_)]
                for kernel in ("flash_attention_tf32_kernel", "dq_tf32_kernel", "dkv_f32_kernel",
                               "flash_attention_kernel", "flash_attention_dq_kernel")}
    assert fa_names["flash_attention_tf32_kernel"] and fa_names["dq_tf32_kernel"], list(cycle_kernels)
    assert not fa_names["flash_attention_kernel"] and not fa_names["flash_attention_dq_kernel"], fa_names
    log("  the profile names " + ", ".join(f"{k_} ({sum(cycle_kernels[n_] for n_ in v_):.2f} ms)"
                                           for k_, v_ in fa_names.items() if v_))
    decoder_options(flash_attention=False)
    train_stats["off"] = time_micro_steps(train_batches, f"{LM_BATCH} x {TRAIN_SEQ}, flash_attention=False", 0)
    decoder_options(flash_attention=True, remat=True)
    train_stats["remat"] = time_micro_steps(train_batches, f"{LM_BATCH} x {TRAIN_SEQ}, kernels on, remat=True",
                                            2 * n_layers)
    long_batches = token_batches(LM_SEQ, 2, seed=5)
    train_stats["long remat"] = time_micro_steps(long_batches, f"{LM_BATCH} x {LM_SEQ}, kernels on, remat=True "
                                                 f"(phase 8's forward alone: {ms_on_1:.2f} ms in bf16)", 2 * n_layers)
    decoder_options(remat=False)
    train_stats["long"] = time_micro_steps(long_batches, f"{LM_BATCH} x {LM_SEQ}, kernels on, no remat", n_layers)
    assert all(torch.isfinite(p).all() for p in state.params.values())
    parallel_batches = train_batches  # phase 26's
    del long_batches, train_batches, state, trainer
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 18. LM training through the entry point
    log("LM training through the entry point: train_lm.main on 8 synthetic WAVs, a small LM, the flagship codec")
    small_lm = ("slow_lm: {hidden_size: 256, intermediate_size: 512, num_layers: 4, num_heads: 4, num_kv_heads: 2, "
                "flash_attention: true, flash_min_seq: 64}\n"
                "fast_lm: {hidden_size: 128, intermediate_size: 256, num_layers: 2, num_heads: 4, num_kv_heads: 2}\n")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        CheckpointManager(str(tmp / "codec")).save(0, {"gen_params": codec.state_dict()})
        torch.save({"generator": voc16.state_dict()}, tmp / "vocoder.pt")
        wav_rng = np.random.default_rng(6)
        with open(tmp / "train.jsonl", "w") as f:
            for i in range(8):
                dur = 3.0 + 0.25 * i
                t_w = np.arange(int(SR * dur)) / SR
                wave = 0.4 * np.sin(2 * math.pi * (180 + 35 * i) * t_w) + 0.05 * wav_rng.standard_normal(len(t_w))
                wavfile.write(tmp / f"clip{i}.wav", SR, wave.astype(np.float32))
                f.write(json.dumps({"id": f"c{i}", "audio_path": str(tmp / f"clip{i}.wav"), "duration": dur,
                                    "text": f"tone number {i}"}) + "\n")

        def train_yaml(max_steps: int) -> str:
            path_ = tmp / f"lm_{max_steps}.yaml"
            path_.write_text(
                f"codec_ckpt_dir: {tmp / 'codec'}\ntext_tokenizer_path: null\n" + small_lm +
                "train: {accumulate_grad: 2, num_warmup_steps: 1, skip_nonfinite_updates: 5}\n"
                f"fit: {{max_steps: {max_steps}, val_interval: 2, log_every: 1, ckpt_dir: {tmp / 'lm_ckpt'}, "
                f"log_dir: {tmp / 'lm_logs'}, seed: 1}}\n"
                f"data: {{train_manifest: {tmp / 'train.jsonl'}, max_duration: 16.0}}\n")
            return str(path_)

        reset_counts()
        t0 = time.perf_counter()
        train_lm.main(["--config", train_yaml(4)])  # the default device: the card
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        cli_counts = counts()
        mgr = CheckpointManager(str(tmp / "lm_ckpt"))
        assert mgr.all_steps() == [2, 4], mgr.all_steps()
        first = mgr.restore_latest_fields(None, ("params", "step", "opt_state"))
        assert first["step"] == 4 and first["opt_state"]["gradient_step"] == 2
        t0 = time.perf_counter()
        train_lm.main(["--config", train_yaml(6)])
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        second = mgr.restore_latest_fields(None, ("params", "step", "opt_state"))
        assert mgr.all_steps() == [4, 6] and second["step"] == 6 and second["opt_state"]["gradient_step"] == 3
        moved = sum(not torch.equal(first["params"][n_], p) for n_, p in second["params"].items())
        steps_logged = [json.loads(line)["step"] for line in open(tmp / "lm_logs" / "metrics.jsonl")]
        log(f"  first run {first_s:.2f} s wall to step 4 (checkpoints at 2 and 4; launches {cli_counts}), resumed run "
            f"{second_s:.2f} s to step 6 ({moved} of {len(second['params'])} tensors moved); logged steps {steps_logged}")
        assert steps_logged == [1, 2, 3, 4, 5, 6] and moved == len(second["params"])
        assert all(torch.isfinite(p).all() for p in second["params"].values())
        assert all(n_ > 0 for n_ in cli_counts.values()), cli_counts
        (tmp / "infer.yaml").write_text(
            f"lm_ckpt_dir: {tmp / 'lm_ckpt'}\ncodec_ckpt_dir: {tmp / 'codec'}\nvocoder_ckpt: {tmp / 'vocoder.pt'}\n"
            "text_tokenizer_path: null\n" + small_lm +
            "inference: {max_new_tokens: 16, max_seq_len: 256, cache_dtype: float32}\n")
        infer_lm.main(["--config", str(tmp / "infer.yaml"), "--prompt", "tone number 3", "--out", str(tmp / "out.wav"),
                       "--seed", "1"])
        wav_sr, wav = wavfile.read(tmp / "out.wav")
    log(f"  infer_lm.main on the trained checkpoint: WAV {wav.shape} at {wav_sr} Hz, rms "
        f"{float(np.sqrt(np.mean(np.square(wav)))):.4f}")
    assert wav_sr == SR and wav.dtype == np.float32 and wav.size > 0 and np.isfinite(wav).all()

    # ---- 19. FA-dKV, FA-dQ, their plain versions and the library's backward; bounds
    def bwd_bound_ms(b, s, h, kh, d, itemsize, products, outputs, rate=None):
        """Least time for one backward kernel: q, k, v, dO, L and D read once
        and its outputs written once, against `products` hd-deep products
        per visible (query, key) pair at `rate` (default: the rate of the
        inputs' type, float32 the CUDA cores'; split-TF32: PEAK_TF32 / 3)."""
        nbytes = (2 * b * s * h * d + 2 * b * s * kh * d + outputs) * itemsize + 2 * b * h * s * 4
        flops = products * 2 * d * b * h * s * (s + 1) // 2
        by_ops = flops / (rate or (PEAK_BF16 if itemsize == 2 else PEAK_F32)) * 1e3
        by_bytes = nbytes / PEAK_BYTES * 1e3
        return max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes"

    bwd_ms = {}
    for shape, dt in ((trainer_shape, torch.float32), ((LM_BATCH, LM_SEQ, heads, kv_heads, hd), torch.float32),
                      ((LM_BATCH, LM_SEQ, heads, kv_heads, hd), torch.bfloat16)):
        b, sq, h, kh, d = shape
        q, k, v, g = (torch.randn((b, sq, n, d), device=dev, generator=gen).to(dt) for n in (h, kh, kh, h))
        with torch.no_grad():
            out, lse = fa_ops._launch(q, k, v, with_lse=True)
            delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            t_dkv = [cuda_ms(lambda: fa_ops.flash_attention_dkv(q, k, v, g, lse, delta), 10)]
            t_dq = [cuda_ms(lambda: fa_ops.flash_attention_dq(q, k, v, g, lse, delta), 10)]
            t_plain_dkv = cuda_ms(lambda: fa_ops.flash_attention_dkv_reference(q, k, v, out, lse, g), 5)
            t_plain_dq = cuda_ms(lambda: fa_ops.flash_attention_dq_reference(q, k, v, out, lse, g), 5)
            t_dkv.append(cuda_ms(lambda: fa_ops.flash_attention_dkv(q, k, v, g, lse, delta), 10))
            t_dq.append(cuda_ms(lambda: fa_ops.flash_attention_dq(q, k, v, g, lse, delta), 10))
            t_delta = cuda_ms(lambda: (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous(), 10)
            t_fwd = (cuda_ms(lambda: fa_ops._launch(q, k, v, with_lse=True), 10), cuda_ms(lambda: flash_attention(q, k, v), 10))
        qt, kt, vt = (t_.transpose(1, 2).detach().requires_grad_() for t_ in (q, k, v))
        with torch.no_grad():  # the library's forward too, beside FA storing L
            t_lib_fwd = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 10)
        out_lib = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        gt = g.transpose(1, 2)
        t_lib = cuda_ms(lambda: torch.autograd.grad(out_lib, (qt, kt, vt), gt, retain_graph=True), 10)
        lib = torch.autograd.grad(out_lib, (qt, kt, vt), gt)
        ours = fa_ops.flash_attention_backward(q, k, v, out, lse, g)
        for name, a_, w_ in zip(("dq", "dk", "dv"), ours, lib):
            check_close(f"library backward vs kernels, {name} {list(shape)} {dt}", w_.transpose(1, 2), a_,
                        5e-3 if dt == torch.float32 else 2.0**-4)
        bound_dkv = bwd_bound_ms(b, sq, h, kh, d, q.element_size(), 4, 2 * b * sq * kh * d)
        pair_bound = bwd_bound_ms(b, sq, h, kh, d, q.element_size(), 5, b * sq * h * d + 2 * b * sq * kh * d)
        # FA-dQ and FA: float32 at the split-TF32 kernels' rate (three TF32
        # products), and at the CUDA cores' for comparison
        tf32x3 = PEAK_TF32 / 3 if dt == torch.float32 else None
        bound_dq = bwd_bound_ms(b, sq, h, kh, d, q.element_size(), 3, b * sq * h * d, tf32x3)
        bound_dq_cc = bwd_bound_ms(b, sq, h, kh, d, q.element_size(), 3, b * sq * h * d)
        bound_fwd = fa_bound_ms(b, sq, h, kh, d, q.element_size(), tf32x3)
        bound_fwd_cc = fa_bound_ms(b, sq, h, kh, d, q.element_size())
        cfg_dkv, cfg_dq = fa_ops.launch_config("FA-dKV", q), fa_ops.launch_config("FA-dQ", q)
        cfg_fwd = fa_ops.launch_config("FA", q)
        if dt == torch.float32:  # the split-TF32 kernels' launches, as ops/flash_attention.py states them
            for name, cfg in (("FA", cfg_fwd), ("FA-dQ", cfg_dq)):
                assert (cfg["threads"], cfg["smem_bytes"]) == (fa_ops.TF32_THREADS, fa_ops.tf32_smem_bytes(name, d)), cfg
        bwd_ms[(shape, dt)] = {"dkv": sum(t_dkv) / 2, "dq": sum(t_dq) / 2, "plain_dkv": t_plain_dkv,
                               "plain_dq": t_plain_dq, "library": t_lib, "bound_dkv": bound_dkv, "bound_dq": bound_dq,
                               "bound_dq_cuda_cores": bound_dq_cc, "bound_fwd": bound_fwd,
                               "bound_fwd_cuda_cores": bound_fwd_cc, "fwd": t_fwd[0], "library_fwd": t_lib_fwd,
                               "launch_dkv": cfg_dkv, "launch_dq": cfg_dq, "launch_fwd": cfg_fwd}
        for name, cfg in (("FA-dKV", cfg_dkv), ("FA-dQ", cfg_dq), ("FA", cfg_fwd)):
            log(f"  {[b, sq, h, d]} {dt}, {name} launch: grid {cfg['grid']} = {math.prod(cfg['grid'])} blocks, "
                f"{cfg['threads']} threads and {cfg['smem_bytes']} bytes of shared memory per block")
        log(f"  {[b, sq, h, d]} {dt}, per launch: FA-dKV {t_dkv[0]:.4f} / {t_dkv[1]:.4f} ms (plain {t_plain_dkv:.3f}, "
            f"bound {bound_dkv[0]:.4f} by {bound_dkv[1]}), FA-dQ {t_dq[0]:.4f} / {t_dq[1]:.4f} ms (plain "
            f"{t_plain_dq:.3f}, bound {bound_dq[0]:.4f} by {bound_dq[1]}"
            + (f", {bound_dq_cc[0]:.4f} at the CUDA cores' rate" if tf32x3 else "")
            + f"), D = rowsum(dO * O) {t_delta:.3f} ms, FA forward "
            f"{t_fwd[0]:.4f} ms storing L ({t_fwd[1]:.4f} without; bound {bound_fwd[0]:.4f} by {bound_fwd[1]}"
            + (f", {bound_fwd_cc[0]:.4f} at the CUDA cores' rate" if tf32x3 else "")
            + f"; scaled_dot_product_attention forward {t_lib_fwd:.4f}); "
            f"scaled_dot_product_attention backward (dq, dk, dv in one call) {t_lib:.4f} ms; bound of the pair "
            f"with the minimal 5 products {pair_bound[0]:.4f} ms")
        del q, k, v, g, out, lse, delta, qt, kt, vt, out_lib, gt, lib, ours
    main_bwd = bwd_ms[(trainer_shape, torch.float32)]
    n_bwd = launches["FA-dKV"] // TRAIN_MICRO_STEPS
    log(f"  per micro-step ({n_bwd} launches each at {list(trainer_shape[:3])} float32): FA-dKV "
        f"{n_bwd * main_bwd['dkv']:.2f} ms, FA-dQ {n_bwd * main_bwd['dq']:.2f} ms (bound "
        f"{n_bwd * main_bwd['bound_dq'][0]:.3f} at three TF32 products, {n_bwd * main_bwd['bound_dq_cuda_cores'][0]:.3f} "
        f"at the CUDA cores' rate), FA forward {n_bwd * main_bwd['fwd']:.2f} ms (bound "
        f"{n_bwd * main_bwd['bound_fwd'][0]:.3f} / {n_bwd * main_bwd['bound_fwd_cuda_cores'][0]:.3f}) of the step's "
        f"{train_stats['kernels'][0]:.2f} ms")

    # ---- 20. the probe kernels P1..P4
    log("probe kernels vs plain: P1 channels-first anti-aliased snake with a run-time window")
    errs.update({"P1": 0.0, "P2": 0.0, "P3": 0.0, "P4": 0.0})
    p1_cases = [((2, 24, 4096), (1024,), (torch.float32,))]
    # the probe's main path: its three shapes at every window it times (bfloat16); float32 at one
    p1_cases += [(shape, cf_act.WINDOWS, (torch.bfloat16,)) for shape in cf_act.SHAPES]
    p1_cases += [(shape, (2048,), (torch.float32,)) for shape in cf_act.SHAPES]
    p1_cases += [((b, c, t_len), (1, 16, 256, 1000, 4096, cf_act.MAX_WINDOW), (torch.float32, torch.bfloat16))
                 for b, c, t_len in ((1, 5, 1), (3, 7, 37), (2, 3, 700))]
    p1_cases += [((2, 96, 5000), cf_act.WINDOWS, (torch.float32, torch.bfloat16))]
    # where the warp-unit kernel branches: odd C (rows off 16-byte boundaries), T around one unit of 256
    # outputs and a 16-byte vector, tasks of one unit (w up to 256), two (257) and 64 (16384)
    p1_cases += [((2, 5, t_len), (1, 255, 256, 257, cf_act.MAX_WINDOW), (torch.float32, torch.bfloat16))
                 for t_len in (7, 8, 9, 255, 257)]
    for shape, windows, dts in p1_cases:
        c = shape[1]
        alpha = torch.exp(0.1 * torch.randn(c, device=dev, generator=gen))
        beta = torch.exp(0.1 * torch.randn(c, device=dev, generator=gen))
        inv_beta = 1.0 / (beta + 1e-9)
        x32 = torch.randn(shape, device=dev, generator=gen)
        for dt in dts:
            x = x32.to(dt)
            want = cf_act.cf_act_reference(x, alpha, inv_beta)
            for w_ in windows:
                got = cf_act.cf_act_windowed(x, alpha[None, :, None], inv_beta[None, :, None], w_)
                torch.cuda.synchronize()
                e = check_close(f"P1 {list(shape)} w = {w_} {dt}", got, want, TOL_P1[dt])
                if dt == torch.float32:
                    errs["P1"] = max(errs["P1"], e)
            del want, got
        if shape[2] > 32 and torch.float32 in dts:
            got = cf_act.cf_act_windowed(x32, alpha, inv_beta, windows[0])
            k1 = anti_alias_activation(x32, alpha, beta, False)
            check_close(f"P1 vs K1 beyond 16 samples from the ends {list(shape)} float32",
                        got[:, :, 16:-16], k1[:, :, 16:-16], TOL_P1[torch.float32])
            edge = max_err(got, k1)
            log(f"  P1 vs K1 over the whole signal: max abs difference {edge:.3e} (interior semantics: the ends differ)")
            assert edge > 1e-4
            del got, k1
        del x32
    log("probe kernels vs plain: P2 / P3 row-shifted sums, P4 tap matmul")
    for shape, out_rows in (((sublane_ops.ROWS, sublane_ops.LANES), sublane_ops.OUT_ROWS),
                            ((3, sublane_ops.ROWS, sublane_ops.LANES), sublane_ops.OUT_ROWS),
                            ((sublane_ops.FILL_PLANES, sublane_ops.ROWS, sublane_ops.LANES), sublane_ops.OUT_ROWS),
                            ((2, 50, 33), 17), ((1, 10, 1), 1), ((2, 5000, 300), 1000),
                            # where the kernel branches: rows = out_rows + 9, column counts off the float4 path
                            # and odd plane counts (planes off 16-byte boundaries), a ragged last row tile, and
                            # 4,096 planes
                            *(((3, 59, cols), 50) for cols in (1, 2, 3, 5, 300)),
                            ((3, sublane_ops.OUT_ROWS + 9, sublane_ops.LANES), sublane_ops.OUT_ROWS),
                            ((4096, sublane_ops.OUT_ROWS + 9, sublane_ops.LANES), sublane_ops.OUT_ROWS)):
        x = torch.randn(shape, device=dev, generator=gen)
        for name, fn, ref in (("P2", sublane_ops.slice_rows, sublane_ops.slice_reference),
                              ("P3", sublane_ops.roll_rows, sublane_ops.roll_reference)):
            got, want = fn(x, out_rows), ref(x, out_rows)
            torch.cuda.synchronize()
            e = max_err(got, want)
            log(f"  {name} {list(shape)} -> {out_rows} rows: max abs err {e:.3e} (expected: the same bits)")
            errs[name] = max(errs[name], e)
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: kernel disagrees with its plain version")
        if shape[-2] == sublane_ops.ROWS:  # two functions: the roll wraps to the plane's end
            apart = max_err(sublane_ops.roll_rows(x), sublane_ops.slice_rows(x))
            log(f"  P3 vs P2 {list(shape)}: max abs difference {apart:.2f}")
            assert apart > 1.0, apart
    for x_shape, w_shape, out_rows, taps, step in (
            ((sublane_ops.MM_ROWS, 96), (96, 96), sublane_ops.MM_OUT, sublane_ops.TAPS, sublane_ops.STEP),
            ((3, sublane_ops.MM_ROWS, 96), (96, 96), sublane_ops.MM_OUT, sublane_ops.TAPS, sublane_ops.STEP),
            ((sublane_ops.FILL_PLANES, sublane_ops.MM_ROWS, 96), (96, 96), sublane_ops.MM_OUT, sublane_ops.TAPS,
             sublane_ops.STEP),
            ((2, 300, 32), (32, 24), 100, 5, 3), ((1, 16, 16), (16, 8), 1, 1, 8), ((2, 700, 128), (128, 128), 130, 7, 8),
            ((sublane_ops.FILL_PLANES, sublane_ops.MM_ROWS, 192), (192, 192), sublane_ops.MM_OUT, sublane_ops.TAPS,
             sublane_ops.STEP),
            ((3, 1000, 192), (192, 192), 900, sublane_ops.TAPS, sublane_ops.STEP),
            ((2, 1200, 256), (256, 256), 1000, sublane_ops.TAPS, sublane_ops.STEP), ((2, 500, 192), (192, 192), 300, 11, 4),
            ((2, 400, 160), (160, 224), 300, 5, 16), ((2, 300, 64), (64, 32), 200, 3, 8)):
        x = torch.randn(x_shape, device=dev, generator=gen).to(torch.bfloat16)
        w_ = torch.randn(w_shape, device=dev, generator=gen).to(torch.bfloat16)
        got = sublane_ops.tap_matmul(x, w_, out_rows, taps, step)
        torch.cuda.synchronize()
        want = sublane_ops.tap_matmul_reference(x, w_, out_rows, taps, step)
        path = sublane_ops.tap_matmul_path(w_shape[0], w_shape[1], taps, step)
        e = check_close(f"P4 x {list(x_shape)} @ w {list(w_shape)}, {taps} taps of step {step} -> {out_rows} rows "
                        f"({path} kernel)", got, want, TOL_P4)
        if x_shape[-2] == sublane_ops.MM_ROWS:
            errs["P4"] = max(errs["P4"], e)
        del x, w_, got, want
    probe_fns = {"P1": cf_act.cf_act_windowed, "P2": sublane_ops.slice_rows, "P3": sublane_ops.roll_rows,
                 "P4": sublane_ops.tap_matmul}
    for fn in probe_fns.values():
        fn.launches = 0
    sublane_ops.tap_matmul.launches_by_path = dict.fromkeys(sublane_ops.tap_matmul.launches_by_path, 0)
    cf_table = cf_act.main()  # each raises if a kernel disagrees with plain at a shape it times
    rows_table = sublane_ops.main()
    launches.update({name: fn.launches for name, fn in probe_fns.items()})
    assert all(launches[name] > 0 for name in probe_fns), launches
    p4_paths = dict(sublane_ops.tap_matmul.launches_by_path)
    # the probe's main path is the flagship 11 taps of step 8 at C = 96 and 192: the wgmma kernel only
    assert p4_paths == {"wgmma": launches["P4"], "mma": 0}, p4_paths
    # the plain versions and the library call at the probes' shapes
    p1_shape, p1_window = cf_act.SHAPES[0], 2048
    fill = sublane_ops.FILL_PLANES
    with torch.no_grad():
        x = torch.randn(p1_shape, device=dev, generator=gen).to(torch.bfloat16)
        a = torch.exp(0.1 * torch.randn(p1_shape[1], device=dev, generator=gen))
        p1_plain = cuda_ms(lambda: cf_act.cf_act_reference(x, a, a), 3)
        del x
        rows_plain, mm_plain, mm_library = {}, {}, {}
        for planes in (1, fill):
            x = torch.randn((planes, sublane_ops.ROWS, sublane_ops.LANES), device=dev, generator=gen)
            rows_plain[planes] = {"slice": cuda_ms(lambda: sublane_ops.slice_reference(x), 10),
                                  "roll": cuda_ms(lambda: sublane_ops.roll_reference(x), 10)}
            for c in sublane_ops.WIDTHS:
                xb = torch.randn((planes, sublane_ops.MM_ROWS, c), device=dev, generator=gen).to(torch.bfloat16)
                w_ = torch.randn((c, c), device=dev, generator=gen).to(torch.bfloat16)
                mm_plain[planes, c] = cuda_ms(lambda: sublane_ops.tap_matmul_reference(xb, w_), 5)
                # the library call: one bf16 conv with the 11 taps all holding w, dilation 8
                x_cf = xb[:, : sublane_ops.MM_OUT + sublane_ops.STEP * (sublane_ops.TAPS - 1)].transpose(1, 2).contiguous()
                kernel = w_.T[:, :, None].expand(c, c, sublane_ops.TAPS).contiguous()

                def conv():
                    return torch.nn.functional.conv1d(x_cf, kernel, dilation=sublane_ops.STEP)

                mm_library[planes, c] = cuda_ms(conv, 10)
                check_close(f"library conv1d vs P4, P = {planes}, C = {c}", conv().transpose(1, 2),
                            sublane_ops.tap_matmul(xb, w_), 2.0**-7)  # the library rounds its result to bf16
                del xb, x_cf, kernel
            del x
    # P2's and P3's library calls, timed and held to plain by the probe's own run
    rows_library = {planes: rows_table[planes]["slice library"] for planes in (1, fill)}
    roll_library = {planes: rows_table[planes]["roll library"] for planes in (1, fill)}
    p1_bounds = {"bytes": cf_act.bound_ms(p1_shape), "operations": cf_act.ops_bound_ms(p1_shape)}
    p1_bound = max(p1_bounds.values())
    p1_floor = k1_issue["p1"]["ms"]
    mm_bound = {(planes, c): sublane_ops.tap_matmul_bound_ms(planes, c, c)
                for planes in (1, fill) for c in sublane_ops.WIDTHS}
    p1_ms = cf_table[p1_shape][p1_window]
    log(f"  P1 {list(p1_shape)} bf16 w = {p1_window}: kernel {p1_ms:.4f} ms, K1 "
        f"{cf_table[p1_shape]['K1']:.4f} ms, plain {p1_plain:.3f} ms, bound {p1_bounds['operations']:.4f} ms by "
        f"operations ({p1_bounds['bytes']:.4f} by bytes), issue floor {p1_floor:.4f} ms (its share "
        f"{p1_floor / p1_ms:.3f}, the bound's {p1_bound / p1_ms:.3f})")
    for planes in (1, fill):
        bound = sublane_ops.rows_bound_ms(planes)
        log(f"  P = {planes}: P2 {rows_table[planes]['slice']:.5f} ms a call, {rows_table[planes]['slice device']:.5f} "
            f"on the device (plain {rows_plain[planes]['slice']:.4f}, depthwise F.conv1d {rows_library[planes]:.5f}), "
            f"P3 {rows_table[planes]['roll']:.5f} a call, {rows_table[planes]['roll device']:.5f} on the device (plain "
            f"{rows_plain[planes]['roll']:.4f}, depthwise circular nn.Conv1d {roll_library[planes]:.5f}), bound "
            f"{bound:.5f} ms by bytes; device roofline share P2 {bound / rows_table[planes]['slice device']:.3f}, "
            f"P3 {bound / rows_table[planes]['roll device']:.3f}")
        for c in sublane_ops.WIDTHS:
            b_ = mm_bound[planes, c]
            log(f"  P = {planes}, C = {c}: P4 {rows_table[planes][f'matmul {c}']:.4f} ms (plain {mm_plain[planes, c]:.4f}, "
                f"F.conv1d {mm_library[planes, c]:.4f}, which writes bf16 where P4 writes float32), bound "
                f"{b_['operations']:.5f} ms by operations, {b_['bytes']:.5f} by bytes; roofline share "
                f"{max(b_.values()) / rows_table[planes][f'matmul {c}']:.3f}")
    log(f"  P2's wrapper, host us per call: {rows_table['host_us']}")
    log(f"  P4 launches by kernel in the probe's run: {p4_paths}")

    # ---- 21. codec GAN training at full width
    log(f"codec training: CodecTrainer at the flagship width, float32, B = {CODEC_TRAIN_BATCH} x {SECONDS} s")
    gc.collect()
    torch.cuda.empty_cache()

    def synthetic_clips(n: int, seconds: float, seed: int, floor: float = 0.0) -> np.ndarray:
        """Sums of four sines and a 0.1 s noise burst per clip, over white
        noise of amplitude `floor`, from a numpy seed."""
        rng_ = np.random.default_rng(seed)
        n_samples = int(seconds * SR)
        t_ = np.arange(n_samples) / SR
        clips = np.zeros((n, n_samples), np.float32)
        for i in range(n):
            for amp, freq in zip(rng_.uniform(0.05, 0.3, 4), rng_.uniform(100.0, 4000.0, 4)):
                clips[i] += (amp * np.sin(2 * math.pi * freq * t_)).astype(np.float32)
            start = rng_.integers(0, n_samples - SR // 10)
            clips[i, start : start + SR // 10] += (0.2 * rng_.standard_normal(SR // 10)).astype(np.float32)
            clips[i] += (floor * rng_.standard_normal(n_samples)).astype(np.float32)
        return clips

    def codec_batches(trainer_, n: int, batch: int, seconds: float, seed: int):
        """Device batches with given decoder noise; the last clip has half length."""
        rng_ = np.random.default_rng(seed + 1000)
        n_samples = int(seconds * SR)
        lengths = np.full((batch,), n_samples)
        lengths[-1] = n_samples // 2
        return [trainer_.device_batch({
            "audios": synthetic_clips(batch, seconds, seed + i), "audio_lengths": lengths,
            "noise": rng_.standard_normal((batch, n_samples // HOP, ccfg.concat_dim)).astype(np.float32)})
            for i in range(n)]

    held_before = torch.cuda.memory_allocated() / 2**30  # the earlier phases' models and leftovers
    ct_cfg = CodecTrainConfig(num_warmup_steps=2)
    ctrainer = CodecTrainer(DMelCodecConfig(), ct_cfg, device=dev)
    cstate = ctrainer.init_state(0)
    n_gen = sum(p.numel() for p in cstate.gen_params.values())
    n_disc = sum(p.numel() for p in cstate.disc_params.values())
    log(f"  generator {n_gen / 1e6:.1f} M parameters, discriminator {n_disc / 1e6:.1f} M; lr {ct_cfg.learning_rate:g}, "
        f"warmup {ct_cfg.num_warmup_steps}")
    assert all(p.dtype == torch.float32 and p.is_cuda for p in (*cstate.gen_params.values(), *cstate.disc_params.values()))
    state_gib = 3 * 4 * (n_gen + n_disc) / 2**30  # float32 parameters and AdamW's two moments
    log(f"  device memory allocated: {held_before:.2f} GiB before the trainer was built, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after")
    cbatches = codec_batches(ctrainer, 2, CODEC_TRAIN_BATCH, SECONDS, seed=7)
    metric_names = ("train/grad_norm/generator", "train/grad_norm/discriminator", "train/discriminator/loss",
                    "train/discriminator/loss_real", "train/discriminator/loss_fake", "train/generator/loss",
                    "train/generator/loss_mel", "train/generator/loss_adv", "train/lr")

    def changed(state_, snap) -> dict:
        return {which: sum(not torch.equal(snap[which][n_], p) for n_, p in getattr(state_, which).items())
                for which in ("gen_params", "disc_params")}

    def snapshot(state_) -> dict:
        return {which: {n_: p.detach().clone() for n_, p in getattr(state_, which).items()}
                for which in ("gen_params", "disc_params")}

    def checked_steps(trainer_, state_, what: str):
        history = []
        snap = snapshot(state_)
        for i in range(4):
            state_, metrics = trainer_.train_step(state_, cbatches[i % 2])
            torch.cuda.synchronize()
            vals = {k_: float(v_) for k_, v_ in metrics.items()}
            assert set(vals) == set(metric_names) and all(math.isfinite(x_) for x_ in vals.values()), vals
            moved_ = changed(state_, snap)
            log(f"  {what} step {i + 1}: D loss {vals['train/discriminator/loss']:.6f} (real "
                f"{vals['train/discriminator/loss_real']:.6f}, fake {vals['train/discriminator/loss_fake']:.6f}), G loss "
                f"{vals['train/generator/loss']:.6f} (mel {vals['train/generator/loss_mel']:.6f}, adv "
                f"{vals['train/generator/loss_adv']:.6f}), grad norms G {vals['train/grad_norm/generator']:.4f} D "
                f"{vals['train/grad_norm/discriminator']:.4f}, lr {vals['train/lr']:.2e}; tensors moved so far: "
                f"generator {moved_['gen_params']} of {len(state_.gen_params)}, discriminator "
                f"{moved_['disc_params']} of {len(state_.disc_params)}")
            history.append((vals, moved_))
        return state_, history

    cstate, first_run = checked_steps(ctrainer, cstate, "run 1")
    # the first update has lr 0 (LambdaLR semantics): nothing moves; from the second on, both networks do
    assert first_run[0][1] == {"gen_params": 0, "disc_params": 0}, first_run[0][1]
    assert first_run[1][1] == {"gen_params": len(cstate.gen_params), "disc_params": len(cstate.disc_params)}
    assert cstate.step == 4 and cstate.gen_opt_state.gradient_step == 4 and cstate.disc_opt_state.gradient_step == 4
    assert all(p.grad is None for p in (*ctrainer.codec.parameters(), *ctrainer.discriminator.parameters()))
    cstate = ctrainer.init_state(0)  # the same weights again, fresh optimizers
    cstate, second_run = checked_steps(ctrainer, cstate, "run 2")
    worst_rerun = 0.0
    for (a_, _), (b_, _) in zip(first_run, second_run):
        for k_ in metric_names[2:8]:
            worst_rerun = max(worst_rerun, abs(a_[k_] - b_[k_]) / max(abs(a_[k_]), 1e-12))
    log(f"  a second run from the same state, batches and noise: the six losses of 4 steps agree to "
        f"{worst_rerun:.3e} relative (tol {TOL_RERUN:.0e})")
    assert worst_rerun <= TOL_RERUN

    def time_codec_steps(trainer_, state_, batches_, what: str, n: int = 6):
        """ms per step (CUDA events around each of n steps, the mean of all
        but the first), the run's peak device memory, seconds of audio per second."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        between = torch.cuda.memory_allocated() / 2**30
        events = []
        for i in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            trainer_.train_step(state_, batches_[i % len(batches_)])
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        times = [s_.elapsed_time(e_) for s_, e_ in events]
        step_ms = sum(times[1:]) / (n - 1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        audio_s = batches_[0]["audios"].shape[0] * batches_[0]["audios"].shape[1] / SR
        log(f"  {what}: {step_ms:.2f} ms per step ({', '.join(f'{t_:.2f}' for t_ in times)}; the first not counted), "
            f"{audio_s / step_ms * 1e3:.1f} s of audio per second, peak device memory {peak:.2f} GiB = {between:.2f} GiB "
            f"allocated between steps ({state_gib:.2f} GiB of it the trainer's parameters and Adam moments, the rest "
            f"batches and what earlier phases left) + {peak - between:.2f} GiB during the step: the trainer's own peak is "
            f"{state_gib + peak - between:.2f} GiB")
        return step_ms, peak, audio_s / step_ms * 1e3

    codec_stats = {}
    codec_stats["float32"] = time_codec_steps(ctrainer, cstate, cbatches, f"{CODEC_TRAIN_BATCH} x {SECONDS} s, float32 (TF32 off)")
    # the step by kernel and part by part (the trainer's codec.train.* spans)
    parts = profile_once("one codec train step, float32", lambda: ctrainer.train_step(cstate, cbatches[1]), parts="codec.train.")
    # the preamble's few kernels come first, where the device tracing has at times recorded no range
    if "preamble" not in parts:
        log("  one codec train step by part: no range was recorded on the device for the preamble in this run")
    assert len(parts) - ("preamble" in parts) == 7 and abs(sum(parts.values()) / codec_stats["float32"][0] - 1) < 0.15, parts
    # PyTorch's default: cuDNN convs in TF32 (the float32 matmuls stay float32)
    torch.backends.cudnn.allow_tf32 = True
    codec_stats["tf32 convs"] = time_codec_steps(ctrainer, cstate, cbatches,
                                                 f"{CODEC_TRAIN_BATCH} x {SECONDS} s, cuDNN convs in TF32 (PyTorch's default)")
    strict_float32()
    assert all(torch.isfinite(p).all() for p in (*cstate.gen_params.values(), *cstate.disc_params.values()))

    # the flagship's batch of 210 s of audio: 52 clips x 4 s
    big = None
    try:
        big_batches = codec_batches(ctrainer, 1, CODEC_TRAIN_BIG_BATCH, SECONDS, seed=9)
        big = time_codec_steps(ctrainer, cstate, big_batches,
                               f"{CODEC_TRAIN_BIG_BATCH} x {SECONDS} s (the flagship's 210 s batch), float32", n=3)
        codec_stats["float32, 52 x 4 s"] = big
    except torch.cuda.OutOfMemoryError as exc:
        log(f"  {CODEC_TRAIN_BIG_BATCH} x {SECONDS} s, float32: out of device memory ({str(exc)[:200]})")
    big_batches = None
    del cstate, ctrainer
    gc.collect()
    torch.cuda.empty_cache()

    # freeze_encoder: the encoder and the quantizer stay bit-unchanged, the rest trains
    ftrainer = CodecTrainer(DMelCodecConfig(), dataclasses.replace(ct_cfg, freeze_encoder=True), device=dev)
    fstate = ftrainer.init_state(0)
    fsnap = snapshot(fstate)
    for i in range(3):
        fstate, fmetrics = ftrainer.train_step(fstate, cbatches[i % 2])
    torch.cuda.synchronize()
    frozen = [n_ for n_ in fstate.gen_params if n_.startswith(("encoder.", "quantizer."))]
    frozen_moved = sum(not torch.equal(fsnap["gen_params"][n_], fstate.gen_params[n_]) for n_ in frozen)
    rest_moved = sum(not torch.equal(fsnap["gen_params"][n_], p) for n_, p in fstate.gen_params.items() if n_ not in frozen)
    log(f"  freeze_encoder=True, 3 steps: {frozen_moved} of {len(frozen)} encoder / quantizer tensors changed, "
        f"{rest_moved} of {len(fstate.gen_params) - len(frozen)} others; logged generator grad norm "
        f"{float(fmetrics['train/grad_norm/generator']):.4f} (over all subtrees)")
    assert frozen and frozen_moved == 0 and rest_moved == len(fstate.gen_params) - len(frozen)
    assert len(fstate.gen_opt_state.params) == len(fstate.gen_params) - len(frozen)
    del fstate, ftrainer, fsnap, cbatches
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 22. codec training through the entry point
    log("codec training through the entry point: train_codec.main on 8 synthetic WAVs at the flagship width")
    all_counters = {**counters, **counters_fa}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        clips = synthetic_clips(8, 4.75, seed=12)
        with open(tmp / "train.jsonl", "w") as f:
            for i in range(8):
                dur = 3.0 + 0.25 * i
                wavfile.write(tmp / f"clip{i}.wav", SR, clips[i, : int(SR * dur)])
                f.write(json.dumps({"id": f"c{i}", "audio_path": str(tmp / f"clip{i}.wav"), "duration": dur,
                                    "text": ""}) + "\n")

        def codec_yaml(max_steps: int) -> str:
            path_ = tmp / f"codec_{max_steps}.yaml"
            path_.write_text(
                "train: {learning_rate: 1.0e-4, num_warmup_steps: 1}\n"
                f"fit: {{max_steps: {max_steps}, val_interval: 2, log_every: 1, ckpt_dir: {tmp / 'codec_ckpt'}, "
                f"log_dir: {tmp / 'codec_logs'}, seed: 1}}\n"
                f"data: {{train_manifest: {tmp / 'train.jsonl'}, val_manifest: {tmp / 'train.jsonl'}, "
                "max_duration: 16.0}\n")
            return str(path_)

        t0 = time.perf_counter()
        train_codec.main(["--config", codec_yaml(4)])  # the default device: the card; `model:` absent = the flagship
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        mgr = CheckpointManager(str(tmp / "codec_ckpt"))
        fields = ("step", "gen_params", "disc_params", "gen_opt_state", "disc_opt_state")
        assert mgr.all_steps() == [2, 4], mgr.all_steps()
        first = mgr.restore_latest_fields(None, fields)
        assert first["step"] == 4 and first["gen_opt_state"]["gradient_step"] == 4
        assert sum(v.numel() for v in first["gen_params"].values()) == n_gen
        t0 = time.perf_counter()
        train_codec.main(["--config", codec_yaml(6)])
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        second = mgr.restore_latest_fields(None, fields)
        assert mgr.all_steps() == [4, 6] and second["step"] == 6 and second["disc_opt_state"]["gradient_step"] == 6
        moved = {which: sum(not torch.equal(first[which][n_], p) for n_, p in second[which].items())
                 for which in ("gen_params", "disc_params")}
        records = [json.loads(line) for line in open(tmp / "codec_logs" / "metrics.jsonl")]
        val_losses = {r["step"]: r["val_loss"] for r in records if "val_loss" in r}
        log(f"  first run {first_s:.2f} s wall to step 4 (checkpoints at 2 and 4), resumed run {second_s:.2f} s to step 6 "
            f"({moved['gen_params']} of {len(second['gen_params'])} generator and {moved['disc_params']} of "
            f"{len(second['disc_params'])} discriminator tensors moved); val_loss by step {val_losses}")
        assert [r["step"] for r in records if "train/lr" in r] == [1, 2, 3, 4, 5, 6] and sorted(val_losses) == [2, 4, 6]
        assert moved == {"gen_params": len(second["gen_params"]), "disc_params": len(second["disc_params"])}
        assert all(torch.isfinite(p).all() and p.dtype == torch.float32 for p in second["gen_params"].values())
        assert all(math.isfinite(v) for v in val_losses.values())
        # the serving path loads the generator it wrote
        wavfile.write(tmp / "in.wav", SR, tone[: CLI_SECONDS * SR].cpu().numpy())
        for fn in all_counters.values():
            fn.launches = 0
        stream_codec.main(["--in", str(tmp / "in.wav"), "--tokens-out", str(tmp / "tokens.npy"),
                           "--out", str(tmp / "out.wav"), "--codec-ckpt", str(tmp / "codec_ckpt"), "--use-v1"])
        torch.cuda.synchronize()
        served = {name: fn.launches for name, fn in all_counters.items()}
        tokens = np.load(tmp / "tokens.npy")
        wav_sr, wav = wavfile.read(tmp / "out.wav")
    log(f"  stream_codec.main on the trained checkpoint: tokens {list(tokens.shape)}, WAV {wav.shape} at {wav_sr} Hz, rms "
        f"{float(np.sqrt(np.mean(np.square(wav)))):.4f}; launches {served}")
    assert tokens.shape == (1, ccfg.dmel_groups * ccfg.n_codebooks, frames_cli // 4)
    assert wav_sr == SR and wav.shape == (frames_cli * HOP,) and np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    assert served == {**cli_counts_stream, "FA": 0, "FA-dKV": 0, "FA-dQ": 0}, (served, cli_counts_stream)
    del first, second

    # ---- 23. overfit one fixed batch
    # The clips lie over a white-noise floor so that every mel band is
    # occupied and the training quality scalar is 1.0: val_loss is taken at
    # the fixed quality 2.0, and on clips with empty bands (quality -5.7) it
    # does not follow the training loss at all.
    log(f"overfit: one fixed batch of 4 x 2 s at the flagship width, lr {OVERFIT_LR:g}, up to {OVERFIT_STEPS} steps or "
        f"{OVERFIT_SECONDS:.0f} s; val_loss = masked mel L1 at quality 2.0 with fixed noise")
    otrainer = CodecTrainer(DMelCodecConfig(), CodecTrainConfig(learning_rate=OVERFIT_LR, num_warmup_steps=20), device=dev)
    ostate = otrainer.init_state(0)
    obatch = otrainer.device_batch({"audios": synthetic_clips(4, 2.0, seed=13, floor=0.003),
                                    "audio_lengths": np.array([2 * SR, 2 * SR, 2 * SR, SR])})
    ogen = torch.Generator(device=dev).manual_seed(0)

    def val_loss() -> float:
        return float(otrainer.eval_step(ostate, obatch, torch.Generator(device=dev).manual_seed(1))["val_loss"])

    curve = {0: val_loss()}
    t0 = time.perf_counter()
    while ostate.step < OVERFIT_STEPS and time.perf_counter() - t0 < OVERFIT_SECONDS:
        ostate, ometrics = otrainer.train_step(ostate, obatch, ogen)
        if ostate.step % 50 == 0:
            curve[ostate.step] = val_loss()
            log(f"  step {ostate.step}: val_loss {curve[ostate.step]:.4f}, train mel loss "
                f"{float(ometrics['train/generator/loss_mel']):.4f}, D loss {float(ometrics['train/discriminator/loss']):.4f} "
                f"({time.perf_counter() - t0:.1f} s)")
    overfit_steps, overfit_s = ostate.step, time.perf_counter() - t0
    curve[overfit_steps] = val_loss()
    best = min(v for step_, v in curve.items() if step_ > 0)
    log(f"  val_loss {curve[0]:.4f} -> {curve[overfit_steps]:.4f} after {overfit_steps} steps in {overfit_s:.1f} s, lowest "
        f"reading {best:.4f} (the lowest must fall below {OVERFIT_FRACTION:g} of the start, the last below the start: "
        f"the adversarial term makes single readings jump)")
    assert overfit_steps >= 100, overfit_steps
    assert best < OVERFIT_FRACTION * curve[0] and curve[overfit_steps] < curve[0], curve
    del otrainer, ostate
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 24. evaluation
    evaluation = evaluation_phase(dev)

    # ---- 25. the host path: preprocess, the native decode, convert, data-parallel training
    host_path = host_path_phase(dev, smi)

    # ---- 26. the rest of the parallel layer: TP / FSDP step, TP = 2 head layout, GPipe, time-sharded codec
    parallel = parallel_phase(dev, smi, flash_cfg, train_cfg, parallel_batches, plain_losses, train_stats["kernels"],
                              counters_fa)
    del parallel_batches

    # ---- 27. the public modules beside the main path: FireflyGAN, the WaveNet diffusion pathway, Snake, resamplers
    public_modules = public_modules_phase(dev, smi)

    kernels = [
        {"name": "anti_alias_activation (K1)", "route": "cuda", "source": K1_SOURCE,
         "replaces": "dmel_codec_tpu/ops/anti_alias.py:521", "launches": launches["K1"],
         "max_abs_err": errs["K1"], "ms": ms["K1"], "plain_ms": plain_ms["K1"],
         "bound_ms": bounds["K1"][0], "bound_by": bounds["K1"][1], "library_ms": None,
         "per": f"codec request ({want_k1} launches)", "eval_launches": evaluation["cli"]["launches"]["K1"],
         "window_ms": win_ms["K1"], "window_plain_ms": win_plain_ms["K1"],
         "issue_floor_ms": k1_issue["request_ms"], "issue_floor_window_ms": k1_issue["window_ms"],
         "issue_per_output": k1_issue["per_output"], "sin_replica_mismatches": k1_sin_bad,
         "design": "a warp per unit of 256 outputs of a row (8 a lane) in a grid-stride loop, 4 blocks of 256 "
                   "threads an SM; 16-byte loads (the next unit's while this one computes) and stores on the row's "
                   "aligned body; up FIRs, snakes and down FIR from register windows with neighbours' values by "
                   "shuffles; sinf's reduction and polynomials without its float<->int conversions; the parent's bits",
         "launch": k1_launch},
        {"name": "amp_stage act->conv (K2)", "route": "cuda", "source": K2_TC_SOURCE,
         "replaces": "dmel_codec_tpu/ops/stage_fused.py:806", "launches": launches["K2"],
         "max_abs_err": errs["K2 bf16"], "ms": ms["K2"], "plain_ms": plain_ms["K2"],
         "bound_ms": bounds["K2"][0], "bound_by": bounds["K2"][1], "library_ms": None,
         "per": f"codec request ({want_k2} launches)",
         "window_ms": win_ms["K2"], "window_plain_ms": win_plain_ms["K2"],
         "kernels": [
             {"name": "act_conv_tc_kernel", "dtype": "bfloat16", "route": "cuda", "source": K2_TC_SOURCE,
              "launches": k2_by_kernel["act_conv_tc_kernel"], "launches_in": "the main path's 3 codec requests",
              "ms": ms["K2"], "window_ms": win_ms["K2"], "max_abs_err": errs["K2 bf16"],
              "launch_max_rel_err": errs["K2 launch"],
              "parts_ms": {"request": parts_ms["K2 bf16 request"], "window": parts_ms["K2 bf16 window"]},
              "design": "wgmma m64nNk16 on a bf16 activation tile in the no-swizzle K-major layout (taps as "
                        "descriptor offsets), weights streamed by TMA bulk copies through an mbarrier ring, "
                        "16 warps: a warp per input channel for the activation, 4 warpgroups for the products"}],
         "v1_mode": "route K2/v1 (use_v2=False at C > 48): plane_bf16 = 0, float32 planes, taps and v; "
                    "held against stage_reference_v1 at s2 and s3", "v1_mode_max_abs_err": errs["K2/v1"]},
        {"name": "amp_stage act->conv float32 (K2, split-TF32)", "route": "cuda", "source": K2_TF32_SOURCE,
         "replaces": "dmel_codec_tpu/ops/stage_fused.py:806", "kernel": "act_conv_tf32_kernel", "dtype": "float32",
         "launches": float32_request["launches"]["act_conv_tf32_kernel"], "max_abs_err": errs["K2"],
         "eval_launches": evaluation["cli"]["launches"]["act_conv_tf32_kernel"],
         "ms": ms["K2 float32"], "plain_ms": plain_ms["K2 float32"],
         "bound_ms": bounds["K2 float32"][0], "bound_by": bounds["K2 float32"][1], "library_ms": None,
         "per": f"float32 codec request ({want_k2} launches); launches: phase 6's float32 codec request",
         "bound_rate": "three TF32 products at PEAK_TF32", "bound_ms_tf32x3": max(k2_tf32_bound.values()),
         "bound_ms_cuda_cores": max(k2_f32_bound.values()),
         "window_ms": parts_ms["K2 float32 window"]["full"], "window_bound_ms_tf32x3": max(k2_tf32_win_bound.values()),
         "parts_ms": {"request": parts_ms["K2 float32 request"], "window": parts_ms["K2 float32 window"]},
         "v1_mode_max_abs_err": errs["K2/v1"], "float32_request": float32_request,
         "design": "act_conv_tc_kernel's block with a float32 activation tile ([KS / 4][rows][4]); the conv as "
                   "A_hi B_hi + A_hi B_lo + A_lo B_hi on wgmma m64nNk8 .tf32 (A's fragments loaded from shared "
                   "memory and split in registers, B split by the wrapper and streamed per (tap, K chunk) slot of "
                   "hi and lo by TMA), each slot's products into a fresh accumulator added to float32 sums"},
        {"name": "flash_attention (FA)", "route": "cuda", "source": FA_SOURCE,
         "replaces": "dmel_codec_tpu/models/transformer.py:197", "launches": launches["FA"],
         "max_abs_err": errs["FA"], "ms": ms["FA"], "plain_ms": plain_ms["FA"],
         "bound_ms": n_fa * fa_bound, "bound_by": fa_by, "library_ms": library_fa,
         "per": f"LM forward ({n_fa} launches)", "train_launches": launches["FA train"],
         "train_ms": n_bwd * main_bwd["fwd"], "train_library_ms": n_bwd * main_bwd["library_fwd"],
         "train_kernel": "flash_attention_tf32_kernel",
         "train_bound_ms": {"tf32x3": n_bwd * main_bwd["bound_fwd"][0],
                            "cuda_cores": n_bwd * main_bwd["bound_fwd_cuda_cores"][0]},
         "train_per": f"LM train micro-step, {list(trainer_shape)} float32, storing L ({n_bwd} launches)",
         "design": "bf16: mma.sync.m16n8k16 (float32 sums), a warp per 16 query rows with Q fragments in registers, "
                   "K/V tiles of 64 keys double-buffered by cp.async, online softmax in registers, P rounded to bf16 "
                   "before P V (as jax's kernel); float32 (flash_attention_tf32_kernel): the same layout with both "
                   "products split-TF32 on mma.sync.m16n8k8 .tf32 (A_lo B_hi + A_hi B_lo + A_hi B_hi), Q float32 "
                   "in shared memory split per k-step, each K / V tile split once into hi and lo tiles, P float32 "
                   "(split, not rounded) taken from the score fragments with each 8 keys in the order "
                   "0,2,4,6,1,3,5,7, each key tile's P V in a fresh accumulator added to O in float32",
         "launch": {k_: list(v_) if isinstance(v_, tuple) else v_ for k_, v_ in fa_launch.items()}},
        {"name": "flash_attention_dkv (FA-dKV)", "route": "cuda", "source": FA_BWD_SOURCE,
         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121 (_flash_attention_bwd_dkv), reached "
                     "under jax.grad from dmel_codec_tpu/models/transformer.py:197",
         "launches": launches["FA-dKV"], "max_abs_err": errs["FA-dKV"], "ms": n_bwd * main_bwd["dkv"],
         "design": "one block per (batch, query head, 64 keys); each writes float32 partials and the last block of "
                   "its group (one atomic count per key tile) sums the g heads in head order: deterministic; bf16: "
                   "the four products on mma.sync.m16n8k16, P^T and dS^T rounded to bf16 (as jax's kernel); "
                   "float32: CUDA-core FMA",
         "launch": {k_: list(v_) if isinstance(v_, tuple) else v_ for k_, v_ in main_bwd["launch_dkv"].items()},
         "bf16_2048_ms": bwd_ms[((LM_BATCH, LM_SEQ, heads, kv_heads, hd), torch.bfloat16)]["dkv"],
         "plain_ms": n_bwd * main_bwd["plain_dkv"], "bound_ms": n_bwd * main_bwd["bound_dkv"][0],
         "bound_by": main_bwd["bound_dkv"][1], "library_ms": n_bwd * main_bwd["library"],
         "library_is": "scaled_dot_product_attention backward: dq, dk and dv in one call",
         "per": f"LM train micro-step, {list(trainer_shape)} float32 ({n_bwd} launches); launches: "
                f"{TRAIN_MICRO_STEPS} micro-steps"},
        {"name": "flash_attention_dq (FA-dQ)", "route": "cuda", "source": FA_BWD_SOURCE,
         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1456 (_flash_attention_bwd_dq), reached "
                     "under jax.grad from dmel_codec_tpu/models/transformer.py:197",
         "launches": launches["FA-dQ"], "max_abs_err": errs["FA-dQ"], "ms": n_bwd * main_bwd["dq"],
         "kernel": "dq_tf32_kernel (float32), dq_mma_kernel (bf16)",
         "design": "bf16: S, dP and dQ += dS K on mma.sync.m16n8k16, a warp per 16 query rows, Q and dO staged once, "
                   "K/V double-buffered by cp.async, scale dS rounded to bf16 before dS K (as jax's kernel), K as "
                   "ldmatrix.trans B operand; float32 (dq_tf32_kernel): the same layout with the three products "
                   "split-TF32 on mma.sync.m16n8k8 .tf32, Q and dO float32 in shared memory split per k-step, each "
                   "K / V tile split once into hi and lo tiles, P and dS float32, dS's score fragments as dS K's A "
                   "operand with each 8 keys in the order 0,2,4,6,1,3,5,7, each key tile's dS K in a fresh "
                   "accumulator added to dQ in float32",
         "launch": {k_: list(v_) if isinstance(v_, tuple) else v_ for k_, v_ in main_bwd["launch_dq"].items()},
         "bf16_2048_ms": bwd_ms[((LM_BATCH, LM_SEQ, heads, kv_heads, hd), torch.bfloat16)]["dq"],
         "bf16_2048_bound_ms": bwd_ms[((LM_BATCH, LM_SEQ, heads, kv_heads, hd), torch.bfloat16)]["bound_dq"][0],
         "bf16_2048_library_ms": bwd_ms[((LM_BATCH, LM_SEQ, heads, kv_heads, hd), torch.bfloat16)]["library"],
         "plain_ms": n_bwd * main_bwd["plain_dq"], "bound_ms": n_bwd * main_bwd["bound_dq"][0],
         "bound_by": main_bwd["bound_dq"][1], "library_ms": n_bwd * main_bwd["library"],
         "bound_rate": "three TF32 products at PEAK_TF32",
         "train_bound_ms": {"tf32x3": n_bwd * main_bwd["bound_dq"][0],
                            "cuda_cores": n_bwd * main_bwd["bound_dq_cuda_cores"][0]},
         "library_is": "scaled_dot_product_attention backward: dq, dk and dv in one call",
         "per": f"LM train micro-step, {list(trainer_shape)} float32 ({n_bwd} launches); launches: "
                f"{TRAIN_MICRO_STEPS} micro-steps"},
        {"name": "amp_stage_v1 whole stage (K2-v1)", "route": "cuda", "source": V1_SOURCE,
         "replaces": "dmel_codec_tpu/ops/stage_fused.py:984", "launches": launches["K2-v1"],
         "max_abs_err": errs["K2-v1"], "ms": ms["K2-v1"], "plain_ms": plain_ms["K2-v1"],
         "bound_ms": bounds["K2-v1"][0], "bound_by": bounds["K2-v1"][1], "library_ms": None,
         "per": f"s{s4} + s{s5} of one streaming window, B = 1 x {VOCODE_CHUNK + 2 * VOCODE_HALO} frames "
                f"(2 launches); launches: the {LONG_MINUTES}-minute chunked_vocode with use_v2=False",
         "k2_same_ms": v1_window["K2"], "k2_v1_mode_same_ms": v1_window["K2 v1 mode"],
         "request_ms": v1_request["K2-v1"], "request_k2_same_ms": v1_request["K2"],
         "request_k2_v1_mode_same_ms": v1_request["K2 v1 mode"], "max_abs_err_bf16": errs["K2-v1 bf16"],
         "parts_ms": {k_: v_ for k_, v_ in parts_ms.items() if k_.startswith("K2-v1 bf16")},
         "launch": {k_: {kk: list(vv) if isinstance(vv, tuple) else vv for kk, vv in v_.items()}
                    for k_, v_ in v1_launch.items()},
         "design": "bf16: a cluster of 8 CTAs of 512 threads owns 8 adjacent tiles (W = 256 columns at C = 48, 512 "
                   "at C <= 32) and pulls its neighbours' edge columns through distributed shared memory after each "
                   "of the 36 operations; convs on wgmma m64nNk16 over a bf16 plane in the no-swizzle K-major "
                   "layout (taps as descriptor offsets), each conv's weights by one bulk copy",
         "request_plain_ms": v1_request["plain"], "request_bound_ms": max(v1_request_bound.values())},
        {"name": "amp_stage_v1 whole stage float32 (K2-v1, split-TF32)", "route": "cuda", "source": V1_SOURCE,
         "replaces": "dmel_codec_tpu/ops/stage_fused.py:984", "kernel": "stage_v1_tf32_kernel", "dtype": "float32",
         "launches": launches["K2-v1 float32"], "max_abs_err": errs["K2-v1"],
         "ms": v1_times[("window", "float32")]["K2-v1"], "plain_ms": v1_times[("window", "float32")]["plain"],
         "bound_ms": bounds["K2-v1 float32"][0], "bound_by": bounds["K2-v1 float32"][1], "library_ms": None,
         "per": f"s{s4} + s{s5} of one streaming window, B = 1 x {VOCODE_CHUNK + 2 * VOCODE_HALO} frames "
                f"(2 launches); launches: the {LONG_MINUTES}-minute float32 chunked_vocode with use_v2=False",
         "bound_rate": "three TF32 products at PEAK_TF32", "bound_ms_tf32x3": max(v1_tf32_bound.values()),
         "bound_ms_cuda_cores": max(v1_f32_bound.values()),
         "k2_same_ms": v1_times[("window", "float32")]["K2"],
         "k2_v1_mode_same_ms": v1_times[("window", "float32")]["K2 v1 mode"],
         "request_ms": v1_times[("request", "float32")]["K2-v1"],
         "request_plain_ms": v1_times[("request", "float32")]["plain"],
         "request_bound_ms_tf32x3": max(v1_tf32_request_bound.values()),
         "parts_ms": {k_: v_ for k_, v_ in parts_ms.items() if k_.startswith("K2-v1 float32")},
         "streaming_float32": {f"use_v2={k_[1]}": {kk: v_[kk] for kk in ("seconds", "xrt", "peak")}
                               for k_, v_ in stream_stats.items() if k_[0] == "float32"},
         "design": "the bf16 kernel's cluster design (8 CTAs, DSMEM halos) with a float32 conv plane and split-TF32 "
                   "products on wgmma m64nNk8 (A split in registers), the weights' hi and lo streamed tap by tap "
                   "through 2-4 TMA slots, each tap's products into a fresh accumulator added to float32 sums"},
        {"name": "run_variant (K1 ablation probe)", "route": "cuda", "source": K1_SOURCE,
         "replaces": "scripts/exp_act_variants.py:173", "launches": launches["probe"],
         "max_abs_err": errs["probe"], "ms": sum(probe_table[probe_shape].values()),
         "plain_ms": sum(probe_plain.values()),
         "bound_ms": bounds["probe"][0], "bound_by": bounds["probe"][1], "library_ms": None,
         "per": f"the four variants once each at {list(probe_shape)} bf16",
         "variants_ms": {str(list(sh)): row for sh, row in probe_table.items()}},
        {"name": "cf_act_windowed (P1)", "route": "cuda", "source": PROBES_SOURCE,
         "replaces": "scripts/exp_cf_act.py:181", "launches": launches["P1"], "max_abs_err": errs["P1"],
         "ms": p1_ms, "plain_ms": p1_plain, "bound_ms": p1_bound, "bound_by": max(p1_bounds, key=p1_bounds.get),
         "library_ms": None, "per": f"one launch at {list(p1_shape)} bf16, w = {p1_window}; launches: one run of the probe",
         "bytes_bound_ms": p1_bounds["bytes"], "issue_floor_ms": p1_floor, "k1_same_ms": cf_table[p1_shape]["K1"],
         "windows_ms": {str(list(sh)): {str(k_): v_ for k_, v_ in row.items()} for sh, row in cf_table.items()}},
        {"name": "slice_rows (P2)", "route": "cuda", "source": PROBES_SOURCE,
         "replaces": "scripts/exp_sublane_ops.py:63 (k_slice)", "launches": launches["P2"], "max_abs_err": errs["P2"],
         "ms": rows_table[1]["slice"], "plain_ms": rows_plain[1]["slice"], "bound_ms": sublane_ops.rows_bound_ms(1),
         "bound_by": "bytes", "library_ms": rows_library[1],
         "library_is": "F.conv1d, float32, depthwise over the 96 columns, taps 1 at offsets 0, 1, 3, 5, 7, 9 and 0 "
                       "elsewhere, on the 121 rows P2 reads", "fill_library_ms": rows_library[fill],
         "per": f"one launch on one [{sublane_ops.ROWS}, {sublane_ops.LANES}] float32 plane; launches: one run of the probe",
         "fill_planes": fill, "fill_ms": rows_table[fill]["slice"], "fill_plain_ms": rows_plain[fill]["slice"],
         "fill_bound_ms": sublane_ops.rows_bound_ms(fill), "device_ms": rows_table[1]["slice device"],
         "fill_device_ms": rows_table[fill]["slice device"], "host_us": rows_table["host_us"],
         "ms_is": "per wrapper call (CUDA events around back-to-back calls); device_ms: per launch of 20 in a CUDA "
                  "graph over 5 rotated input sets"},
        {"name": "roll_rows (P3)", "route": "cuda", "source": PROBES_SOURCE,
         "replaces": "scripts/exp_sublane_ops.py:63 (k_roll)", "launches": launches["P3"], "max_abs_err": errs["P3"],
         "ms": rows_table[1]["roll"], "plain_ms": rows_plain[1]["roll"], "bound_ms": sublane_ops.rows_bound_ms(1),
         "bound_by": "bytes", "library_ms": roll_library[1],
         "library_is": "nn.Conv1d(96, 96, 10, groups=96, padding=9, padding_mode='circular', bias=False), float32, "
                       "taps 1 at 9 - offset for offsets 0, 1, 3, 5, 7, 9 and 0 elsewhere, on the channels-first "
                       "plane; P3's 112 rows a view of its output", "fill_library_ms": roll_library[fill],
         "per": f"one launch on one [{sublane_ops.ROWS}, {sublane_ops.LANES}] float32 plane; launches: one run of the probe",
         "fill_planes": fill, "fill_ms": rows_table[fill]["roll"], "fill_plain_ms": rows_plain[fill]["roll"],
         "fill_bound_ms": sublane_ops.rows_bound_ms(fill), "device_ms": rows_table[1]["roll device"],
         "fill_device_ms": rows_table[fill]["roll device"]},
        {"name": "tap_matmul (P4)", "route": "cuda", "source": PROBES_SOURCE,
         "replaces": "scripts/exp_sublane_ops.py:80", "launches": launches["P4"], "max_abs_err": errs["P4"],
         "ms": rows_table[1]["matmul 96"], "plain_ms": mm_plain[1, 96], "bound_ms": max(mm_bound[1, 96].values()),
         "bound_by": max(mm_bound[1, 96], key=mm_bound[1, 96].get), "library_ms": mm_library[1, 96],
         "library_is": "F.conv1d, bf16, 11 taps all holding w, dilation 8 (writes bf16; P4 writes float32)",
         "per": f"one launch, x [{sublane_ops.MM_ROWS}, 96] @ w [96, 96], {sublane_ops.TAPS} taps, bf16; launches: one "
                f"run of the probe",
         "launches_by_kernel": p4_paths,
         "design": "shapes with K, N multiples of 32 and step a multiple of 8 (the probe's): TMA-staged 64-byte-"
                   "swizzled column blocks in an mbarrier ring fed by a producer warp, 128-row x N tiles on two "
                   "consumer warpgroups with wgmma.mma_async m64nNk16, taps as descriptor offsets, persistent blocks, "
                   "16-byte float32 stores; other shapes: the mma.sync kernel",
         "fill_planes": fill, "fill_ms": rows_table[fill]["matmul 96"], "fill_plain_ms": mm_plain[fill, 96],
         "fill_bound_ms": max(mm_bound[fill, 96].values()), "fill_library_ms": mm_library[fill, 96],
         "wide": {"C": 192, "ms": rows_table[1]["matmul 192"], "fill_ms": rows_table[fill]["matmul 192"],
                  "fill_plain_ms": mm_plain[fill, 192], "fill_bound_ms": max(mm_bound[fill, 192].values()),
                  "fill_library_ms": mm_library[fill, 192]}},
    ]
    # phase 26's own paths: each kernel's launches in the laid-out train steps and the GPipe decoder, and its
    # error at one rank's head layout under 2-way tensor parallelism
    for entry in kernels:
        short = re.search(r"\((FA(?:-dKV|-dQ)?)\)", entry["name"])
        if short:
            key = short.group(1)
            entry["parallel"] = {
                "launches": {path_: parallel[path_]["launches"][key] for path_ in ("tp", "fsdp", "pipeline")},
                "tp2_layout_max_abs_err": {dt_: errs_[key] for dt_, errs_ in parallel["tp2_layout"].items()},
            }
    train_step = {name: {"ms": v[0], "peak_gib": v[1]} for name, v in train_stats.items()}
    codec_train_step = {name: {"ms": v[0], "peak_gib": v[1], "audio_s_per_s": v[2]} for name, v in codec_stats.items()}
    codec_train_step["parts_ms"] = parts
    codec_train_step["state_gib"] = state_gib
    codec_train_step["overfit"] = {"steps": overfit_steps, "seconds": overfit_s, "val_loss": curve}
    print(json.dumps({"kernels": kernels, "train_step": train_step, "codec_train_step": codec_train_step,
                      "evaluation": evaluation, "host_path": host_path, "parallel": parallel,
                      "public_modules": public_modules, "generation": generation}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
