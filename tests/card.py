"""What the `card` tests share (tests/test_torch_card_*.py): the card check,
the kernel-vs-plain comparison, the tolerances and their reasons, and the
vocoder's shapes. Imports nothing of JAX: on the card the suite runs
without the tests' conftest (which imports JAX):

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_card_*.py -m card

Every comparison runs with TF32 off for cuBLAS and cuDNN, as the entry
points run (each `main` calls `strict_float32`).
"""

from __future__ import annotations

import dataclasses
import gc
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from dmel_codec_tpu_torch.lm.inputs import TokenGridBuilder, pad_grids_to_batch
from dmel_codec_tpu_torch.models import bigvgan
from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
from dmel_codec_tpu_torch.models.transformer import Attention, Decoder
from dmel_codec_tpu_torch.nn.snake import SnakeBeta
from dmel_codec_tpu_torch.ops import flash_attention as fa_ops
from dmel_codec_tpu_torch.ops.anti_alias import anti_alias_activation_reference
from dmel_codec_tpu_torch.ops.stage_conv import stage_conv_reference
from dmel_codec_tpu_torch.ops.stage_fused import amp_stage, amp_stage_v1, stage_reference, stage_reference_v1
from dmel_codec_tpu_torch.utils.precision import strict_float32

SECONDS, BATCH, SR, HOP = 4, 16, 24000, 256
FRAMES = (SECONDS * SR // HOP // 4) * 4  # a 4 s clip's mel frames, cropped to the codec's downsample multiple
FUSE_MAX_CHANNELS = 192
VOCODE_CHUNK, VOCODE_HALO = 480, 40
WINDOW = VOCODE_CHUNK + 2 * VOCODE_HALO  # one streaming window's mel frames
FA_KERNELS = {"FA": fa_ops.flash_attention, "FA-dKV": fa_ops.flash_attention_dkv, "FA-dQ": fa_ops.flash_attention_dq}


def on_card() -> torch.device:
    """The card, with float32 meaning float32; skips the test without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    strict_float32()
    return torch.device("cuda")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max(1, max |want|)."""
    return max_err(got, want) / max(1.0, want.float().abs().max().item())


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, rel: float) -> None:
    """Fails unless max |got - want| <= rel * max(1, max |want|)."""
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = rel_err(got, want)
    assert err <= rel, f"{name}: kernel disagrees with its plain version: {err:.3e} > {rel:.3e} of max(1, max |want|)"


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
#    the window lies (test_window_invariance); the cuDNN convs around them
#    could pick another algorithm (and so summation order) for another T,
#    ~1e-7 relative per op over 20 layers: 1e-5 for the decode, 2e-5 (K2's
#    own) per vocoder stage, and 2e-5 absolute end to end, which the JAX
#    package asserts on its XLA path (scripts/bench_streaming.py:72; its
#    kernel path is off by 1.58e-1 there, BENCHMARKS.md:270-282). On an
#    NVIDIA H100 with torch 2.11 every one of these differences measured 0.
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
#  K5 bf16 (latent attention's core, against `mla_attention_reference`):
#    K5 keeps the scores float32 where the plain version's product rounds
#    them to bf16 before its float32 softmax (2^-9 of each score: at the
#    N(0, 1) scores of the tests' draws, up to ~5, a probability moves by up
#    to ~1 %, with signs that vary from key to key), both round P to bf16
#    before P V (K5 the unnormalised p, the plain version the normalised
#    probabilities: another 2^-9 each), and both round the output once (one
#    bf16 ulp, 2^-8 of max |out| < 1): 2^-6 of max(1, max |plain|); measured
#    2.6e-3 to 6.5e-3 on an H100 at the shapes of the card tests.
TOL = {("K1", torch.float32): 1e-6, ("K1", torch.bfloat16): 2.0**-7,
       ("K2", torch.float32): 2e-5, ("K2", torch.bfloat16): 5e-2, ("K2 launch", torch.bfloat16): 2.0**-6,
       ("K2-v1", torch.float32): 2e-5, ("K2-v1", torch.bfloat16): 2.0**-6,
       ("FA", torch.float32): 2e-5, ("FA", torch.bfloat16): 2.0**-7,
       ("FA-bwd", torch.float32): 2e-5, ("FA-bwd", torch.bfloat16): 2.0**-6, ("K5", torch.bfloat16): 2.0**-6}
# LM training, kernels on vs `flash_attention=False`, float32: the loss is a
# mean over ~20,000 positions of values that agree to ~1e-6: 1e-4 relative.
# A parameter's gradient sums such differences over 2048 positions and up to
# 36 layers: 1e-3 of the tensor's largest gradient.
TOL_TRAIN_LOSS, TOL_TRAIN_GRAD = 1e-4, 1e-3
TOL_LM_MAX, TOL_LM_MEAN = 1.2e-1, 1e-2
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


def fa_rel(dt: torch.dtype, v: torch.Tensor, want: torch.Tensor) -> float:
    """FA's tolerance relative to max(1, max |plain|): TOL["FA"], and in bf16
    the bound 2^-9 max |v| of the kernel's rounding of P (comment above)."""
    if dt == torch.float32:
        return TOL[("FA", dt)]
    return TOL[("FA", dt)] + 2.0**-9 * v.float().abs().max().item() / max(1.0, want.float().abs().max().item())


def stage_shapes(vcfg, frames: int) -> dict:
    """{stage: (channels, samples)} of the vocoder on `frames` mel frames."""
    out, t = {}, frames
    for i, u in enumerate(vcfg.upsample_rates):
        t *= u
        out[i] = (vcfg.stage_channels(i), t)
    return out


@torch.no_grad()
def jitter_snake(module: torch.nn.Module) -> torch.nn.Module:
    """Log-alpha / log-beta start at 0 (every alpha = 1); spread them."""
    for m in module.modules():
        if isinstance(m, SnakeBeta):
            for p in (m.alpha, m.beta):
                if p is not None:
                    p.normal_(0.0, 0.1)
    return module


def codec_and_vocoder(dev):
    """The flagship DMelCodec in bf16 and BigVGAN in float32 (snake
    parameters spread), seeded weights, on `dev`."""
    torch.manual_seed(0)
    codec = DMelCodec(DMelCodecConfig(compute_dtype="bfloat16")).eval()
    voc32 = jitter_snake(BigVGAN(BigVGANConfig()).eval())
    return codec.to(device=dev, dtype=torch.bfloat16), voc32.to(dev)


def lm_train_batches(trainer, seq: int, n: int, seed: int) -> list:
    """n device batches of two training grids of the trainer's LM padded to
    `seq` positions (text + audio + 14 positions a grid): one fills it, one
    is 100 positions short."""
    rng = np.random.default_rng(seed)
    cfg = trainer.lm_config
    gridder = TokenGridBuilder(config=cfg)
    out = []
    for _ in range(n):
        grids = [gridder.build_train_grid(rng.integers(0, 151643, size=lt), rng.integers(0, 175, size=(la, 10)))
                 for lt, la in ((34, seq - 48), (20, seq - 148))]
        out.append(trainer.device_batch(pad_grids_to_batch(grids, cfg, pad_to=seq)))
    return out


def write_manifest(path: Path, clips, texts=None) -> Path:
    """Each clip as a 24 kHz float32 WAV beside `path`, and `path` as their manifest."""
    with open(path, "w") as f:
        for i, clip in enumerate(clips):
            wav = path.parent / f"{path.stem}{i}.wav"
            wavfile.write(wav, SR, np.asarray(clip, np.float32))
            f.write(json.dumps({"id": f"{path.stem}{i}", "audio_path": str(wav), "duration": len(clip) / SR,
                                "text": texts[i] if texts else ""}) + "\n")
    return path


def free_card() -> None:
    """Hand what earlier tests cached back to the card before a test that needs most of it."""
    gc.collect()
    torch.cuda.empty_cache()


def reset_launches(*fns) -> None:
    """Zero the launch counters of kernel wrappers (and K2's and K2-v1's by kernel)."""
    for fn in fns:
        fn.launches = 0
    amp_stage.launches_by_kernel.update(act_conv_tc_kernel=0, act_conv_tf32_kernel=0)
    amp_stage_v1.launches_by_kernel.update(stage_v1_tc_kernel=0, stage_v1_tf32_kernel=0)


def fa_launches() -> dict:
    return {name: fn.launches for name, fn in FA_KERNELS.items()}


def set_flash(lm: torch.nn.Module, on: bool) -> None:
    """Switch an LM's slow decoder between the flash kernels and the einsum path."""
    for m in lm.slow_decoder.modules():
        if isinstance(m, (Attention, Decoder)):
            m.config = dataclasses.replace(m.config, flash_attention=on)


def plain_kernels(m: pytest.MonkeyPatch) -> None:
    """Route the vocoder's kernel calls to their plain versions (undone with `m`)."""
    m.setattr(bigvgan, "anti_alias_activation", anti_alias_activation_reference)
    m.setattr(bigvgan, "amp_stage", lambda x, pk, sp, v1=False: (stage_reference_v1 if v1 else stage_reference)(
        x, pk, sp))
    m.setattr(bigvgan, "amp_stage_v1", stage_reference_v1)
    m.setattr(bigvgan, "stage_conv", lambda a, w, b, d, packed=None, **kw: stage_conv_reference(a, w, b, d, **kw))
