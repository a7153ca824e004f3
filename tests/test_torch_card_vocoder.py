"""The vocoder's kernels on the card against their plain versions: K1 and
its ablation variants, K2 as a stage and launch by launch, K3, K2-v1 and K2
in v1 mode, and their window invariance (`card`: see tests/card.py)."""

from __future__ import annotations

import math

import pytest
import torch

from dmel_codec_tpu_torch.models import bigvgan
from dmel_codec_tpu_torch.models.bigvgan import AMPBlock1, BigVGAN, BigVGANConfig, FusedBigVGAN
from dmel_codec_tpu_torch.ops import anti_alias
from dmel_codec_tpu_torch.ops.anti_alias import anti_alias_activation, anti_alias_activation_reference
from dmel_codec_tpu_torch.ops.stage_conv import stage_conv, stage_conv_reference
from dmel_codec_tpu_torch.ops.stage_fused import (
    V1_MAX_CHANNELS, StageSpec, act_conv, act_conv_reference, amp_stage, amp_stage_v1, conv_site, pack_stage,
    stage_reference, stage_reference_v1,
)
from dmel_codec_tpu_torch.probes import act_variants
from tests.card import (
    BATCH, FRAMES, FUSE_MAX_CHANNELS, TOL, WINDOW, check_close, jitter_snake, max_err, on_card, rel_err, stage_shapes,
)

pytestmark = pytest.mark.card

F32, BF16 = torch.float32, torch.bfloat16
BOTH = (F32, BF16)
VCFG = BigVGANConfig()
SHAPES = stage_shapes(VCFG, FRAMES)  # a codec request's stages (B = 16 x 4 s)
WIN_SHAPES = stage_shapes(VCFG, WINDOW)  # one streaming window's (B = 1)
LAST = len(SHAPES) - 1
S2, S3, S4, S5 = LAST - 3, LAST - 2, LAST - 1, LAST
FUSED = [i for i, (c, _) in SHAPES.items() if c <= FUSE_MAX_CHANNELS]


def _gen(dev, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def random_pack(c: int, dev):
    """A stage of C channels with random weights (snake parameters spread), packed for K2 on `dev`."""
    spec = StageSpec(channels=c)
    blocks = [jitter_snake(AMPBlock1(c, k, d, spec.activation, spec.logscale))
              for k, d in zip(spec.kernel_sizes, spec.dilations)]
    packed = pack_stage(blocks, spec)
    return spec, {"w": [w.to(dev) for w in packed["w"]], **{k: packed[k].to(dev) for k in ("b", "a", "ib")}}


@pytest.fixture(scope="module")
def packs():
    """{stage: (spec, packed)} of every fused stage, and "C40" / "C5" / "C7": ragged widths."""
    dev = on_card()
    torch.manual_seed(1)
    out = {i: random_pack(SHAPES[i][0], dev) for i in FUSED}
    out.update({f"C{c}": random_pack(c, dev) for c in (40, 5, 7)})
    return out


# ---- K1 ------------------------------------------------------------------------------

K1_STAGES = {"act_post": LAST, "s0": 0, "s1": 1}  # K1's inputs: the last stage's output, s0's and s1's
# (name, x shape, logscale, with beta, x dtype, bf16 parameters, x's element offset from a 16-byte boundary)
K1_CASES = ([(name, (BATCH, *SHAPES[i]), True, True, dt, False, 0) for name, i in K1_STAGES.items() for dt in BOTH]
            + [(f"window {name}", (1, *WIN_SHAPES[i]), True, True, dt, False, 0) for name, i in K1_STAGES.items()
               for dt in BOTH]
            + [("ragged snake", (2, 3, 700), False, False, F32, False, 0),
               ("ragged snakebeta", (1, 5, 1), True, True, F32, False, 0),
               ("ragged snakebeta", (3, 7, 37), False, True, F32, False, 0)]
            + [("bf16 parameters", (2, SHAPES[0][0], 700), logscale, beta, dt, True, 0)
               for logscale, beta in ((True, True), (True, False), (False, True)) for dt in BOTH]
            + [("T up to 64", (2, 3, t), True, True, dt, False, 0) for t in range(1, 65) for dt in BOTH]
            + [("offset", (3, 7, 1000), True, False, dt, False, off) for off in (1, 3) for dt in BOTH])


@pytest.mark.parametrize("name,shape,logscale,with_beta,dt,bf16_params,offset", K1_CASES,
                         ids=[f"{c[0]}-{list(c[1])}-{c[4]}-{c[2]}{c[3]}{c[5]}{c[6]}" for c in K1_CASES])
def test_k1_matches_plain(name, shape, logscale, with_beta, dt, bf16_params, offset):
    """K1, one launch, at the vocoder's shapes in a codec request and in a
    streaming window (snakebeta, logscale), at ragged ones (snake, logscale
    off, T not a multiple of the tile, every T up to 64: a row shorter than
    a lane's run, a unit, the halo), with bf16 parameters (the bf16
    vocoder's: the kernel rounds their exps and 1 / (beta + eps) to bf16
    itself, as the plain version computes them in bf16; on float32 x a
    coefficient one bf16 ulp off would move the output by ~2^-8 of the
    snake term, far beyond K1's float32 tolerance), and on x at an offset
    that is no 16-byte boundary (the head and tail path)."""
    dev = on_card()
    gen = _gen(dev, shape[2])
    c = shape[1]
    alpha = 0.3 * torch.randn(c, device=dev, generator=gen) + (0.0 if logscale else 1.0)
    beta = 0.3 * torch.randn(c, device=dev, generator=gen) + (0.0 if logscale else 1.0) if with_beta else None
    if bf16_params:
        alpha, beta = alpha.bfloat16(), beta if beta is None else beta.bfloat16()
    x = torch.randn(math.prod(shape) + offset, device=dev, generator=gen).to(dt)[offset:].view(shape)
    before = anti_alias_activation.launches
    got = anti_alias_activation(x, alpha, beta, logscale)
    assert anti_alias_activation.launches == before + 1
    check_close(name, got, anti_alias_activation_reference(x, alpha, beta, logscale), TOL[("K1", dt)])


def test_k1_sin_is_sinf():
    """K1's sinf without conversions against sinf over every float below
    105615: no bit may differ but the sign."""
    on_card()
    assert anti_alias.sin_replica_mismatches() == 0


VARIANT_CASES = [((2, 24, 3000), True), ((3, 7, 37), False), ((1, 5, 1), True)]


@pytest.mark.parametrize("shape,with_beta", VARIANT_CASES, ids=[str(list(s)) for s, _ in VARIANT_CASES])
@pytest.mark.parametrize("variant", act_variants.VARIANTS)
@pytest.mark.parametrize("dt", BOTH)
def test_k1_variants_match_plain(shape, with_beta, variant, dt):
    """Each variant of the K1 ablation probe (probes/act_variants.py)
    against its plain version, one launch each."""
    dev = on_card()
    gen = _gen(dev, shape[2])
    c = shape[1]
    alpha = 0.3 * torch.randn(c, device=dev, generator=gen)
    beta = 0.3 * torch.randn(c, device=dev, generator=gen) if with_beta else None
    x = torch.randn(shape, device=dev, generator=gen).to(dt)
    before = act_variants.run_variant.launches
    got = act_variants.run_variant(x, alpha, beta, variant)
    assert act_variants.run_variant.launches == before + 1
    check_close(variant, got, act_variants.variant_reference(x, alpha, beta, variant), TOL[("K1", dt)])


# ---- K2 ------------------------------------------------------------------------------

K2_CASES = ([(f"s{i}", i, (2, *SHAPES[i]), dt) for i in FUSED for dt in BOTH]
            + [(f"window s{i}", i, (1, *WIN_SHAPES[i]), dt) for i in FUSED for dt in BOTH]
            + [("ragged", "C40", (1, 40, 1000), dt) for dt in BOTH]
            + [("short", LAST, (2, SHAPES[LAST][0], 50), dt) for dt in BOTH]
            + [("one sample", LAST, (1, SHAPES[LAST][0], 1), dt) for dt in BOTH]
            + [("ragged short", "C40", (2, 40, 50), BF16)])


@pytest.mark.parametrize("name,pack,shape,dt", K2_CASES, ids=[f"{c[0]}-{list(c[2])}-{c[3]}" for c in K2_CASES])
def test_k2_matches_plain(packs, name, pack, shape, dt):
    """K2 (bf16 operands, or float32 ones split into TF32 hi + lo) at every
    fused width, B = 2 and a streaming window's B = 1, and at ragged shapes
    (T not a multiple of the 128-sample tile, C not a multiple of the
    channel tile, T shorter than the conv reach)."""
    dev = on_card()
    spec, packed = packs[pack]
    x = torch.randn(shape, device=dev, generator=_gen(dev, shape[2])).to(dt)
    check_close(name, amp_stage(x, packed, spec), stage_reference(x, packed, spec), TOL[("K2", dt)])


@pytest.mark.parametrize("pack,shape", [(S2, (2, SHAPES[S2][0], 777)), ("C40", (1, 40, 300))], ids=["s2", "C40"])
def test_k2_launch_by_launch(packs, pack, shape):
    """Each launch against act_conv_reference: the 18 convs (every (k, d))
    of the widest fused stage and of a ragged C = 40 under both bf16
    contracts, alone, onto a residual, and as a block's last launch
    (residual, running sum, mean, bf16 out); float32 launches alone."""
    dev = on_card()
    spec, packed = packs[pack]
    gen = _gen(dev, 6)
    planes = [torch.randn(shape, device=dev, generator=gen) for _ in range(3)]
    src, res, acc_in = planes[0].bfloat16(), planes[1].bfloat16(), planes[2]
    for n in range(18):
        for v1 in (False, True):
            for how, kw in (("alone", {}), ("onto res", {"res": res}),
                            ("last", {"res": res, "acc_in": acc_in, "mean_of": 3, "out_dtype": torch.bfloat16})):
                got = act_conv(src, packed, spec, n, torch.bfloat16, v1=v1, **kw)
                want = act_conv_reference(src, packed, spec, n, torch.bfloat16, v1=v1, **kw)
                e = rel_err(got, want)
                assert e <= TOL[("K2 launch", BF16)], f"launch {n} {conv_site(spec, n)} v1={v1} {how}: {e:.3e}"
        if n % 2 == 0:
            check_close(f"float32 launch {n} {conv_site(spec, n)}", act_conv(planes[0], packed, spec, n, F32),
                        act_conv_reference(planes[0], packed, spec, n, F32), TOL[("K2", F32)])


# ---- K3 ------------------------------------------------------------------------------

CARD_TOL = TOL[("K2", F32)]  # 2e-5 of max(1, max |plain|); K3 read <= 4.7e-6 (PERF.md, PR 21)
CARD_SHAPES = [(b, c, t, k, d) for b in (1, 16) for c, t in ((768, 375), (768, 2240), (384, 2240), (384, 36000))
               for k, d in ((11, 5), (3, 1))] + [(1, 768, 24, 11, 5), (2, 384, 20, 7, 3)]


@pytest.mark.parametrize("b,c,t,k,d", CARD_SHAPES)
def test_k3_matches_plain_on_the_card(b, c, t, k, d):
    """K3 against stage_conv_reference (cuDNN's float32 conv, TF32 off) at
    s0 / s1 widths, B 1 and 16, T = 375 (not a multiple of 4), 2,240 and
    36,000, and T under the conv's reach, with the residual, the running
    sum and the mean: within CARD_TOL of max(1, max |plain|). Both stand
    about 2e-6 from float64 (split-TF32 drops lo lo and the split's
    remainder, 2^-22 of each operand; cuDNN rounds its float32 sums), so
    2e-5 leaves room; one TF32 product misses it by 30x. The same bits come
    back from a second launch."""
    dev = on_card()
    gen = torch.Generator(device=dev).manual_seed(b * 7 + c + t + k)
    a = torch.randn((b, c, t), device=dev, generator=gen)
    w = torch.randn((c, c, k), device=dev, generator=gen) / math.sqrt(c * k)
    bias = 0.05 * torch.randn((c,), device=dev, generator=gen)
    kw = {"res": torch.randn_like(a), "acc_in": torch.randn_like(a), "mean_of": 3}
    got = stage_conv(a, w, bias, d, **kw)
    want = stage_conv_reference(a, w, bias, d, **kw)
    assert (got - want).abs().max().item() <= CARD_TOL * max(1.0, want.abs().max().item())
    assert torch.equal(stage_conv(a, w, bias, d, **kw), got)


def test_vocoder_launch_counts_on_the_card():
    """One float32 vocoder call at the released widths and the default cap
    (fuse_max_channels 192) launches K3 36 times (18 a stage, s0 and s1),
    and matches the call with K3's plain version; a bf16 call launches it
    0 times."""
    dev = on_card()
    model = BigVGAN(BigVGANConfig()).eval().to(dev)
    fused = FusedBigVGAN(model)
    mel = torch.randn((2, 94, 100), device=dev)  # [B, frames, num_mels]: 1 s
    before = stage_conv.launches
    with torch.no_grad():
        wav = fused(mel)
        assert stage_conv.launches - before == 36
        saved = bigvgan.stage_conv
        bigvgan.stage_conv = lambda a, w, b, d, packed=None, **kw: stage_conv_reference(a, w, b, d, **kw)
        try:
            plain = fused(mel)
        finally:
            bigvgan.stage_conv = saved
        assert (wav - plain).abs().max().item() <= 1e-4
        fused16 = FusedBigVGAN(model.to(torch.bfloat16))
        before = stage_conv.launches
        fused16(mel.bfloat16())
        assert stage_conv.launches == before


# ---- K2-v1 and K2 in v1 mode -----------------------------------------------------------

V1_CASES = ([(f"s{i}", i, (2, *SHAPES[i]), dt) for i in (S4, S5) for dt in BOTH]
            + [(f"window s{i}", i, (1, *WIN_SHAPES[i]), dt) for i in (S4, S5) for dt in BOTH]
            + [(f"ragged T = {t}", S5, (b, 24, t), dt) for b, t in ((1, 1), (3, 37), (2, 50), (2, 700), (1, 1000))
               for dt in BOTH]
            + [("ragged C = 5", "C5", (1, 5, 700), dt) for dt in BOTH]
            + [("ragged C = 7", "C7", (3, 7, 37), dt) for dt in BOTH]
            + [("ragged C = 40", "C40", (1, 40, 1000), dt) for dt in BOTH]
            + [("ragged C = 40, two clusters", "C40", (1, 40, 9000), BF16)])


@pytest.mark.parametrize("name,pack,shape,dt", V1_CASES, ids=[f"{c[0]}-{list(c[2])}-{c[3]}" for c in V1_CASES])
def test_k2_v1_matches_plain(packs, name, pack, shape, dt):
    """K2-v1 (clusters of 8 CTAs; bf16, or float32 on split-TF32 products)
    at the flagship widths it holds (C = 48, 24), at a codec request's
    lengths and a streaming window's (the path that launches it), at ragged
    lengths (one sample, shorter than the halo, not a multiple of any tile)
    and at widths that are no multiple of its 8-channel groups."""
    dev = on_card()
    spec, packed = packs[pack]
    x = torch.randn(shape, device=dev, generator=_gen(dev, shape[2] + 1)).to(dt)
    check_close(name, amp_stage_v1(x, packed, spec), stage_reference_v1(x, packed, spec), TOL[("K2-v1", dt)])


def test_k2_v1_refuses_a_wider_stage(packs):
    """K2-v1 holds the two narrowest stages (C = 48 and 24) and refuses s3 (C = 96)."""
    dev = on_card()
    assert SHAPES[S4][0] == V1_MAX_CHANNELS == 48 and SHAPES[S5][0] == 24, SHAPES
    assert SHAPES[S2][0] == 192 and SHAPES[S3][0] == 96, SHAPES
    spec, packed = packs[S3]
    with pytest.raises(ValueError):
        amp_stage_v1(torch.zeros((1, 96, 256), device=dev), packed, spec)


V1_MODE_CASES = [(f"{where}s{i}", i, shape, dt) for i in (S2, S3)
                 for where, shape in (("", (2, *SHAPES[i])), ("window ", (1, *WIN_SHAPES[i]))) for dt in BOTH]


@pytest.mark.parametrize("name,stage,shape,dt", V1_MODE_CASES,
                         ids=[f"{c[0]}-{list(c[2])}-{c[3]}" for c in V1_MODE_CASES])
def test_k2_in_v1_mode_matches_plain(packs, name, stage, shape, dt):
    """K2 in v1 mode, what FusedBigVGAN(use_v2=False) runs at the fused
    stages wider than K2-v1 takes (route "K2/v1"), against K2-v1's plain
    version at s2 (C = 192) and s3 (C = 96): 18 launches on the kernel of
    the input's dtype."""
    dev = on_card()
    spec, packed = packs[stage]
    x = torch.randn(shape, device=dev, generator=_gen(dev, shape[2] + 2)).to(dt)
    kernel = "act_conv_tc_kernel" if dt == BF16 else "act_conv_tf32_kernel"
    before = amp_stage.launches_by_kernel[kernel]
    got = amp_stage(x, packed, spec, v1=True)
    assert amp_stage.launches_by_kernel[kernel] == before + 18, amp_stage.launches_by_kernel
    check_close(name, got, stage_reference_v1(x, packed, spec), TOL[("K2-v1", dt)])


# ---- window invariance ----------------------------------------------------------------

INVARIANCE = ([("K1", dt, None) for dt in BOTH] + [("K2", F32, i) for i in (S5, S4, S2)]
              + [("K2-v1", F32, i) for i in (S5, S4)] + [("K2", BF16, i) for i in (S5, S4, S2)]
              + [("K2-v1", BF16, i) for i in (S5, S4)])


@pytest.mark.parametrize("kernel,dt,stage", INVARIANCE, ids=[f"{k}-{dt}-s{i}" for k, dt, i in INVARIANCE])
def test_window_invariance(packs, kernel, dt, stage):
    """A kernel run on x[:, :, 777:3001] gives the bits of its run on the
    whole of x, beyond its receptive field from the cuts (K2's split-TF32
    kernel at s2 too: 16 warps, two column groups; in bf16 its tiles start
    at other samples on the slice)."""
    dev = on_card()
    gen = _gen(dev, 7)
    cut_a, cut_b = 777, 3001
    if kernel == "K1":
        c, reach = 24, 6
        alpha = 0.3 * torch.randn(c, device=dev, generator=gen)

        def fn(v):
            return anti_alias_activation(v, alpha, alpha, True)
    else:
        spec, packed = packs[stage]
        c, reach = spec.channels, spec.receptive

        def fn(v):
            return (amp_stage if kernel == "K2" else amp_stage_v1)(v, packed, spec)
    x = torch.randn((2, c, 5000), device=dev, generator=gen).to(dt)
    whole, part = fn(x), fn(x[:, :, cut_a:cut_b].contiguous())
    assert max_err(part[:, :, reach:-reach], whole[:, :, cut_a + reach: cut_b - reach]) == 0.0
