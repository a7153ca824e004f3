"""K3 (csrc/stage_conv_tf32.cu, ops/stage_conv.py): the float32 convs of the
vocoder's per-block stages on the tensor cores.

On the CPU: K3's plain version is the "block" route's conv and additions
(`AMPBlock1.forward` with `F.conv1d`) in every epilogue form, and the
launch plan through it is the route's output to the bit; the split weight
layout unpacks to `split_tf32` of the weights; the planner's tiles fit
shared memory, cover the plane and fill the SMs on a short input; and
which kernel each launch of a stage asks for (a stand-in library: the
kernels run only on the card).

On the card: tests/test_torch_card_vocoder.py (K3 against its plain
version at s0 / s1 shapes, and the launch counts of a float32 and a bf16
vocoder call).
"""

from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as F

import dmel_codec_tpu_torch.ops.stage_conv as k3_ops
from dmel_codec_tpu_torch.models.bigvgan import AMPBlock1, BigVGAN, BigVGANConfig, FusedBigVGAN
from dmel_codec_tpu_torch.ops import library
from dmel_codec_tpu_torch.ops.stage_conv import (
    K3_CONFIGS,
    K3_MAX_S,
    K3_SMEM,
    conv_plan,
    conv_unpack,
    conv_weights,
    stage_conv,
    stage_conv_reference,
)
from dmel_codec_tpu_torch.ops.stage_fused import conv_site, split_tf32
from dmel_codec_tpu_torch.utils.precision import strict_float32

# a two-stage vocoder whose first stage (C = 32) runs per block at fuse_max_channels 16
SMALL = BigVGANConfig(num_mels=8, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), upsample_initial_channel=64)


@pytest.fixture
def f32():
    """float32 without TF32, one torch thread."""
    threads = torch.get_num_threads()
    strict_float32()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(cfg: BigVGANConfig = SMALL, seed: int = 0, device="cpu") -> BigVGAN:
    torch.manual_seed(seed)
    with torch.device(device):
        model = BigVGAN(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.3)
    return model


@pytest.mark.parametrize("form", ["conv", "res", "res_acc_mean"])
def test_plain_version_is_the_block_routes_conv(f32, form):
    """stage_conv_reference on an AMPBlock1's activation output is the
    conv and the additions the route makes: F.conv1d with the conv's bias
    as `AMPBlock1.forward` calls it, then the residual (x + xt), the running
    sum of the blocks and their mean, each to the bit."""
    block = AMPBlock1(24, 7, (1, 3, 5), "snakebeta", True).eval()
    with torch.no_grad():
        for p in block.parameters():
            p.normal_(0.0, 0.3)
        x = torch.randn(2, 24, 83)
        conv = block.convs1[2]
        a = block.activations[4](x)
        xt = F.conv1d(a, conv.weight(), conv.bias, padding=conv.padding, dilation=conv.dilation)
        kw, want = {}, xt
        if form != "conv":
            kw["res"] = x
            want = x + xt
        if form == "res_acc_mean":
            kw["acc_in"] = acc = torch.randn_like(x)
            kw["mean_of"] = 3
            want = (acc + want) / 3
        got = stage_conv_reference(a, conv.weight(), conv.bias, 5, **kw)
        assert torch.equal(got, want)
        assert torch.equal(stage_conv(a, conv.weight(), conv.bias, 5, **kw), want)  # a CPU tensor: the plain version


@pytest.mark.parametrize("t", [50, 37])
def test_float32_block_stage_is_the_route_to_the_bit(f32, t):
    """A float32 "block" stage of FusedBigVGAN (K2's launch plan, each
    launch the activation, then stage_conv) equals the route as it was,
    `sum(AMPBlock1.forward) / 3`, to the bit, T a multiple of 4 or not; the
    whole call equals BigVGAN.forward within float32 rounding."""
    model = _model()
    fused = FusedBigVGAN(model, fuse_max_channels=16)
    assert fused.routes == ["block", "K2"] and list(fused.block_specs) == [0]
    with torch.no_grad():
        x = torch.randn(2, 32, t)
        blocks = model.stage_blocks(0)
        want = sum(b(x, w) for b, w in zip(blocks, fused.stages[0][1])) / len(blocks)
        assert torch.equal(fused.resblocks(0, x), want)
        mel = torch.randn(2, 12, 8)
        assert torch.allclose(fused(mel), model(mel), atol=2e-5, rtol=0)


@pytest.mark.parametrize("c,k", [(24, 11), (384, 7), (768, 3)])
def test_k3_weight_layout_unpacks(c, k):
    """conv_weights lays out hi = tf32(w), lo = tf32(w - hi) in blocks of 64
    output channels and chunks of 16 input channels, zero-padded;
    conv_unpack gives both back exactly."""
    w = torch.randn((c, c, k), generator=torch.Generator().manual_seed(c)) / math.sqrt(c * k)
    flat = conv_weights(w)
    assert flat.dtype == torch.float32 and flat.numel() == 2 * k * (-(-c // 64) * 64) * (-(-c // 16) * 16)
    hi, lo = conv_unpack(flat, c, c, k)
    want_hi, want_lo = split_tf32(w)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    assert (flat != 0).sum() == (want_hi != 0).sum() + (want_lo != 0).sum()  # the padding is zero


SHAPES = [(16, 768, 2240), (16, 384, 8960), (1, 768, 375), (1, 384, 1500), (1, 768, 24), (1, 768, 36000),
          (2, 40, 700), (16, 768, 3752)]


@pytest.mark.parametrize("b,c,t", SHAPES)
def test_k3_plans_fit_cover_and_fill(b, c, t):
    """At every (k, d) of the vocoder's stages: the plan's block fits 227 KB,
    its activation slot holds the tile, the reach on both sides and the
    3-row lead in one TMA box (rows = 8 mod 16), its tiles cover [0, T) x
    [0, C) with ragged edges; it is the widest tile that still gives the
    132 SMs a tile each, and where none does, the one with the most tiles."""
    for k in (3, 7, 11):
        for d in (1, 3, 5):
            plan = conv_plan(b, c, t, k, d)
            reach = d * (k - 1) // 2
            assert (plan.wgs, plan.bn) in K3_CONFIGS and plan.bm == 64 * plan.wgs
            assert plan.smem_bytes <= K3_SMEM
            assert plan.bm + 2 * reach + 3 <= plan.rows <= K3_MAX_S and plan.rows % 16 == 8
            gx, gy, gz = plan.grid
            assert gz == b and gx * plan.bn >= c > (gx - 1) * plan.bn and gy * plan.bm >= t > (gy - 1) * plan.bm
            tiles = {cfg: (-(-c // cfg[1])) * (-(-t // (64 * cfg[0]))) * b for cfg in K3_CONFIGS}
            first = next((cfg for cfg in K3_CONFIGS if tiles[cfg] >= 132), None)
            assert (plan.wgs, plan.bn) == (first or max(K3_CONFIGS, key=tiles.get))
    assert tuple(conv_plan(16, 768, 2240, 11, 5)[:2]) == (3, 128)  # the cell's shape: the widest tile
    assert tuple(conv_plan(1, 768, 375, 11, 5)[:2]) == (1, 64) and math.prod(conv_plan(1, 768, 375, 3, 1).grid) == 72


class _Lib:
    """Records each launch's kernel and arguments."""

    def __init__(self):
        self.calls = []

    def dmel_anti_alias(self, *args):
        self.calls.append(("K1", args))
        return 0

    def dmel_stage_conv_tf32(self, *args):
        self.calls.append(("K3", args))
        return 0


def _stand_in(monkeypatch) -> _Lib:
    lib = _Lib()
    monkeypatch.setattr(k3_ops, "_sm_count", lambda device: 132)
    monkeypatch.setattr(library, "load", lambda: lib)
    monkeypatch.setattr(library, "check_plane", lambda x, name="x": None)
    monkeypatch.setattr(library, "stream", lambda x: 0)
    return lib


def test_block_stage_dispatch(monkeypatch):
    """A float32 "block" stage on a tensor that is not on the CPU (`meta`,
    the library stood in for) asks for 18 K1 and 18 K3 launches, each K3
    with its conv's (k, d), the plan's (wgs, bn), the epilogue's mean and
    the weights packed once per device; a bf16 stage keeps the route of
    `AMPBlock1.forward` (K1 and F.conv1d, no K3); a CPU tensor takes the
    plain versions and no launch."""
    lib = _stand_in(monkeypatch)
    model = _model(device="meta")
    fused = FusedBigVGAN(model, fuse_max_channels=16)
    spec = fused.block_specs[0]
    x = torch.empty((2, 32, 48), device="meta")
    before = stage_conv.launches, dict(stage_conv.launches_by_kernel)
    y = fused.resblocks(0, x)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert [name for name, _ in lib.calls] == ["K1", "K3"] * 18
    assert stage_conv.launches == before[0] + 18
    assert stage_conv.launches_by_kernel["stage_conv_tf32_kernel"] == before[1]["stage_conv_tf32_kernel"] + 18
    for n, (_, a) in enumerate(lib.calls[1::2]):
        k, d = conv_site(spec, n)
        plan = conv_plan(2, 32, 48, k, d)
        assert a[1:5] == (2, 32, 48, 48) and a[11:15] == (k, d, plan.wgs, plan.bn)
        assert a[10] == pytest.approx(3.0 if n == 17 else 1.0)
    packed = fused._k3_packed[(0, x.device)]
    fused.resblocks(0, x)
    assert fused._k3_packed[(0, x.device)] is packed and len(packed) == 18

    lib.calls.clear()
    model16 = _model(device="meta").to(torch.bfloat16)
    fused16 = FusedBigVGAN(model16, fuse_max_channels=16)
    y16 = fused16.resblocks(0, x.to(torch.bfloat16))
    assert y16.dtype == torch.bfloat16 and [name for name, _ in lib.calls] == ["K1"] * 18

    lib.calls.clear()
    cpu = FusedBigVGAN(_model(), fuse_max_channels=16)
    with torch.no_grad():
        cpu.resblocks(0, torch.randn(1, 32, 20))
    assert lib.calls == [] and stage_conv.launches == before[0] + 36
