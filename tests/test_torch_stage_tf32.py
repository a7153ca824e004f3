"""The float32 kernels' CPU side (K2's split-TF32 kernel,
csrc/stage_fused_tf32.cu, and K2-v1's, csrc/stage_fused_v1.cu): their plans
fit shared memory and their tiles cover T once, the split hi / lo weight
layout unpacks to the weights, the split-TF32 arithmetic of the stage stays
within the kernels' tolerance of the JAX package's float32 oracle, and
every float32 launch goes to the new kernels and their counters (a
stand-in library: the kernels run only on the card, where chip_smoke.py
holds them against the plain versions).
"""

from __future__ import annotations

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_codec_tpu.ops.stage_fused import StageSpec as JaxStageSpec
from dmel_codec_tpu.ops.stage_fused import stage_reference as jax_stage_reference
from dmel_codec_tpu_torch.ops import library, stage_fused
from dmel_codec_tpu_torch.ops.anti_alias import FILT
from dmel_codec_tpu_torch.ops.stage_fused import (
    StageSpec,
    amp_stage,
    amp_stage_v1,
    conv_site,
    split_tf32,
    stage_reference,
    tf32_plan,
    tf32_unpack,
    tf32_weights,
    v1_tc_tiles,
    v1_tf32_bytes,
    v1_tf32_plan,
)
from dmel_codec_tpu_torch.probes.tf32_split import split_conv
from tests.test_torch_stage_v1 import _packed
from tests.test_torch_support import strict_f32, to_np  # noqa: F401  (strict_f32 is a fixture)

pytestmark = pytest.mark.usefixtures("strict_f32")

SMEM = 227 * 1024  # what the library reports on sm_90
WIDTHS = (5, 7, 24, 40, 48, 96, 192)  # the vocoder's fused widths and the ragged ones chip_smoke.py runs


@pytest.mark.parametrize("c", WIDTHS)
def test_tf32_plans_fit_and_tile(c):
    """K2's float32 plan at every (k, d) of the stage fits the block's
    shared memory (227 KB; 113 KB a block where two share an SM) with at
    least two weight slots, its slots hold whole 8-channel steps, and its
    blocks of BM samples and N channels cover [0, T) x [0, C) once. K2-v1's
    (C <= 48) fits with 2..4 slots and its cluster tiles partition [0, T)."""
    spec = StageSpec(channels=c)
    for k, dils in zip(spec.kernel_sizes, spec.dilations):
        for d in {1, *dils}:
            plan = tf32_plan(c, k, d)
            budget = SMEM if plan.warps == 16 else 115712
            assert plan.smem_bytes <= budget and plan.slots >= 2
            assert plan.n >= min(c, 192) and plan.blocks * plan.n >= c and plan.kp >= c
            assert plan.kp % plan.warps == 0 and plan.kp % plan.ks == 0 and plan.ks % plan.kc == 0
            assert plan.kc % 8 == 0 and plan.kc * plan.n * 8 <= max(stage_fused.TF32_SLOT_BYTES, 64 * plan.n)
            for t in (1, 127, 128, 372 * 32, 560 * 256 + 3):
                covered = np.zeros(t, dtype=int)
                for i in range(-(-t // plan.bm)):
                    covered[i * plan.bm: min((i + 1) * plan.bm, t)] += 1
                assert (covered == 1).all()
    if c > stage_fused.V1_MAX_CHANNELS:
        return
    n, kp, w, slots = v1_tf32_plan(c, spec, SMEM)
    assert n >= c and kp % 8 == 0 and kp >= c and w % 256 == 0 and w >= 256 and 2 <= slots <= 4
    assert v1_tf32_bytes(c, kp, n, w, slots) <= SMEM
    if w < 1024 and w // 256 < stage_fused._V1_TF32_TILES[n]:
        assert v1_tf32_bytes(c, kp, n, w + 256, 2) > SMEM  # the widest W that fits
    for t in (1, 37, 1000, 9000, 560 * 256):
        covered = np.zeros(t, dtype=int)
        for _, _, stored in v1_tc_tiles(t, w, stage_fused.V1_CLUSTER, spec.receptive):
            for lo, hi in stored:
                covered[lo:hi] += 1
        assert (covered == 1).all()


@pytest.mark.parametrize("c,v1", [(24, False), (40, False), (192, False), (256, False), (24, True), (40, True)])
def test_tf32_weight_layout_unpacks(c, v1):
    """The hi / lo layout unpacks to each conv's split: hi = tf32(w) and
    lo = tf32(w - hi) bit for bit, each with at most 10 mantissa bits (the
    low 13 bits zero), and hi + lo within 2^-22 |w| of w (bit for bit where
    w - hi fits 11 significant bits). The padded rows and columns are
    zero. C = 256 takes super-chunks of its input channels."""
    rng = np.random.default_rng(c)
    ws = [torch.from_numpy((rng.standard_normal((k, c, c)) / math.sqrt(k * c)).astype(np.float32))
          for k in (3, 7, 11)]
    kp = stage_fused.tf32_tiling(c)[2]
    flat, offsets = tf32_weights(ws, c, per_tap=v1)
    assert flat.dtype == torch.float32 and all(at % 4 == 0 for at in offsets)
    n, blocks = stage_fused.tf32_tiling(c)[:2]
    assert flat.numel() == sum(2 * k * blocks * n * kp for k in (3, 7, 11))
    for (hi, lo), w in zip(tf32_unpack(flat, offsets, (3, 7, 11), c, per_tap=v1), ws):
        want_hi, want_lo = split_tf32(w)
        assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
        for part in (hi, lo):
            assert int((part.contiguous().view(torch.int32) & 0x1FFF).abs().max()) == 0
        rest = (w.double() - hi.double() - lo.double()).abs()
        assert bool((rest <= 2.0**-22 * w.double().abs()).all())
        exact = (w.view(torch.int32) & 0xFFF) == 0  # w - hi then has at most 11 significant bits
        assert torch.equal((hi + lo)[exact], w[exact])
    assert int((flat != 0).sum()) <= 2 * sum(k * c * c for k in (3, 7, 11))


def _as_conv1d(products):
    """F.conv1d's call as act_conv_reference makes it, computed with the
    float32 kernels' arithmetic (`probes/tf32_split.split_conv`: each
    operand split into hi + lo, the first `products` of A_hi B_hi, A_hi
    B_lo, A_lo B_hi, each exact in float32, summed in float32), then the
    bias."""
    return lambda y, w, b, padding, dilation: split_conv(y, w, dilation, products) + b[:, None]


@pytest.mark.parametrize("c,t", [(24, 700), (7, 300)])
def test_split_tf32_stage_within_tolerance_of_jax_oracle(monkeypatch, c, t):
    """The float32 stage with every conv as the kernels compute it
    (split-TF32, three products; emulated here in plain float32, where each
    product is exact) against the JAX package's `stage_reference` in float32
    (Precision.HIGHEST): within 2e-5 of max(1, max |out|), the tolerance
    chip_smoke.py holds the kernels to against their plain versions. One
    TF32 product alone is held to it too, and misses it."""
    jp, tp = _packed(c, seed=40 + c)
    x = np.random.default_rng(t).standard_normal((2, t, c)).astype(np.float32)
    want = np.asarray(jax_stage_reference(jnp.asarray(x), jp, JaxStageSpec(channels=c)))
    xt = torch.from_numpy(x).transpose(1, 2).contiguous()
    spec = StageSpec(channels=c)
    scale = max(1.0, np.abs(want).max())
    with monkeypatch.context() as m:
        m.setattr(stage_fused, "F", types.SimpleNamespace(conv1d=_as_conv1d(3)))
        got = to_np(stage_reference(xt, tp, spec).transpose(1, 2))
    assert np.abs(got - want).max() <= 2e-5 * scale
    with monkeypatch.context() as m:
        m.setattr(stage_fused, "F", types.SimpleNamespace(conv1d=_as_conv1d(1)))
        rough = to_np(stage_reference(xt, tp, spec).transpose(1, 2))
    assert np.abs(rough - want).max() > 2e-5 * scale


class _Lib:
    """Records each launch's kernel and arguments."""

    def __init__(self):
        self.calls = []

    def dmel_act_conv_tc(self, *args):
        self.calls.append(("act_conv_tc_kernel", args))
        return 0

    def dmel_act_conv_tf32(self, *args):
        self.calls.append(("act_conv_tf32_kernel", args))
        return 0

    def dmel_stage_v1_tc(self, *args):
        self.calls.append(("stage_v1_tc", args))
        return 0

    def dmel_stage_v1_smem_bytes(self):
        return SMEM


@pytest.mark.parametrize("v1", [False, True], ids=["v2", "v1"])
def test_float32_launches_take_the_tf32_kernels(monkeypatch, v1):
    """On a tensor that is not on the CPU (`meta`, with the library, the
    device check and the stream stood in for): each of a float32 stage's 18
    K2 launches, under either contract, takes the split-TF32 kernel with
    its plan's N / KP / KS / KC / slots, its conv's offset in the split
    layout and float32 taps, counted under `act_conv_tf32_kernel`; a float32
    K2-v1 launch takes the cluster kernel with the float32 plan (slots > 0,
    the split layout with a tap per slot), counted under
    `stage_v1_tf32_kernel`; a bf16 one keeps slots = 0 and its counter."""
    lib = _Lib()
    monkeypatch.setattr(library, "load", lambda: lib)
    monkeypatch.setattr(library, "check_plane", lambda x, name="x": None)
    monkeypatch.setattr(library, "stream", lambda x: 0)
    c, spec = 40, StageSpec(channels=40)
    _, packed = _packed(c, seed=11)
    x = torch.empty((2, c, 300), device="meta", dtype=torch.float32)
    before = dict(amp_stage.launches_by_kernel)
    y = amp_stage(x, packed, spec, v1=v1)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert [name for name, _ in lib.calls] == ["act_conv_tf32_kernel"] * 18
    assert amp_stage.launches_by_kernel["act_conv_tf32_kernel"] == before["act_conv_tf32_kernel"] + 18
    assert amp_stage.launches_by_kernel["act_conv_tc_kernel"] == before["act_conv_tc_kernel"]
    args = packed[("K2", torch.float32, x.device)]
    for n, (_, a) in enumerate(lib.calls):
        k, d = conv_site(spec, n)
        plan = tf32_plan(c, k, d)
        assert a[1] == 4 * args["offsets"][n] and a[2:7] == (plan.n, plan.kp, plan.ks, plan.kc, plan.slots)
        assert a[15] == pytest.approx(3.0 if n == 17 else 1.0) and a[16:21] == (2, c, 300, k, d)
        assert list(a[21]) == FILT.tolist() and a[22] == 3
    if not v1:
        return
    lib.calls.clear()
    before_v1 = dict(amp_stage_v1.launches_by_kernel)
    amp_stage_v1(x, packed, spec)
    amp_stage_v1(x.to(torch.bfloat16), packed, spec)
    (_, f32), (_, bf) = lib.calls
    n, kp, w, slots = v1_tf32_plan(c, spec, SMEM)
    assert f32[7:11] == (n, kp, 2, c) and f32[12] == w and f32[15] == slots > 0
    assert bf[15] == 0 and bf[8] == stage_fused.v1_tc_plan(c, spec, SMEM)[1]
    v1_args = packed[("v1", torch.float32, x.device)]
    assert v1_args["w"].dtype == torch.float32 and v1_args["w"].numel() == sum(2 * k * n * kp for k in (3, 7, 11) * 6)
    assert amp_stage_v1.launches_by_kernel == {"stage_v1_tc_kernel": before_v1["stage_v1_tc_kernel"] + 1,
                                               "stage_v1_tf32_kernel": before_v1["stage_v1_tf32_kernel"] + 1}
