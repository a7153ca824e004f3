"""K2's bf16 contract and its tensor-core kernel's CPU side: the plain
version against the JAX v2 kernel (interpret mode) in bf16, one launch's
plain version (`act_conv_reference`) chained 18 times into the stage's, the
bf16 kernel's weight layout (`tc_weights`) and its cache in `packed`, and
which kernel each launch of `amp_stage` / `act_conv` takes, with which
arguments (a stand-in library: the kernels run only on the card, where
chip_smoke.py holds them against these plain versions).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_codec_tpu.ops.stage_fused import StageSpec as JaxStageSpec
from dmel_codec_tpu.ops.stage_fused import fused_amp_stage_v2
from dmel_codec_tpu_torch.ops import library, stage_fused
from dmel_codec_tpu_torch.ops.anti_alias import FILT, FILT_BF16
from dmel_codec_tpu_torch.ops.stage_fused import (
    StageSpec,
    act_conv,
    act_conv_reference,
    amp_stage,
    conv_site,
    stage_reference,
    stage_reference_v1,
    tc_plan,
    tc_unpack,
    tc_weights,
    tf32_plan,
)
from tests.test_torch_stage_v1 import _packed
from tests.test_torch_support import strict_f32, to_np  # noqa: F401  (strict_f32 is a fixture)

pytestmark = pytest.mark.usefixtures("strict_f32")


def test_plain_bf16_matches_jax_v2_kernel():
    """The bf16 v2 contract: the JAX v2 kernel rounds the 12 taps and the
    snake's output v to bf16 (its banded bf16 matmuls) besides the planes.
    The rest differs only in the order of float32 sums and the kernel's
    polynomial sin, so a value next to a rounding boundary may round the
    other way and the flip travels down the 36 ops: at least 3/4 of the
    outputs the same bits and within two bf16 ulps of max |out| (measured
    0.827 and 9.3e-3; 0.188 with float32 taps and v)."""
    c, t = 24, 2048
    jp, tp = _packed(c, seed=c)
    x = np.random.default_rng(t).standard_normal((2, t, c)).astype(np.float32)
    want = fused_amp_stage_v2(jnp.asarray(x).astype(jnp.bfloat16), jp, JaxStageSpec(channels=c),
                              interpret=True, tile_w=512)
    want = np.asarray(want.astype(jnp.float32))
    got = stage_reference(torch.from_numpy(x).bfloat16().transpose(1, 2).contiguous(), tp, StageSpec(channels=c))
    got = to_np(got.float().transpose(1, 2))
    assert (got == want).mean() >= 0.75
    assert np.abs(got - want).max() <= 2.0**-6 * np.abs(want).max()


@pytest.mark.parametrize("v1", [False, True], ids=["v2", "v1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_eighteen_launches_are_the_stage(dtype, v1):
    """The stage written out as its 18 launches (the pair's first conv into
    t1, the second onto the residual spine, each block's last into the
    running sum, the last one the mean) through `act_conv_reference` gives
    the plain stage's bits, in both contracts and types."""
    spec = StageSpec(channels=8)
    _, packed = _packed(8, seed=4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 8, 300)).astype(np.float32)).to(dtype)
    t1_dtype = torch.float32 if v1 else dtype
    f32 = torch.float32
    n, acc = 0, None
    for kb, (k, dils) in enumerate(zip(spec.kernel_sizes, spec.dilations)):
        xb = x
        for p, d in enumerate(dils):
            assert conv_site(spec, n) == (k, d) and conv_site(spec, n + 1) == (k, 1)
            t1 = act_conv_reference(xb, packed, spec, n, dtype, v1=v1, out_dtype=t1_dtype)
            if p < len(dils) - 1:
                xb = act_conv_reference(t1, packed, spec, n + 1, dtype, v1=v1, res=xb, out_dtype=f32)
            elif kb < len(spec.kernel_sizes) - 1:
                acc = act_conv_reference(t1, packed, spec, n + 1, dtype, v1=v1, res=xb, acc_in=acc, out_dtype=f32)
            else:
                y = act_conv_reference(t1, packed, spec, n + 1, dtype, v1=v1, res=xb, acc_in=acc, mean_of=3,
                                       out_dtype=dtype)
            n += 2
    want = (stage_reference_v1 if v1 else stage_reference)(x, packed, spec)
    assert n == 18 and y.dtype == want.dtype == dtype
    torch.testing.assert_close(y, want, rtol=0, atol=0)


def test_act_conv_reference_contracts():
    """One launch: v1 keeps the activation's input, taps, v and the conv's
    output float32, so on bf16 it differs from v2; float32 is one function;
    res, acc_in and mean_of enter after the conv's rounding."""
    spec = StageSpec(channels=8)
    _, packed = _packed(8, seed=6)
    rng = np.random.default_rng(7)
    src, res, acc = (torch.from_numpy(rng.standard_normal((1, 8, 120)).astype(np.float32)) for _ in range(3))
    for n in (0, 7, 17):
        f32 = [act_conv_reference(src, packed, spec, n, torch.float32, v1=v1) for v1 in (False, True)]
        torch.testing.assert_close(f32[0], f32[1], rtol=0, atol=0)
        v2, v1 = (act_conv_reference(src, packed, spec, n, torch.bfloat16, v1=v1) for v1 in (False, True))
        assert not torch.equal(v2, v1)
        assert torch.equal(v2, v2.bfloat16().float())  # the conv's output rounded to bf16 under v2
        full = act_conv_reference(src, packed, spec, n, torch.bfloat16, res=res, acc_in=acc, mean_of=3)
        torch.testing.assert_close(full, (acc + (res + v2)) / 3, rtol=0, atol=0)


@pytest.mark.parametrize("c", [8, 24, 40, 48, 96, 192, 200, 384])
def test_tc_weight_layout_unpacks_to_the_weights(c):
    """`tc_weights` holds each conv's weights, rounded to bf16, in
    [N block][tap][K chunk][KC / 8][N][8] with zeros beyond C; unpacked it
    gives the packed weights back."""
    n, blocks, kp, kc = tc_plan(c)
    assert n in stage_fused.TC_WIDTHS and n * blocks >= c and kp % 16 == 0 and kp >= c > kp - 16
    assert kp % kc == 0 and kc % 16 == 0 and (kc == 16 or kc * n * 2 <= stage_fused.TC_SLOT_BYTES)
    rng = np.random.default_rng(c)
    ks = (3, 11)
    ws = [torch.from_numpy(rng.standard_normal((k, c, c)).astype(np.float32)) for k in ks]
    flat, offsets = tc_weights(ws, c)
    assert flat.dtype == torch.bfloat16 and offsets == [0, ks[0] * blocks * n * kp]
    assert flat.numel() == sum(ks) * blocks * n * kp
    for got, w in zip(tc_unpack(flat, offsets, ks, c), ws):
        torch.testing.assert_close(got, w.bfloat16(), rtol=0, atol=0)
    # stage 0 of the first conv is tap 0, channels [0, kc) of the first N columns
    first = flat[: kc * n].view(kc // 8, n, 8).permute(1, 0, 2).reshape(n, kc)
    want = torch.zeros((n, kc), dtype=torch.bfloat16)
    want[: min(n, c), : min(kc, c)] = ws[0][0, : min(n, c), : min(kc, c)]
    torch.testing.assert_close(first, want, rtol=0, atol=0)
    assert (flat != 0).sum() == sum((w.bfloat16() != 0).sum() for w in ws)  # the padding is zero


def test_tc_plan_widths():
    assert tc_plan(192) == (192, 1, 192, 64)
    assert tc_plan(96) == (96, 1, 96, 96)
    assert tc_plan(48) == (48, 1, 48, 48)
    assert tc_plan(24) == (24, 1, 32, 32)
    assert tc_plan(40) == (48, 1, 48, 48)
    assert tc_plan(384) == (192, 2, 384, 64)
    assert tc_plan(200) == (192, 2, 208, 16)


def test_stage_arguments_are_made_once(monkeypatch):
    """The weights in the kernel's layout are made once per dtype and
    device and kept in `packed`: a second stage call casts nothing."""
    spec = StageSpec(channels=24)
    _, packed = _packed(24, seed=8)
    bf = stage_fused._k2_args(packed, spec, torch.bfloat16, torch.device("cpu"))
    assert stage_fused._k2_args(packed, spec, torch.bfloat16, torch.device("cpu")) is bf
    assert bf["plan"] == tc_plan(24) and bf["w_tc"].dtype == torch.bfloat16
    ws = tc_unpack(bf["w_tc"], bf["offsets"], [k for k in spec.kernel_sizes for _ in range(6)], 24)
    for got, w in zip(ws, packed["w"]):
        torch.testing.assert_close(got, w.bfloat16(), rtol=0, atol=0)
    f32 = stage_fused._k2_args(packed, spec, torch.float32, torch.device("cpu"))
    assert f32 is not bf and "w_tc" not in f32 and f32["w_tf32"].dtype == torch.float32
    assert stage_fused._k2_args(packed, spec, torch.float32, torch.device("cpu")) is f32
    assert list(f32["taps"][True]) == list(f32["taps"][False]) == FILT.tolist()
    assert list(bf["taps"][True]) == FILT_BF16.tolist() and list(bf["taps"][False]) == FILT.tolist()


class _Lib:
    """Records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def dmel_act_conv_tf32(self, *args):
        self.calls.append(("act_conv_tf32_kernel", args))
        return 0

    def dmel_act_conv_tc(self, *args):
        self.calls.append(("act_conv_tc_kernel", args))
        return 0


@pytest.mark.parametrize("v1", [False, True], ids=["v2", "v1"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_launches_go_to_the_kernel_of_their_dtype(monkeypatch, dtype, v1):
    """On a tensor that is not on the CPU (`meta`, with the library, the
    device check and the stream stood in for): a bf16 stage's 18 launches
    all take the tensor-core kernel with its layout's N / KP / KC, plane
    rounding only under v2 and bf16 taps only there; a float32 stage's all
    take the split-TF32 kernel. Each is counted under its kernel."""
    lib = _Lib()
    monkeypatch.setattr(library, "load", lambda: lib)
    monkeypatch.setattr(library, "check_plane", lambda x, name="x": None)
    monkeypatch.setattr(library, "stream", lambda x: 0)
    spec = StageSpec(channels=40)
    _, packed = _packed(40, seed=9)
    x = torch.empty((2, 40, 300), device="meta", dtype=dtype)
    before = amp_stage.launches, dict(amp_stage.launches_by_kernel)
    y = amp_stage(x, packed, spec, v1=v1)
    assert y.shape == x.shape and y.dtype == dtype
    kernel = "act_conv_tc_kernel" if dtype == torch.bfloat16 else "act_conv_tf32_kernel"
    assert [name for name, _ in lib.calls] == [kernel] * 18
    assert amp_stage.launches == before[0] + 18
    assert amp_stage.launches_by_kernel[kernel] == before[1][kernel] + 18
    for other in set(before[1]) - {kernel}:
        assert amp_stage.launches_by_kernel[other] == before[1][other]
    args = packed[("K2", dtype, x.device)]
    nb, _, kp, kc = tc_plan(40)
    for n, (_, a) in enumerate(lib.calls):
        k, d = conv_site(spec, n)
        if dtype == torch.bfloat16:
            assert a[2] == 2 * args["offsets"][n] and a[3:6] == (nb, kp, kc)
            assert a[16] == (3.0 if n == 17 else 1.0) and a[17] == int(not v1)
            assert a[18:23] == (2, 40, 300, k, d)
            assert list(a[23]) == (FILT.tolist() if v1 else FILT_BF16.tolist())
        else:
            plan = tf32_plan(40, k, d)
            assert a[1] == 4 * args["offsets"][n] and a[2:7] == (plan.n, plan.kp, plan.ks, plan.kc, plan.slots)
            assert a[15] == pytest.approx(3.0 if n == 17 else 1.0) and a[16:21] == (2, 40, 300, k, d)
            assert list(a[21]) == FILT.tolist()


def test_act_conv_takes_the_stage_dtype(monkeypatch):
    """`act_conv`, one launch: on the CPU its plain version; elsewhere the
    kernel of the stage dtype, with float32 planes for a float32 stage."""
    spec = StageSpec(channels=8)
    _, packed = _packed(8, seed=10)
    src = torch.from_numpy(np.random.default_rng(11).standard_normal((1, 8, 64)).astype(np.float32))
    with monkeypatch.context() as m:
        m.setattr(library, "load", lambda: pytest.fail("a CPU tensor must not reach the kernel library"))
        torch.testing.assert_close(act_conv(src, packed, spec, 3, torch.bfloat16, out_dtype=torch.bfloat16),
                                   act_conv_reference(src, packed, spec, 3, torch.bfloat16, out_dtype=torch.bfloat16),
                                   rtol=0, atol=0)
    lib = _Lib()
    monkeypatch.setattr(library, "load", lambda: lib)
    monkeypatch.setattr(library, "check_plane", lambda x, name="x": None)
    monkeypatch.setattr(library, "stream", lambda x: 0)
    meta = lambda dt: torch.empty((1, 8, 64), device="meta", dtype=dt)  # noqa: E731
    out = act_conv(meta(torch.bfloat16), packed, spec, 5, torch.bfloat16, res=meta(torch.float32),
                   acc_in=meta(torch.float32), mean_of=3, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and lib.calls[-1][0] == "act_conv_tc_kernel"
    act_conv(meta(torch.float32), packed, spec, 5, torch.float32, res=meta(torch.float32))
    assert lib.calls[-1][0] == "act_conv_tf32_kernel"
    with pytest.raises(TypeError, match="float32"):
        act_conv(meta(torch.bfloat16), packed, spec, 5, torch.float32)
    with pytest.raises(TypeError, match="float32"):
        act_conv(meta(torch.bfloat16), packed, spec, 5, torch.bfloat16, acc_in=meta(torch.bfloat16))
    assert len(lib.calls) == 2
