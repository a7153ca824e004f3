"""The probe kernels on the card: P1, P2 / P3 and P4 against their plain
versions at the shapes the probes time and at ragged ones, P1 against K1,
and the probes' own checks (`card`: see tests/card.py)."""

from __future__ import annotations

import pytest
import torch

from dmel_codec_tpu_torch.ops.anti_alias import anti_alias_activation
from dmel_codec_tpu_torch.probes import cf_act, sublane_ops
from tests.card import TOL_P1, TOL_P4, check_close, max_err, on_card

pytestmark = pytest.mark.card

F32, BF16 = torch.float32, torch.bfloat16
P1_CASES = ([((2, 24, 4096), (1024,), F32)]
            # the probe's main path: its three shapes at every window it times (bf16); float32 at one
            + [(shape, cf_act.WINDOWS, BF16) for shape in cf_act.SHAPES]
            + [(shape, (2048,), F32) for shape in cf_act.SHAPES]
            + [(shape, (1, 16, 256, 1000, 4096, cf_act.MAX_WINDOW), dt)
               for shape in ((1, 5, 1), (3, 7, 37), (2, 3, 700)) for dt in (F32, BF16)]
            + [((2, 96, 5000), cf_act.WINDOWS, dt) for dt in (F32, BF16)]
            # where the warp-unit kernel branches: odd C (rows off 16-byte boundaries), T around one unit of
            # 256 outputs and a 16-byte vector, tasks of one unit (w up to 256), two (257) and 64 (16384)
            + [((2, 5, t), (1, 255, 256, 257, cf_act.MAX_WINDOW), dt) for t in (7, 8, 9, 255, 257)
               for dt in (F32, BF16)])
ROWS_CASES = [((sublane_ops.ROWS, sublane_ops.LANES), sublane_ops.OUT_ROWS),
              ((3, sublane_ops.ROWS, sublane_ops.LANES), sublane_ops.OUT_ROWS),
              ((sublane_ops.FILL_PLANES, sublane_ops.ROWS, sublane_ops.LANES), sublane_ops.OUT_ROWS),
              ((2, 50, 33), 17), ((1, 10, 1), 1), ((2, 5000, 300), 1000),
              # where the kernel branches: rows = out_rows + 9, column counts off the float4 path and odd
              # plane counts (planes off 16-byte boundaries), a ragged last row tile, and 4,096 planes
              *(((3, 59, cols), 50) for cols in (1, 2, 3, 5, 300)),
              ((3, sublane_ops.OUT_ROWS + 9, sublane_ops.LANES), sublane_ops.OUT_ROWS),
              ((4096, sublane_ops.OUT_ROWS + 9, sublane_ops.LANES), sublane_ops.OUT_ROWS)]
MM, OUT, TAPS, STEP, FILL = sublane_ops.MM_ROWS, sublane_ops.MM_OUT, sublane_ops.TAPS, sublane_ops.STEP, \
    sublane_ops.FILL_PLANES
P4_CASES = [((MM, 96), (96, 96), OUT, TAPS, STEP), ((3, MM, 96), (96, 96), OUT, TAPS, STEP),
            ((FILL, MM, 96), (96, 96), OUT, TAPS, STEP), ((2, 300, 32), (32, 24), 100, 5, 3),
            ((1, 16, 16), (16, 8), 1, 1, 8), ((2, 700, 128), (128, 128), 130, 7, 8),
            ((FILL, MM, 192), (192, 192), OUT, TAPS, STEP), ((3, 1000, 192), (192, 192), 900, TAPS, STEP),
            ((2, 1200, 256), (256, 256), 1000, TAPS, STEP), ((2, 500, 192), (192, 192), 300, 11, 4),
            ((2, 400, 160), (160, 224), 300, 5, 16), ((2, 300, 64), (64, 32), 200, 3, 8)]


def _cf_inputs(shape, dev):
    gen = torch.Generator(device=dev).manual_seed(shape[2])
    c = shape[1]
    alpha = torch.exp(0.1 * torch.randn(c, device=dev, generator=gen))
    beta = torch.exp(0.1 * torch.randn(c, device=dev, generator=gen))
    return torch.randn(shape, device=dev, generator=gen), alpha, beta, 1.0 / (beta + 1e-9)


@pytest.mark.parametrize("shape,windows,dt", P1_CASES, ids=[f"{list(s)}-{dt}" for s, _, dt in P1_CASES])
def test_p1_matches_plain(shape, windows, dt):
    """At the probe's three shapes every window it times (`cf_act.main`'s own check), in bf16 within one ulp."""
    dev = on_card()
    x32, alpha, _, inv_beta = _cf_inputs(shape, dev)
    x = x32.to(dt)
    want = cf_act.cf_act_reference(x, alpha, inv_beta)
    for w in windows:
        got = cf_act.cf_act_windowed(x, alpha[None, :, None], inv_beta[None, :, None], w)
        check_close(f"P1 w = {w}", got, want, TOL_P1[dt])


P1_K1_CASES = [(shape, windows[0]) for shape, windows, dt in P1_CASES if dt == F32 and shape[2] > 32]


@pytest.mark.parametrize("shape,w", P1_K1_CASES, ids=[f"{list(s)}-w{w}" for s, w in P1_K1_CASES])
def test_p1_is_k1_in_the_interior(shape, w):
    """P1 against K1 beyond 16 samples from the ends, float32; at the ends
    they differ (P1 has interior semantics)."""
    dev = on_card()
    x, alpha, beta, inv_beta = _cf_inputs(shape, dev)
    got = cf_act.cf_act_windowed(x, alpha, inv_beta, w)
    k1 = anti_alias_activation(x, alpha, beta, False)
    check_close("P1 vs K1", got[:, :, 16:-16], k1[:, :, 16:-16], TOL_P1[F32])
    assert max_err(got, k1) > 1e-4


@pytest.mark.parametrize("shape,out_rows", ROWS_CASES, ids=[f"{list(s)}-{r}" for s, r in ROWS_CASES])
def test_p2_p3_give_the_plain_bits(shape, out_rows):
    dev = on_card()
    x = torch.randn(shape, device=dev, generator=torch.Generator(device=dev).manual_seed(20))
    for fn, ref in ((sublane_ops.slice_rows, sublane_ops.slice_reference),
                    (sublane_ops.roll_rows, sublane_ops.roll_reference)):
        got, want = fn(x, out_rows), ref(x, out_rows)
        assert torch.equal(got, want), (fn.__name__, max_err(got, want))
    if shape[-2] == sublane_ops.ROWS:  # two functions: the roll wraps to the plane's end
        assert max_err(sublane_ops.roll_rows(x), sublane_ops.slice_rows(x)) > 1.0


@pytest.mark.parametrize("x_shape,w_shape,out_rows,taps,step", P4_CASES,
                         ids=[f"{list(c[0])}@{list(c[1])}-{c[3]}x{c[4]}" for c in P4_CASES])
def test_p4_matches_plain(x_shape, w_shape, out_rows, taps, step):
    """P4 on the kernel `tap_matmul_path` names for the shape."""
    dev = on_card()
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(x_shape, device=dev, generator=gen).to(BF16)
    w = torch.randn(w_shape, device=dev, generator=gen).to(BF16)
    path = sublane_ops.tap_matmul_path(w_shape[0], w_shape[1], taps, step)
    before = dict(sublane_ops.tap_matmul.launches_by_path)
    got = sublane_ops.tap_matmul(x, w, out_rows, taps, step)
    assert sublane_ops.tap_matmul.launches_by_path[path] == before[path] + 1
    check_close(f"P4 ({path} kernel)", got, sublane_ops.tap_matmul_reference(x, w, out_rows, taps, step), TOL_P4)


@pytest.mark.parametrize("planes", [1, FILL])
def test_p2_p3_p4_probe_checks(planes):
    """The probe's own checks at both plane counts it times (P2 and P3 the
    plain bits, their library calls within 1e-6, P3 not P2, P4 within
    MM_TOL at C = 96 and 192), P2 and P3 in a CUDA graph the plain bits;
    the probe's P4 shapes (11 taps of step 8 at C = 96 and 192) run on the
    wgmma kernel only."""
    dev = on_card()
    before = dict(sublane_ops.tap_matmul.launches_by_path)
    sublane_ops.check_probes(planes, dev)
    after = sublane_ops.tap_matmul.launches_by_path
    assert after["mma"] == before["mma"] and after["wgmma"] == before["wgmma"] + len(sublane_ops.WIDTHS), after
    for fn in (sublane_ops.slice_rows, sublane_ops.roll_rows):
        sublane_ops.device_ms(fn, planes, reps=1, device=dev)
