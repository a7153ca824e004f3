"""The host side of the redesigned K1 and K2-v1 kernels, against plain
arithmetic: K1's launch plan (units of 256 outputs from the row's first
16-byte-aligned sample, a head unit before it, 16-byte vectors on the body
and element by element off it), K2-v1's bf16 plan (W per block within the
shared-memory budget, clusters whose stored tiles partition [0, T)), and a
plain PyTorch model of K2-v1's cluster schedule (tile by tile, every
operation's halo taken from the neighbour tile, the cluster window's ends
as the signal's) against `stage_reference_v1` and the JAX v1 kernel in
interpret mode.

The kernels themselves run only on the card; chip_smoke.py holds them to
their plain versions there.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dmel_codec_tpu.ops.stage_fused import StageSpec as JaxStageSpec
from dmel_codec_tpu.ops.stage_fused import fused_amp_stage as jax_fused_amp_stage
from dmel_codec_tpu_torch.ops import stage_fused
from dmel_codec_tpu_torch.ops.anti_alias import RUN, UNIT, activation_chain, k1_plan, k1_row_units
from dmel_codec_tpu_torch.ops.stage_fused import StageSpec, conv_site, stage_reference_v1
from tests.test_torch_stage_v1 import _packed
from tests.test_torch_support import strict_f32  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("strict_f32")

SMEM = 227 * 1024  # what the library reports on sm_90
# the main path's T: s0, s1 and act_post of a request and of a streaming window
MAIN_T = (1488, 5952, 95232, 2240, 8960, 143360)


def _coverage(t: int, itemsize: int, x0: int, rows: int = 3, vec: bool = True) -> None:
    for row in range(rows):
        seen = np.zeros(t, dtype=np.int64)
        for seg, lanes in k1_row_units(t, itemsize, x0, row, vec):
            assert [tl for tl, _ in lanes] == [seg + RUN * lane for lane in range(32)]
            for tl, vector in lanes:
                outs = np.arange(tl, tl + RUN)
                inside = outs[(outs >= 0) & (outs < t)]
                seen[inside] += 1
                if vector:  # every access in bounds and on a 16-byte boundary
                    assert 0 <= tl and tl + RUN <= t
                    assert ((x0 + row * t + tl) * itemsize) % 16 == 0
        assert (seen == 1).all(), (t, itemsize, x0, row, np.flatnonzero(seen != 1)[:5])


@pytest.mark.parametrize("itemsize", [2, 4])
def test_k1_plan_covers_each_output_once(itemsize):
    """T = 1..64 and the main path's T, x at every phase of a 16-byte
    boundary, with and without vectors: each output of each row is computed
    once, and every vectorised lane reads and writes 16 aligned bytes
    inside the row."""
    for t in (*range(1, 65), *MAIN_T):
        for x0 in range(0, 16 // itemsize):
            _coverage(t, itemsize, x0)
        _coverage(t, itemsize, 1, vec=False)


def test_k1_plan_main_path_is_aligned():
    """The main path's rows are all 16-byte aligned in both dtypes: no head
    unit, and every lane of a full unit inside the row is vectorised."""
    for t in MAIN_T:
        for itemsize in (2, 4):
            assert k1_plan(t, itemsize) == (-(-t // UNIT), 0)
            units = k1_row_units(t, itemsize, 0, 5)
            assert units[0][0] == 0
            assert all(v for seg, lanes in units for tl, v in lanes if tl + RUN <= t)
    assert k1_plan(37, 2) == (2, 1) and k1_plan(1000, 4, x0=1) == (5, 1)


@pytest.mark.parametrize("c", [5, 7, 24, 40, 48])
def test_v1_tc_plan_fits_shared_memory(c):
    """The bf16 block at the chosen W fits 227 KB beside its halo, and the
    next W (256 more) would not, up to the cap of 1024."""
    spec = StageSpec(channels=c)
    n, kp, w = stage_fused.v1_tc_plan(c, spec, SMEM)
    assert n >= c and n in (24, 32, 48) and kp % 16 == 0 and kp >= c
    assert w % 256 == 0 and 256 <= w <= 1024
    assert stage_fused.v1_tc_bytes(c, kp, n, w, 11) <= SMEM
    assert w == 1024 or stage_fused.v1_tc_bytes(c, kp, n, w + 256, 11) > SMEM
    assert (c, w) not in ((48, 256), (24, 512)) or stage_fused.V1_CLUSTER * w - 2 * spec.receptive > 0
    # the layout as the kernel adds it up: two float32 planes, the bf16 plane, one conv's weights, scratch
    lw, ra = w + 16, w + 64
    parts = [4 * c * lw, 4 * c * lw, 2 * kp * ra, 2 * 11 * kp * n]
    assert stage_fused.v1_tc_bytes(c, kp, n, w, 11) == sum(-(-p // 128) * 128 for p in parts) + 4 * 16 * 2 * 136 + 144


@pytest.mark.parametrize("c", [24, 48])
def test_v1_tc_tiles_partition_the_signal(c):
    """Stored tiles of all clusters partition [0, T), each lies in its
    cluster's window beyond R of a cut (a window end inside the signal)."""
    spec = StageSpec(channels=c)
    _, _, w = stage_fused.v1_tc_plan(c, spec, SMEM)
    r = spec.receptive
    for t in (1, 37, 700, 1000, 2047, 2049, 47616, 71680, 143360):
        seen = np.zeros(t, dtype=np.int64)
        for wlo, n, stored in stage_fused.v1_tc_tiles(t, w, stage_fused.V1_CLUSTER, r):
            assert 0 <= wlo and wlo + n <= t and n <= stage_fused.V1_CLUSTER * w
            for lo, hi in stored:
                seen[lo:hi] += 1
                assert lo >= (wlo if wlo == 0 else wlo + r)
                assert hi <= (wlo + n if wlo + n == t else wlo + n - r)
        assert (seen == 1).all(), t


def _cluster_model(x: torch.Tensor, packed: dict, spec: StageSpec, w: int, g: int) -> torch.Tensor:
    """K2-v1's bf16 schedule in plain PyTorch, with the plain version's
    arithmetic: per cluster window, per tile of w columns, each operation
    computes the tile's own columns only, from its input plus the halo the
    kernel pulls from the neighbour tiles (8 columns of the activation's
    input, 32 of the conv's); beyond the window the activation replicates
    (a segment ending there) and the conv sees zeros."""
    xh, pa = 8, 32
    bsz, c, t = x.shape
    dtype = x.dtype
    rnd = lambda v: v.to(dtype).float()  # noqa: E731
    y = torch.empty_like(x)
    n_blk = len(spec.kernel_sizes)
    for wlo, n, stored in stage_fused.v1_tc_tiles(t, w, g, spec.receptive):
        live = [r for r in range(g) if r * w < n]

        def act(src, n_conv):  # src: [g] planes of local columns [-xh, w + xh) -> bf16-rounded a, [-pa, w + pa)
            a = packed["a"][:, n_conv, None].float()
            ib = packed["ib"][:, n_conv, None].float()

            def snake_fn(u):
                s = torch.sin(u * a)
                return u + ib * s * s

            out = []
            for r in range(g):
                plane = torch.zeros((bsz, c, w + 2 * pa))
                if r in live:
                    lo, hi = max(-xh, -r * w), min(w + xh, n - r * w)
                    v = rnd(activation_chain(src[r][..., xh + lo: xh + hi], snake_fn, False))
                    own = min(w, n - r * w)
                    plane[..., pa: pa + own] = v[..., -lo: -lo + own]
                out.append(plane)
            return _pull_a(out)

        def _pull_a(planes):  # the conv input's halo rows from the neighbours, zeros beyond the cluster
            out = []
            for r in range(g):
                p = planes[r].clone()
                p[..., :pa] = planes[r - 1][..., w: w + pa] if r > 0 else 0.0
                p[..., w + pa:] = planes[r + 1][..., pa: 2 * pa] if r < g - 1 else 0.0
                out.append(p)
            return out

        def conv(a_planes, n_conv, res=None):
            k, d = conv_site(spec, n_conv)
            p_reach = d * (k - 1) // 2
            wt = packed["w"][n_conv].to(dtype).float().permute(1, 2, 0)
            out = []
            for r in range(g):
                seg = a_planes[r][..., pa - p_reach: pa + w + p_reach]
                v = F.conv1d(seg, wt, packed["b"][:, n_conv].float(), dilation=d)
                plane = torch.zeros((bsz, c, w + 2 * xh))
                plane[..., xh: xh + w] = v if res is None else res[r][..., xh: xh + w] + v
                out.append(plane)
            return _pull_cols(out)

        def _pull_cols(planes):  # the activation input's halo columns from the neighbours
            out = []
            for r in range(g):
                p = planes[r].clone()
                if r > 0:
                    p[..., :xh] = planes[r - 1][..., w: w + xh]
                if r < g - 1:
                    p[..., w + xh:] = planes[r + 1][..., xh: 2 * xh]
                out.append(p)
            return out

        n_conv = 0
        acc = None
        for kb, dils in enumerate(spec.dilations):
            xb = []
            for r in range(g):  # x on local columns [-xh, w + xh), clamped to the signal
                cols = torch.arange(-xh, w + xh) + wlo + r * w
                xb.append(x.float()[..., cols.clamp(0, t - 1)])
            for _ in dils:
                t1 = conv(act(xb, n_conv), n_conv)
                xb = conv(act(t1, n_conv + 1), n_conv + 1, res=xb)
                n_conv += 2
            whole = torch.cat([p[..., xh: xh + w] for p in xb], dim=-1)  # window columns [0, g w)
            acc = whole if acc is None else acc + whole
            if kb == n_blk - 1:
                acc = acc / n_blk
        for lo, hi in stored:
            y[..., lo:hi] = acc[..., lo - wlo: hi - wlo].to(dtype)
    return y


@pytest.mark.parametrize("w,g", [(512, 8), (64, 4)])
def test_cluster_schedule_equals_plain_v1(w, g):
    """float32, C = 24, T = 700: the kernel's plan (one cluster, three live
    tiles) and a small one (eleven clusters of 4 x 64) give
    `stage_reference_v1`'s bits."""
    _, tp = _packed(24, seed=24)
    spec = StageSpec(channels=24)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 24, 700)).astype(np.float32))
    torch.testing.assert_close(_cluster_model(x, tp, spec, w, g), stage_reference_v1(x, tp, spec), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cluster_schedule_matches_jax_v1_kernel(dtype):
    """Against the JAX v1 kernel in interpret mode, as
    test_plain_v1_matches_jax_interpret_kernel holds the plain version:
    float32 1e-5 abs; bf16 one bf16 ulp of the largest output."""
    c, t = 24, 2000
    jp, tp = _packed(c, seed=c)
    x = np.random.default_rng(t).standard_normal((2, t, c)).astype(np.float32)
    spec = JaxStageSpec(channels=c)
    xt = torch.from_numpy(x).transpose(1, 2).contiguous()
    if dtype == "f32":
        want = np.asarray(jax_fused_amp_stage(jnp.asarray(x), jp, spec, interpret=True, tile_w=512))
        got = _cluster_model(xt, tp, StageSpec(channels=c), 64, 8).transpose(1, 2).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        want = jax_fused_amp_stage(jnp.asarray(x).astype(jnp.bfloat16), jp, spec, interpret=True, tile_w=512)
        want = np.asarray(want.astype(jnp.float32))
        got = _cluster_model(xt.bfloat16(), tp, StageSpec(channels=c), 64, 8).float().transpose(1, 2).numpy()
        assert np.abs(got - want).max() <= 2.0**-7 * np.abs(want).max()
