"""Probe K1's tiling: one anti-aliased snake on channels-first [B, C, T]
with the time tile as an argument (port of `scripts/exp_cf_act.py`).

`cf_act_windowed(x, a_col, ib_col, w)` computes, with x replicate-clamped to
[0, T) and f the 12 kaiser-sinc taps,

    u_e[s] = 2 sum_i f[2i+1] x[s+2-i]      u_o[s] = 2 sum_i f[2i] x[s+3-i]
    v      = u + ib * sin^2(a * u)
    y[t]   = sum_i f[2i+1] v_e[t+i-2] + f[2i] v_o[t+i-3]          i = 0..5

for `a_col` = alpha and `ib_col` = 1 / (beta + 1e-9) given as [1, C, 1]
columns (not log-scale). These are interior semantics: within 6 samples of
either end the result differs from `anti_alias_activation` (K1), which
replicates the POST-snake signal there. On a CPU tensor it runs the plain
version `cf_act_reference`; on a CUDA tensor it launches kernel P1
(csrc/probes.cu, `dmel_cf_act`: K1's warps over register windows, a warp
task spanning `units_per_task(w)` units of 256 outputs of a row), or raises.
Any T; no padding of T to a multiple of `w`; the result does not depend on
`w`.

    python -m dmel_codec_tpu_torch.probes.cf_act

checks the kernel against its plain version and prints ms per launch at the
JAX probe's three shapes (bfloat16) for w in (256, 512, 1024, 2048, 4096),
beside K1 at the same shape and the bounds by bytes and by operations. It
raises if a window's result is more than one bfloat16 ulp from the plain
version's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dmel_codec_tpu_torch.ops import library
from dmel_codec_tpu_torch.ops.anti_alias import FILT, anti_alias_activation
from dmel_codec_tpu_torch.probes.timing import PEAK_BYTES, PEAK_F32, cuda_ms, require_gpu

SHAPES = ((16, 96, 24064), (16, 48, 48128), (16, 24, 96256))  # [B, C, T], the JAX probe's
WINDOWS = (256, 512, 1024, 2048, 4096)
MAX_WINDOW = 16384  # a task of at most 64 units of 256 outputs
UNIT = 256  # outputs a warp computes at once (32 lanes x 8)
_PAD = 6  # the chain's reach per side
# float32 operations the function needs per output sample (an FMA counts
# two): the two 6-tap up FIRs and the 12-tap down FIR (24 FMAs, of which
# each of the three chains' first is a multiply: 45; the up FIRs' gain of 2
# goes into their taps, exactly), two snakes (a u, ib s, then s + u by one
# FMA: 4 each) and two sines at sinf's fast path (the quadrant's multiply,
# add and subtract, the three-part reduction's 3 FMAs, r^2, one polynomial
# of 4 FMAs: 18 each)
FLOPS_PER_SAMPLE = 45 + 2 * 4 + 2 * 18


def cf_act_reference(x: torch.Tensor, a_col: torch.Tensor, ib_col: torch.Tensor) -> torch.Tensor:
    """Plain version: float32 arithmetic, result in x's dtype."""
    t = x.shape[-1]
    f = [float(v) for v in FILT]
    a = a_col.float().reshape(1, -1, 1)
    ib = ib_col.float().reshape(1, -1, 1)
    xp = F.pad(x.float(), (_PAD, _PAD), mode="replicate")  # xp[j] = x[clamp(j - 6)]
    n = t + 6  # half-rate indices s = -3 .. t + 2
    u_e = sum(2.0 * f[2 * i + 1] * xp[..., 5 - i : 5 - i + n] for i in range(6))
    u_o = sum(2.0 * f[2 * i] * xp[..., 6 - i : 6 - i + n] for i in range(6))
    v_e = u_e + ib * torch.sin(a * u_e) ** 2
    v_o = u_o + ib * torch.sin(a * u_o) ** 2
    y = sum(f[2 * i + 1] * v_e[..., i + 1 : i + 1 + t] + f[2 * i] * v_o[..., i : i + t] for i in range(6))
    return y.to(x.dtype)


def cf_act_windowed(x: torch.Tensor, a_col: torch.Tensor, ib_col: torch.Tensor, w: int = 2048) -> torch.Tensor:
    """[B, C, T] -> [B, C, T]; `w` is the span of a row one warp task
    covers (in whole units of 256 outputs)."""
    if not 1 <= w <= MAX_WINDOW:
        raise ValueError(f"the window must be 1..{MAX_WINDOW} samples, got {w}")
    if x.device.type == "cpu":
        return cf_act_reference(x, a_col, ib_col)
    lib = library.load()
    library.check_plane(x)
    b, c, t = x.shape
    a = library.channel_vector(a_col.reshape(-1), x, c)
    ib = library.channel_vector(ib_col.reshape(-1), x, c)
    y = torch.empty_like(x)
    rc = lib.dmel_cf_act(
        x.data_ptr(), y.data_ptr(), a.data_ptr(), ib.data_ptr(), b, c, t, w,
        int(x.dtype == torch.bfloat16), library.taps(FILT), library.stream(x),
    )
    library.check(lib, rc, "dmel_cf_act")
    cf_act_windowed.launches += 1
    return y


cf_act_windowed.launches = 0  # P1 launches, counted where the kernel is launched


def units_per_task(w: int) -> int:
    """Units of 256 outputs of a row that one warp task of the kernel spans
    for window `w`."""
    return -(-w // UNIT)


def bound_ms(shape, itemsize: int = 2) -> float:
    """Least time by bytes: the plane in once and out once."""
    b, c, t = shape
    return 2 * b * c * t * itemsize / PEAK_BYTES * 1e3


def ops_bound_ms(shape) -> float:
    """Least time by operations: FLOPS_PER_SAMPLE per output sample at the
    float32 rate (67 TFLOP/s)."""
    b, c, t = shape
    return FLOPS_PER_SAMPLE * b * c * t / PEAK_F32 * 1e3


def _inputs(shape, dtype, device):
    """Seeded x, alpha, beta, 1 / (beta + 1e-9) at `shape`."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(shape, device=device, generator=gen).to(dtype)
    alpha = torch.exp(0.1 * torch.randn(shape[1], device=device, generator=gen))
    beta = torch.exp(0.1 * torch.randn(shape[1], device=device, generator=gen))
    return x, alpha, beta, 1.0 / (beta + 1e-9)


def check_windows(shape, dtype=torch.bfloat16, device="cuda") -> float:
    """Largest |P1 - plain| over every window at `shape`; raises beyond one
    ulp of `dtype` (bfloat16) or 2e-5 (float32) of max(1, max |plain|)."""
    x, alpha, _, ib = _inputs(shape, dtype, device)
    want = cf_act_reference(x, alpha, ib).float()
    tol = (2.0**-7 if dtype == torch.bfloat16 else 2e-5) * max(1.0, float(want.abs().max()))
    worst = 0.0
    for w in WINDOWS:
        err = float((cf_act_windowed(x, alpha, ib, w).float() - want).abs().max())
        if not err <= tol:
            raise AssertionError(f"cf_act_windowed {list(shape)} w = {w}: max abs err {err:.3e} > {tol:.3e} vs plain")
        worst = max(worst, err)
    return worst


def time_windows(shape, dtype=torch.bfloat16, reps: int = 10, device="cuda") -> dict:
    """Mean ms per launch of P1 at `shape` for every window, and of K1 ("K1")."""
    x, alpha, beta, ib = _inputs(shape, dtype, device)
    out = {w: cuda_ms(lambda w=w: cf_act_windowed(x, alpha, ib, w), reps) for w in WINDOWS}
    out["K1"] = cuda_ms(lambda: anti_alias_activation(x, alpha, beta, False), reps)
    return out


def main() -> dict:
    """Checks every shape and window against the plain version (raising on
    a disagreement), prints the table; returns {shape: {w: ms, "K1": ms}}."""
    require_gpu("cf_act")
    print(torch.cuda.get_device_name(0))
    print(f"{'shape':<20}" + "".join(f"{'w=' + str(w):>9}" for w in WINDOWS)
          + f"{'K1':>9}{'bytes':>9}{'ops':>9}{'max err':>10}   (ms, bf16; bounds by bytes and by operations; "
          "err vs plain over the windows)")
    table = {}
    for shape in SHAPES:
        err = check_windows(shape)
        ms = table[shape] = time_windows(shape)
        print(f"{str(list(shape)):<20}" + "".join(f"{ms[w]:>9.4f}" for w in WINDOWS)
              + f"{ms['K1']:>9.4f}{bound_ms(shape):>9.4f}{ops_bound_ms(shape):>9.4f}{err:>10.2e}", flush=True)
    return table


if __name__ == "__main__":
    main()
