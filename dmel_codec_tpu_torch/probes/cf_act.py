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
(csrc/probes.cu, `dmel_cf_act`), one block per (window of `w` samples,
channel tile, batch row), or raises. Any T; no padding of T to a multiple
of `w`.

    python -m dmel_codec_tpu_torch.probes.cf_act

checks the kernel against its plain version and prints ms per launch at the
JAX probe's three shapes (bfloat16) for w in (256, 512, 1024, 2048, 4096),
beside K1 at the same shape and the byte bound. It raises if a window's
result is more than one bfloat16 ulp from the plain version's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dmel_codec_tpu_torch.ops import library
from dmel_codec_tpu_torch.ops.anti_alias import FILT, anti_alias_activation
from dmel_codec_tpu_torch.probes.timing import PEAK_BYTES, cuda_ms, require_gpu

SHAPES = ((16, 96, 24064), (16, 48, 48128), (16, 24, 96256))  # [B, C, T], the JAX probe's
WINDOWS = (256, 512, 1024, 2048, 4096)
MAX_WINDOW = 16384  # one channel's float32 tile of 3 w + 28 values must fit in 227 KB
_PAD = 6  # the chain's reach per side


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
    """[B, C, T] -> [B, C, T]; `w` is the window one block stages."""
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


def bound_ms(shape, itemsize: int = 2) -> float:
    """Least time by bytes: the plane in once and out once."""
    b, c, t = shape
    return 2 * b * c * t * itemsize / PEAK_BYTES * 1e3


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
          + f"{'K1':>9}{'bound':>9}{'max err':>10}   (ms, bf16; err vs plain over the windows)")
    table = {}
    for shape in SHAPES:
        err = check_windows(shape)
        ms = table[shape] = time_windows(shape)
        print(f"{str(list(shape)):<20}" + "".join(f"{ms[w]:>9.4f}" for w in WINDOWS)
              + f"{ms['K1']:>9.4f}{bound_ms(shape):>9.4f}{err:>10.2e}", flush=True)
    return table


if __name__ == "__main__":
    main()
