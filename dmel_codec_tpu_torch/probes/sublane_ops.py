"""Probe row-shifted reads of a resident plane and the tap-matmul form of a
conv (port of `scripts/exp_sublane_ops.py`). With rows the time axis and
columns the channels, and off over OFFSETS = (0, 1, 3, 5, 7, 9):

  slice_rows   y[i] = sum_off x[i + off]               i < out_rows   (P2)
  roll_rows    y[i] = sum_off x[(i - off) mod rows]    i < out_rows   (P3)
  tap_matmul   y = sum_{i < taps} x[step*i : step*i + out_rows] @ w   (P4)

P2 and P3 take float32 planes [rows, cols] and add in the order of
OFFSETS, so they equal the JAX kernels to the bit. P3 is `np.roll`'s
rotate of the whole plane and NOT P2's sum (the two differ wherever
i < 9). P4 takes bfloat16 operands x [rows, K], w [K, N] (K a multiple of
16, N of 8, both up to 256) and accumulates in float32. Every function also
takes a leading planes axis [P, ...], so that a timing can fill the card;
P = 1 is the JAX probe's case. On a CPU tensor each runs its plain version
(`slice_reference`, `roll_reference`, `tap_matmul_reference`); on a CUDA
tensor it launches its kernel (csrc/probes.cu: `dmel_rows_slice`,
`dmel_rows_roll`, `dmel_tap_matmul`) or raises.

P4 has two kernels, chosen by shape alone (`tap_matmul_path`), never by a
failed build or launch: "wgmma", the Hopper kernel (TMA-staged,
64-byte-swizzled tiles of 128 rows x all of N, `wgmma.mma_async`), where K
and N are multiples of 32, step a multiple of 8 and 128 + step * (taps - 1)
<= 256 (the flagship 11 taps of step 8 at C = 96 and 192 among them); else
"mma", the general `mma.sync` kernel (64 rows per block). Each launch counts
in `tap_matmul.launches` and in `tap_matmul.launches_by_path[path]`.

    python -m dmel_codec_tpu_torch.probes.sublane_ops

checks the three against their plain versions at the JAX probe's shapes
(x [1280, 96] -> [112, 96]; x [2176, C] @ w [C, C], 11 taps -> [1024, C],
C = 96 as the JAX probe and C = 192, K2's widest fused stage) at P = 1 and
P = 264, raising if P2 or P3 differ from plain by a bit or P4 by more than
1e-4 of max |y|, and prints ms per launch at both beside the bounds: for
P2 and P3 both the time per wrapper call (CUDA events around back-to-back
calls: the host's cost per call where it exceeds the kernel's) and the
device time per launch (`device_ms`: launches captured in one CUDA graph
and replayed, the input rotated over sets of planes that together exceed
the 50 MB L2), and the wrapper's host cost part by part (`host_us`).
Beside P2 and P3 it times one PyTorch call of the same function each, a
yardstick only (`slice_library`: a depthwise `F.conv1d` with 0/1 taps on
the rows P2 reads; `roll_library`: a depthwise circular `nn.Conv1d` with
0/1 taps; both held to plain within LIBRARY_TOL).
"""

from __future__ import annotations

import time

import torch

from dmel_codec_tpu_torch.ops import library
from dmel_codec_tpu_torch.probes.timing import PEAK_BF16, PEAK_BYTES, cuda_ms, require_gpu

OFFSETS = (0, 1, 3, 5, 7, 9)
ROWS, LANES, OUT_ROWS = 1280, 96, 112        # P2 / P3 at the JAX probe's shape
MM_ROWS, MM_OUT, TAPS, STEP = 2176, 1024, 11, 8  # P4
FILL_PLANES = 264  # two blocks' worth of planes per SM of an H100
MM_TOL = 1e-4  # of max |y|: only the order of 11 x C float32 additions differs from plain
MM_MAX = 256  # K, N
WG_ROWS, WG_MAX_ROWS = 128, 256  # the wgmma kernel's output rows per tile; TMA's largest box
WIDTHS = (96, 192)  # C of the timed P4 shapes: the JAX probe's, and K2's widest fused stage
LIBRARY_TOL = 1e-6  # of max(1, max |y|): six float32 additions in another order than plain's


def slice_reference(x: torch.Tensor, out_rows: int = OUT_ROWS) -> torch.Tensor:
    acc = x[..., 0:out_rows, :].float()
    for off in OFFSETS[1:]:
        acc = acc + x[..., off : off + out_rows, :].float()
    return acc


def roll_reference(x: torch.Tensor, out_rows: int = OUT_ROWS) -> torch.Tensor:
    rows = x.shape[-2]
    i = torch.arange(out_rows, device=x.device)
    acc = x[..., :out_rows, :].float()
    for off in OFFSETS[1:]:
        acc = acc + x[..., (i - off) % rows, :].float()
    return acc


def slice_library(device, cols: int = LANES):
    """P2 as one PyTorch call: `F.conv1d` with depthwise taps 1 at each of
    OFFSETS and 0 elsewhere, on the rows P2 reads channels-first, [P, cols,
    out_rows + 9] contiguous (the returned function takes that); its output
    i is sum_off x[i + off]."""
    taps = torch.zeros(cols, 1, OFFSETS[-1] + 1, device=device)
    taps[:, 0, list(OFFSETS)] = 1.0
    return lambda x_cf: torch.nn.functional.conv1d(x_cf, taps, groups=cols)


def roll_library(device, cols: int = LANES) -> torch.nn.Module:
    """P3 as one PyTorch module: a depthwise `nn.Conv1d(cols, cols, 10,
    groups=cols, padding=9, padding_mode="circular", bias=False)` whose tap
    9 - off is 1 for each of OFFSETS and the others 0, on the plane
    channels-first [P, cols, rows]: its output i is sum_off x[(i - off) mod
    rows]; P3's rows are the view [..., :out_rows]."""
    span = OFFSETS[-1]
    conv = torch.nn.Conv1d(cols, cols, span + 1, groups=cols, padding=span, padding_mode="circular", bias=False,
                           device=device)
    with torch.no_grad():
        conv.weight.zero_()
        conv.weight[:, 0, [span - off for off in OFFSETS]] = 1.0
    return conv.requires_grad_(False)


def tap_matmul_reference(
    x: torch.Tensor, w: torch.Tensor, out_rows: int = MM_OUT, taps: int = TAPS, step: int = STEP
) -> torch.Tensor:
    """Float32 products of the operands as they are (bfloat16 values are
    exact in float32), summed over the taps."""
    wf = w.float()
    return sum(x[..., step * i : step * i + out_rows, :].float() @ wf for i in range(taps))


def _dims(x: torch.Tensor, dtype: torch.dtype, name: str) -> tuple:
    """(P, rows, cols) of `x`, which must be a contiguous [rows, cols] (P = 1)
    or [P, rows, cols] tensor of `dtype` on a CUDA device."""
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() not in (2, 3) or x.numel() == 0:
        raise ValueError(f"{name} must be a non-empty [rows, cols] or [P, rows, cols] tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return (1, *x.shape) if x.dim() == 2 else tuple(x.shape)


def _planes(x: torch.Tensor, dtype: torch.dtype, name: str) -> torch.Tensor:
    """`x` as contiguous [P, rows, cols] of `dtype` on a CUDA device."""
    _dims(x, dtype, name)
    return x if x.dim() == 3 else x[None]


def _rows_op(x: torch.Tensor, out_rows: int, symbol: str, wrapper) -> torch.Tensor:
    # no view of x or y is made: each costs about a microsecond of host time,
    # and on one plane the host's time per call exceeds the kernel's
    lib = library.load()
    p, rows, cols = _dims(x, torch.float32, "x")
    if not 1 <= out_rows <= rows - OFFSETS[-1]:
        raise ValueError(f"out_rows must be 1..{rows - OFFSETS[-1]} for {rows} rows, got {out_rows}")
    y = x.new_empty((p, out_rows, cols) if x.dim() == 3 else (out_rows, cols))  # float32, as x
    rc = getattr(lib, symbol)(x.data_ptr(), y.data_ptr(), p, rows, cols, out_rows, library.stream(x))
    library.check(lib, rc, symbol)
    wrapper.launches += 1
    return y


def slice_rows(x: torch.Tensor, out_rows: int = OUT_ROWS) -> torch.Tensor:
    """[.., rows, cols] float32 -> [.., out_rows, cols] float32 (P2)."""
    if x.is_cpu:
        return slice_reference(x, out_rows)
    return _rows_op(x, out_rows, "dmel_rows_slice", slice_rows)


def roll_rows(x: torch.Tensor, out_rows: int = OUT_ROWS) -> torch.Tensor:
    """[.., rows, cols] float32 -> [.., out_rows, cols] float32 (P3)."""
    if x.is_cpu:
        return roll_reference(x, out_rows)
    return _rows_op(x, out_rows, "dmel_rows_roll", roll_rows)


def tap_matmul_path(k: int, n: int, taps: int = TAPS, step: int = STEP) -> str:
    """P4's kernel for this shape: "wgmma" where the Hopper kernel takes it,
    else "mma" (module docstring)."""
    if k % 32 == 0 and n % 32 == 0 and step % 8 == 0 and WG_ROWS + step * (taps - 1) <= WG_MAX_ROWS:
        return "wgmma"
    return "mma"


def tap_matmul(
    x: torch.Tensor, w: torch.Tensor, out_rows: int = MM_OUT, taps: int = TAPS, step: int = STEP
) -> torch.Tensor:
    """x [.., rows, K] bfloat16, w [K, N] bfloat16 -> [.., out_rows, N] float32 (P4)."""
    if x.device.type == "cpu":
        return tap_matmul_reference(x, w, out_rows, taps, step)
    lib = library.load()
    xp = _planes(x, torch.bfloat16, "x")
    p, rows, k = xp.shape
    if w.dim() != 2 or w.shape[0] != k or w.device != x.device or w.dtype != torch.bfloat16 or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous bfloat16 [{k}, N] on {x.device}, got {w.dtype} {tuple(w.shape)} on {w.device}")
    n = w.shape[1]
    if k < 16 or k % 16 or n < 8 or n % 8 or k > MM_MAX or n > MM_MAX:
        raise ValueError(f"K must be a multiple of 16 and N of 8, both up to {MM_MAX}; got K = {k}, N = {n}")
    if taps < 1 or step < 0 or out_rows < 1 or step * (taps - 1) + out_rows > rows:
        raise ValueError(f"{taps} taps of step {step} and {out_rows} output rows do not fit {rows} rows")
    path = tap_matmul_path(k, n, taps, step)
    if path == "wgmma" and (xp.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("x and w must start on a 16-byte boundary (the wgmma kernel stages them with TMA)")
    if path == "mma" and p > 65535:
        raise ValueError(f"the mma kernel takes at most 65535 planes, got {p}")
    y = torch.empty((p, out_rows, n), device=x.device, dtype=torch.float32)
    rc = lib.dmel_tap_matmul(
        xp.data_ptr(), w.data_ptr(), y.data_ptr(), p, rows, out_rows, k, n, taps, step,
        int(path == "wgmma"), library.stream(x),
    )
    library.check(lib, rc, "dmel_tap_matmul")
    tap_matmul.launches += 1
    tap_matmul.launches_by_path[path] += 1
    return y if x.dim() == 3 else y[0]


GRAPH_LAUNCHES, GRAPH_SETS = 20, 5  # device_ms: launches in the graph, sets of planes they rotate over
HOST_CALLS = 1000  # host_us: calls per part


def device_ms(fn, planes: int, launches: int = GRAPH_LAUNCHES, sets: int = GRAPH_SETS, reps: int = 5,
              device="cuda") -> float:
    """Device ms per launch of `fn` (slice_rows or roll_rows) on seeded
    [planes, 1280, 96] planes: `launches` calls captured in one CUDA graph,
    call i reading set i % `sets` and writing its own output, the graph
    replayed `reps` times after a warm-up replay (CUDA events). At 264
    planes a set's 121 rows a plane are 12.3 MB, so 5 sets (and the
    outputs) exceed the 50 MB L2 and each launch reads device memory.
    `fn.launches` counts the launches each replay runs, not the captured
    calls, which launch nothing. Raises if the last output differs from
    the plain version's."""
    ref = {slice_rows: slice_reference, roll_rows: roll_reference}[fn]
    gen = torch.Generator(device=device).manual_seed(1)
    xs = [torch.randn((planes, ROWS, LANES), device=device, generator=gen) for _ in range(sets)]
    fn(xs[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    captured = fn.launches
    with torch.cuda.graph(graph):
        ys = [fn(xs[i % sets]) for i in range(launches)]
    fn.launches = captured

    def replay():
        graph.replay()
        fn.launches += launches

    replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        replay()
    end.record()
    torch.cuda.synchronize()
    if not torch.equal(ys[-1], ref(xs[(launches - 1) % sets])):
        raise AssertionError(f"{fn.__name__} in a CUDA graph disagrees with its plain version")
    return start.elapsed_time(end) / (reps * launches)


def host_us(n: int = HOST_CALLS, device="cuda") -> dict:
    """Host microseconds per call of P2's wrapper on one plane, part by part
    (`n` calls each, `time.perf_counter`, no synchronize inside): its
    checks (`_dims`), the output's `new_empty`, `library.stream`, the
    ctypes call that launches (and one the library refuses before any
    launch: ctypes alone), `library.check`, and the whole `slice_rows`."""
    lib = library.load()
    x = torch.randn((ROWS, LANES), device=device)
    y = torch.empty((OUT_ROWS, LANES), device=x.device, dtype=torch.float32)
    stream = library.stream(x)
    fn = lib.dmel_rows_slice
    parts = {
        "_dims": lambda: _dims(x, torch.float32, "x"),
        "x.new_empty": lambda: x.new_empty((OUT_ROWS, LANES)),
        "library.stream": lambda: library.stream(x),
        "ctypes call (launch)": lambda: fn(x.data_ptr(), y.data_ptr(), 1, ROWS, LANES, OUT_ROWS, stream),
        "ctypes call (refused)": lambda: fn(x.data_ptr(), y.data_ptr(), 0, ROWS, LANES, OUT_ROWS, stream),
        "library.check": lambda: library.check(lib, 0, "dmel_rows_slice"),
        "slice_rows": lambda: slice_rows(x),
    }
    out = {}
    for name, part in parts.items():
        part()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            part()
        out[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        if name == "ctypes call (launch)":
            slice_rows.launches += n + 1  # P2 launched past its wrapper, counted as the wrapper counts
    return out


# P2 / P3 / P4 launches, counted where the kernel is launched (P4 also by path)
slice_rows.launches = roll_rows.launches = tap_matmul.launches = 0
tap_matmul.launches_by_path = {"wgmma": 0, "mma": 0}


def rows_bound_ms(planes: int, cols: int = LANES, out_rows: int = OUT_ROWS) -> float:
    """Least time by bytes for P2 or P3: the out_rows + 9 rows a plane's
    result depends on read once, the result written once (float32)."""
    return planes * (2 * out_rows + OFFSETS[-1]) * cols * 4 / PEAK_BYTES * 1e3


def tap_matmul_bound_ms(planes: int, k: int = LANES, n: int = LANES, out_rows: int = MM_OUT,
                        taps: int = TAPS, step: int = STEP) -> dict:
    """Least time for P4: the rows of x that the taps read and w once in
    bfloat16 and y once in float32, against taps * 2 M K N flops at the
    bf16 tensor-core rate. {"bytes": ms, "operations": ms}."""
    nbytes = planes * ((out_rows + step * (taps - 1)) * k * 2 + out_rows * n * 4) + k * n * 2
    flops = planes * taps * 2 * out_rows * k * n
    return {"bytes": nbytes / PEAK_BYTES * 1e3, "operations": flops / PEAK_BF16 * 1e3}


def _inputs(planes: int, device, c: int = LANES):
    """Seeded x [P, 1280, 96] float32, xb [P, 2176, C] and w [C, C] bfloat16."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((planes, ROWS, LANES), device=device, generator=gen)
    xb = torch.randn((planes, MM_ROWS, c), device=device, generator=gen).to(torch.bfloat16)
    w = torch.randn((c, c), device=device, generator=gen).to(torch.bfloat16)
    return x, xb, w


def check_probes(planes: int, device="cuda") -> dict:
    """Errors of P2, P3 and P4 (at each of WIDTHS) against plain on
    `planes` planes, and the largest |P3 - P2|. Raises unless P2 and P3 give
    plain's bits, P4 is within MM_TOL of max |y|, and P3 differs from P2
    (two functions)."""
    x, _, _ = _inputs(planes, device)
    out = {}
    for name, fn, ref in (("slice", slice_rows, slice_reference), ("roll", roll_rows, roll_reference)):
        got, want = fn(x), ref(x)
        out[name] = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"{name}_rows, {planes} planes: max abs err {out[name]:.3e} vs plain, expected the same bits")
    with torch.no_grad():
        for name, call, ref in (
                ("slice library", lambda: slice_library(x.device)(x[:, :OUT_ROWS + OFFSETS[-1]].transpose(1, 2)
                                                                  .contiguous()), slice_reference),
                ("roll library", lambda: roll_library(x.device)(x.transpose(1, 2).contiguous())[..., :OUT_ROWS],
                 roll_reference)):
            want = ref(x)
            out[name] = float((call().transpose(1, 2) - want).abs().max())
            if not out[name] <= LIBRARY_TOL * max(1.0, float(want.abs().max())):
                raise AssertionError(f"{name}, {planes} planes: max abs err {out[name]:.3e} vs plain")
    out["roll vs slice"] = float((roll_rows(x) - slice_rows(x)).abs().max())
    if not out["roll vs slice"] > 1.0:
        raise AssertionError(f"roll_rows equals slice_rows to {out['roll vs slice']:.3e}: they are two functions")
    for c in WIDTHS:
        _, xb, w = _inputs(planes, device, c)
        want = tap_matmul_reference(xb, w)
        err, top = float((tap_matmul(xb, w) - want).abs().max()), float(want.abs().max())
        out[f"matmul {c}"], out[f"max |y| {c}"] = err, top
        if not err <= MM_TOL * top:
            raise AssertionError(f"tap_matmul, {planes} planes, C = {c}: max abs err {err:.3e} vs plain at max |y| {top:.1f}")
    return out


def time_probes(planes: int, reps: int = 20, device="cuda") -> dict:
    """Mean ms per call of P2 and P3 ("slice", "roll"), their device ms per
    launch ("slice device", "roll device": `device_ms`), ms per call of
    their library calls ("slice library": the conv on the channels-first
    rows P2 reads; "roll library": the module's call and the view, on the
    channels-first plane) and of P4 at each of WIDTHS ("matmul C"), on
    `planes` planes."""
    x, _, _ = _inputs(planes, device)
    calls = 10 * reps  # P2 / P3 and their library calls: ~0.01-0.02 ms each, mostly the host's
    out = {"slice": cuda_ms(lambda: slice_rows(x), calls), "roll": cuda_ms(lambda: roll_rows(x), calls),
           "slice device": device_ms(slice_rows, planes, device=device),
           "roll device": device_ms(roll_rows, planes, device=device)}
    slice_conv, x_rows = slice_library(x.device), x[:, :OUT_ROWS + OFFSETS[-1]].transpose(1, 2).contiguous()
    roll_conv, x_cf = roll_library(x.device), x.transpose(1, 2).contiguous()
    with torch.no_grad():
        out["slice library"] = cuda_ms(lambda: slice_conv(x_rows), calls)
        out["roll library"] = cuda_ms(lambda: roll_conv(x_cf)[..., :OUT_ROWS], calls)
    for c in WIDTHS:
        _, xb, w = _inputs(planes, device, c)
        out[f"matmul {c}"] = cuda_ms(lambda: tap_matmul(xb, w), reps)
    return out


def main() -> dict:
    """Checks the three kernels against plain at both plane counts (raising
    on a disagreement), prints the table; returns {planes: {name: ms}} and
    "host_us": `host_us()`."""
    require_gpu("sublane_ops")
    print(torch.cuda.get_device_name(0))
    for planes in (1, FILL_PLANES):
        err = check_probes(planes)
        print(f"P = {planes}: max err vs plain: slice {err['slice']:.2e}, roll {err['roll']:.2e} "
              f"(library calls: slice {err['slice library']:.2e}, roll {err['roll library']:.2e}), "
              + ", ".join(f"matmul C = {c} {err[f'matmul {c}']:.2e} (max |y| {err[f'max |y| {c}']:.1f})" for c in WIDTHS)
              + f"; roll vs slice {err['roll vs slice']:.2f} (two functions)")
    table = {}
    print(f"{'planes':<8}" + "".join(f"{h:>10}" for h in ("slice", "device", "library", "roll", "device", "library",
                                                          "bound"))
          + "".join(f"{'matmul ' + str(c):>12}{'bound':>9}" for c in WIDTHS)
          + "   (ms: per call, device per launch in a CUDA graph, the library call per call; bound by bytes)")
    for planes in (1, FILL_PLANES):
        ms = table[planes] = time_probes(planes)
        print(f"{planes:<8}" + "".join(f"{ms[k]:>10.5f}" for k in ("slice", "slice device", "slice library", "roll",
                                                                   "roll device", "roll library"))
              + f"{rows_bound_ms(planes):>10.5f}"
              + "".join(f"{ms[f'matmul {c}']:>12.4f}{max(tap_matmul_bound_ms(planes, c, c).values()):>9.5f}"
                        for c in WIDTHS), flush=True)
    host = table["host_us"] = host_us()
    print(f"slice_rows host us per call, part by part (1 plane, {HOST_CALLS} calls each): "
          + ", ".join(f"{k} {v:.2f}" for k, v in host.items()), flush=True)
    for c in WIDTHS:
        flops = FILL_PLANES * TAPS * 2 * MM_OUT * c * c
        print(f"matmul at P = {FILL_PLANES}, C = {c}: {flops / table[FILL_PLANES][f'matmul {c}'] / 1e9:.1f} TFLOP/s "
              f"({tap_matmul_path(c, c)} kernel)")
    return table


if __name__ == "__main__":
    main()
