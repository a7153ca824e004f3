"""Fused AMP resblock stage (port of `dmel_codec_tpu/ops/stage_fused.py`).

One BigVGAN upsample stage's resblock group — for k in (3, 7, 11):
xb = x; for d in (1, 3, 5): xb += conv_{k,1}(act(conv_{k,d}(act(xb))));
output = mean of the three xb — on channels-first [B, C, T], from
`pack_stage`'s arrays (weight norm folded, alpha/beta pre-exp'd):
  * on a CPU tensor `amp_stage` runs the plain version, `stage_reference`;
  * on a CUDA tensor it runs kernel K2: one launch per act -> conv pair, 18
    per stage (`launch_plan`), with no torch op in between, on the tensor
    cores: a bf16 stage's convs on bf16 operands (csrc/stage_fused_tc.cu,
    `tc_plan`), a float32 stage's as three TF32 products of each operand
    split into hi + lo (csrc/stage_fused_tf32.cu, `tf32_plan`), as the JAX
    kernel runs bf16 convs on the matrix unit and float32 at HIGHEST.
`act_conv` is one launch and `act_conv_reference` its plain version; the
plain stage is `launch_plan` run through `act_conv_reference`.
`amp_stage(..., v1=True)` runs the same kernels under the v1 contract (its
plain version `stage_reference_v1`): the JAX `fused_amp_stage`
(`use_v2=False`) at stages wider than K2-v1 takes.
`amp_stage_v1` is the same function as one launch per stage (kernel K2-v1,
csrc/stage_fused_v1.cu; the JAX `fused_amp_stage`, `use_v2=False`), for
C <= V1_MAX_CHANNELS, on the tensor cores in clusters of V1_CLUSTER CTAs
(bf16 `v1_tc_plan`, float32 on split-TF32 products `v1_tf32_plan`); its
plain version is `stage_reference_v1`.

bf16 contracts. K2 (the JAX v2 kernel's, stage_fused.py:398-403, 500-519):
the activation's input, its 12 taps, the snake's output v (before the down
FIR), the activation's output and the conv's output are rounded to the
input dtype, the residual spine and the running sum stay float32. K2-v1
and K2 in v1 mode (the JAX v1 kernel's, stage_fused.py:145-149, 231-268,
297): only the conv operands (the activation's output and the weights)
are rounded to the input dtype; taps, v and everything else stay float32
until the one cast at the end.
For float32 inputs both plain versions are exactly the JAX package's oracle.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from dmel_codec_tpu_torch.nn.snake import snake_coefficients
from dmel_codec_tpu_torch.ops import library
from dmel_codec_tpu_torch.ops.anti_alias import FILT, FILT_BF16, activation_chain


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """Static description of one upsample stage's resblock group."""

    channels: int
    kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"  # "snake" | "snakebeta"
    logscale: bool = True

    @property
    def receptive(self) -> int:
        """Largest one-side reach of a whole resblock chain (an activation
        reaches 6 samples, a conv d * (k - 1) / 2)."""
        return max(
            sum(6 + d * (k - 1) // 2 + 6 + (k - 1) // 2 for d in dils)
            for k, dils in zip(self.kernel_sizes, self.dilations)
        )

    @property
    def conv_reach(self) -> int:
        """Largest one-side reach of a single conv."""
        return max(
            max(dils) * (k - 1) // 2 for k, dils in zip(self.kernel_sizes, self.dilations)
        )


@torch.no_grad()
def pack_stage(resblocks: Sequence[torch.nn.Module], spec: StageSpec) -> dict:
    """AMPBlock1 modules -> {w: 18 x [k, C_out, C_in], b: [C, 18],
    a: [C, 18] (exp'd alpha), ib: [C, 18] (1/(beta+eps))}, float32; one
    column per conv and per the activation in front of it. As the JAX
    `pack_stage`: the weight norm and the coefficients are computed in the
    parameters' dtype, and only then held as float32."""
    ws, biases, alphas, inv_betas = [], [], [], []
    for blk in resblocks:
        for c1, c2 in zip(blk.convs1, blk.convs2):
            for conv in (c1, c2):
                ws.append(conv.weight().float().permute(2, 0, 1).contiguous())
                biases.append(conv.bias)
        for act in blk.activations:
            beta = act.act.beta if spec.activation == "snakebeta" else None
            alpha, inv_beta = snake_coefficients(act.act.alpha, beta, spec.logscale)
            alphas.append(alpha)
            inv_betas.append(inv_beta)

    def cols(values):  # [C, 18] float32
        return torch.stack(values, dim=1).float()

    return {"w": ws, "b": cols(biases), "a": cols(alphas), "ib": cols(inv_betas)}


def conv_site(spec: StageSpec, n: int) -> Tuple[int, int]:
    """(k, d) of conv n: a pair's first conv takes the pair's dilation, its
    second dilation 1."""
    for k, dils in zip(spec.kernel_sizes, spec.dilations):
        if n < 2 * len(dils):
            return k, dils[n // 2] if n % 2 == 0 else 1
        n -= 2 * len(dils)
    raise IndexError("conv index out of range for the spec")


def act_conv_reference(
    src: torch.Tensor,
    packed: dict,
    spec: StageSpec,
    n: int,
    dtype: torch.dtype,
    *,
    v1: bool = False,
    res: Optional[torch.Tensor] = None,
    acc_in: Optional[torch.Tensor] = None,
    mean_of: int = 1,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """One K2 launch as plain PyTorch: conv n on activation n of src,
    out = (round(conv(act(src)) + b) [+ res] [+ acc_in]) / mean_of, in
    float32 arithmetic, returned in out_dtype. `dtype` is the stage's: the
    conv operands (the activation's output, the weights) are rounded to it.
    v2 (not `v1`) also rounds the activation's input and the conv's output,
    and on bf16 the taps and the snake's output v (the JAX v2 kernel's bf16
    matmuls); v1 keeps them float32."""
    k, d = conv_site(spec, n)

    def rnd(v):
        return v.to(dtype).float()

    a = packed["a"][:, n, None].float()
    ib = packed["ib"][:, n, None].float()

    def snake_fn(u):
        s = torch.sin(u * a)
        return u + ib * s * s

    y = src.float() if v1 else rnd(src.float())
    y = rnd(activation_chain(y, snake_fn, not v1 and dtype == torch.bfloat16))
    w = packed["w"][n].to(dtype).float().permute(1, 2, 0)  # [co, ci, k]
    y = F.conv1d(y, w, packed["b"][:, n].float(), padding=d * (k - 1) // 2, dilation=d)
    if not v1:
        y = rnd(y)
    if res is not None:
        y = res.float() + y
    if acc_in is not None:
        y = acc_in + y
    if mean_of != 1:
        y = y / mean_of
    return y.to(out_dtype)


def launch_plan(spec: StageSpec):
    """K2's launches for one stage, in order, as (n, src, out, res, acc_in,
    mean_of) over the planes "x" (the input), "t1" (a pair's middle), "xb"
    (the residual spine), "acc" (the running sum of the blocks) and "y"
    (the output): for k in kernel_sizes: xb = x; for d in dils:
    xb += conv_{k,1}(act(conv_{k,d}(act(xb)))); y = mean of the xb."""
    plan, n, n_blk = [], 0, len(spec.kernel_sizes)
    for kb, dils in enumerate(spec.dilations):
        for p in range(len(dils)):
            resid = "x" if p == 0 else "xb"
            plan.append((n, resid, "t1", None, None, 1))  # t1 = conv_{k,d}(act(xb))
            if p < len(dils) - 1:  # xb += conv_{k,1}(act(t1))
                plan.append((n + 1, "t1", "xb", resid, None, 1))
            else:  # the block's last pair folds xb into the running sum
                final = kb == n_blk - 1
                plan.append((n + 1, "t1", "y" if final else "acc", resid, "acc" if kb > 0 else None,
                             n_blk if final else 1))
            n += 2
    return plan


def _plane_dtypes(dtype: torch.dtype, v1: bool) -> dict:
    """The dtype of each plane of `launch_plan`: the residual spine and the
    running sum float32, t1 in the stage's dtype (float32 under v1)."""
    return {"x": dtype, "t1": torch.float32 if v1 else dtype, "xb": torch.float32,
            "acc": torch.float32, "y": dtype}


def _reference(x: torch.Tensor, packed: dict, spec: StageSpec, v1: bool) -> torch.Tensor:
    """The stage as K2's launches in plain PyTorch, result in x's dtype."""
    dtypes = _plane_dtypes(x.dtype, v1)
    planes = {"x": x}
    for n, src, out, res, acc_in, mean_of in launch_plan(spec):
        planes[out] = act_conv_reference(
            planes[src], packed, spec, n, x.dtype, v1=v1, res=planes.get(res), acc_in=planes.get(acc_in),
            mean_of=mean_of, out_dtype=dtypes[out],
        )
    return planes["y"]


def stage_reference(x: torch.Tensor, packed: dict, spec: StageSpec) -> torch.Tensor:
    """K2's plain version under the v2 contract."""
    return _reference(x, packed, spec, v1=False)


def stage_reference_v1(x: torch.Tensor, packed: dict, spec: StageSpec) -> torch.Tensor:
    """K2-v1's plain version (and K2's in v1 mode): planes float32, only
    conv operands rounded."""
    return _reference(x, packed, spec, v1=True)


# ---- the kernels: bf16 and float32 (split-TF32) on the tensor cores -------

TC_WIDTHS = (24, 32, 48, 64, 96, 128, 160, 192)  # the bf16 kernel's N instantiations
TC_SLOT_BYTES = 32768  # most bytes of one streamed (tap, K chunk) of weights


def tc_plan(c: int) -> Tuple[int, int, int, int]:
    """How the bf16 kernel tiles a stage of C channels: (N, blocks of N,
    KP, KC). N: the narrowest instantiation that holds C (rounded up to 8),
    or blocks of 192 beyond; KP: C rounded up to 16; KC: the widest
    multiple of 16 up to 96 dividing KP whose KC x N bf16 fit
    TC_SLOT_BYTES."""
    c8 = -(-c // 8) * 8
    n = next((w for w in TC_WIDTHS if w >= c8), TC_WIDTHS[-1])
    kp = -(-c // 16) * 16
    kc = max(m for m in range(16, min(kp, 96) + 1, 16) if kp % m == 0 and (m == 16 or m * n * 2 <= TC_SLOT_BYTES))
    return n, -(-c // n), kp, kc


def tc_weights(ws: Sequence[torch.Tensor], c: int) -> Tuple[torch.Tensor, list]:
    """[k, C_out, C_in] conv weights -> one bf16 tensor in the layout the
    bf16 kernel streams ([N block][tap][K chunk][KC / 8][N][8] per conv,
    zero-padded) and each conv's offset in it, in elements."""
    n, blocks, kp, kc = tc_plan(c)
    parts, offsets, at = [], [], 0
    for w in ws:
        k = w.shape[0]
        wp = torch.zeros((k, blocks * n, kp), dtype=torch.bfloat16, device=w.device)
        wp[:, :c, :c] = w
        t = wp.view(k, blocks, n, kp // kc, kc // 8, 8).permute(1, 0, 3, 4, 2, 5).reshape(-1)
        parts.append(t)
        offsets.append(at)
        at += t.numel()
    return torch.cat(parts), offsets


def tc_unpack(flat: torch.Tensor, offsets: Sequence[int], kernel_sizes: Sequence[int], c: int) -> list:
    """`tc_weights`' inverse: the [k, C, C] bf16 weights of each conv."""
    n, blocks, kp, kc = tc_plan(c)
    ws = []
    for at, k in zip(offsets, kernel_sizes):
        t = flat[at: at + blocks * k * kp * n].view(blocks, k, kp // kc, kc // 8, n, 8)
        ws.append(t.permute(1, 0, 4, 2, 3, 5).reshape(k, blocks * n, kp)[:, :c, :c])
    return ws


def _align128(v: int) -> int:
    return (v + 127) // 128 * 128


# The float32 kernel (csrc/stage_fused_tf32.cu): N instantiations, output
# samples a block owns, input halo, largest conv reach, weight slots, and
# shared memory a block may use (one block of 16 warps an SM at N = 192, two
# of 8 warps below).
TF32_WIDTHS = (24, 48, 96, 192)
TF32_BM, _TF32_XH, _TF32_MAX_P, _TF32_MAX_SLOTS = 128, 8, 32, 32
_TF32_SMEM, _TF32_PAIR_SMEM = 227 * 1024, 115712
TF32_SLOT_BYTES = 6144  # bytes of a weight slot (hi + lo) aimed at; at least 8 channels' worth


class Tf32Plan(NamedTuple):
    """A float32 K2 launch's tiling: N output channels a block, blocks of N,
    KP (C rounded up to the warps of a block), KS input channels a
    super-chunk, KC channels a weight slot, BM output samples a block,
    warps a block, weight slots, shared memory bytes."""

    n: int
    blocks: int
    kp: int
    ks: int
    kc: int
    bm: int
    warps: int
    slots: int
    smem_bytes: int


def tf32_bytes(ks: int, n: int, warps: int, reach: int, kc: int, slots: int) -> int:
    """Shared memory of a float32 K2 block (the kernel's f32_layout): the
    float32 tile A of BM + 2 reach rows x KS, the activation scratch (each
    warp's input row and two snake phases), or the epilogue's [N][BM + 4]
    tile where that is larger, the weight slots, their barriers and the
    base's alignment."""
    rows = TF32_BM + 2 * reach
    lx, lv = rows + 2 * _TF32_XH, rows + 6
    ring = max(_align128(4 * ks * rows) + _align128(4 * warps * (lx + 2 * lv)), 4 * n * (TF32_BM + 4))
    return ring + slots * kc * n * 8 + 16 * slots + 128


def tf32_tiling(c: int) -> Tuple[int, int, int, int, int, int]:
    """(N, blocks of N, KP, KS, KC, warps) of the float32 kernel at C
    channels: N the narrowest instantiation that holds C (rounded up to 8),
    or blocks of 192 beyond; 16 warps at N = 192, else 8; KP C rounded up
    to the warps (each warp computes one channel of a chunk); KC the widest
    multiple of 8 up to 24 dividing KP whose hi + lo (KC x N x 8 bytes) fit
    TF32_SLOT_BYTES, or 8; KS the most input channels of a super-chunk (a
    multiple of the warps and of KC dividing KP) whose A tile fits beside
    two weight slots at the largest reach (KP up to C = 208)."""
    c8 = -(-c // 8) * 8
    n = next((w for w in TF32_WIDTHS if w >= c8), TF32_WIDTHS[-1])
    warps = 16 if n >= 128 else 8
    kp = -(-c // warps) * warps
    kc = max(m for m in range(8, min(kp, 24) + 1, 8) if kp % m == 0 and (m == 8 or m * n * 8 <= TF32_SLOT_BYTES))
    budget = _TF32_SMEM if warps == 16 else _TF32_PAIR_SMEM
    ks = max(m for m in range(warps, kp + 1, warps) if kp % m == 0 and m % kc == 0
             and (m == math.lcm(warps, kc) or tf32_bytes(m, n, warps, _TF32_MAX_P, kc, 2) <= budget))
    return n, -(-c // n), kp, ks, kc, warps


def tf32_plan(c: int, k: int, d: int) -> Tf32Plan:
    """The float32 kernel's plan for a conv of size k and dilation d at C
    channels: `tf32_tiling`, and as many weight slots as fit the block's
    shared memory (at most 32, and no more than the conv's (tap, K chunk)
    stages)."""
    n, blocks, kp, ks, kc, warps = tf32_tiling(c)
    reach = d * (k - 1) // 2
    if reach > _TF32_MAX_P:
        raise ValueError(f"a conv reaching {reach} samples per side is beyond the kernel's {_TF32_MAX_P}")
    budget = _TF32_SMEM if warps == 16 else _TF32_PAIR_SMEM
    stages = k * kp // kc
    fit = [s for s in range(1, min(_TF32_MAX_SLOTS, stages) + 1) if tf32_bytes(ks, n, warps, reach, kc, s) <= budget]
    if not fit or fit[-1] < min(2, stages):
        raise ValueError(f"the float32 kernel cannot hold a C = {c}, k = {k}, d = {d} conv in shared memory")
    slots = fit[-1]
    return Tf32Plan(n, blocks, kp, ks, kc, TF32_BM, warps, slots, tf32_bytes(ks, n, warps, reach, kc, slots))


def tf32_weights(ws: Sequence[torch.Tensor], c: int, per_tap: bool = False) -> Tuple[torch.Tensor, list]:
    """[k, C_out, C_in] float32 conv weights -> one float32 tensor in the
    layout the float32 kernels stream, each weight split into hi =
    tf32(w), lo = tf32(w - hi) (`split_tf32`): [N block][KP / KS][tap][KS /
    KC][hi, lo][KC / 4][N][4] per conv, zero-padded (N, KP, KS, KC of
    `tf32_tiling`; K2-v1's `per_tap` layout has KS = KC = KP: a tap a
    slot), and each conv's offset in it, in elements."""
    n, blocks, kp, ks, kc, _ = tf32_tiling(c)
    if per_tap:
        ks = kc = kp
    parts, offsets, at = [], [], 0
    for w in ws:
        k = w.shape[0]
        wp = torch.zeros((k, blocks * n, kp), dtype=torch.float32, device=w.device)
        wp[:, :c, :c] = w
        t = torch.stack(split_tf32(wp))  # [2, k, blocks * n, kp]
        t = t.view(2, k, blocks, n, kp // ks, ks // kc, kc // 4, 4).permute(2, 4, 1, 5, 0, 6, 3, 7).reshape(-1)
        parts.append(t)
        offsets.append(at)
        at += t.numel()
    return torch.cat(parts), offsets


def tf32_unpack(flat: torch.Tensor, offsets: Sequence[int], kernel_sizes: Sequence[int], c: int,
                per_tap: bool = False) -> list:
    """`tf32_weights`' inverse: (hi, lo) [k, C, C] of each conv."""
    n, blocks, kp, ks, kc, _ = tf32_tiling(c)
    if per_tap:
        ks = kc = kp
    ws = []
    for at, k in zip(offsets, kernel_sizes):
        t = flat[at: at + 2 * blocks * k * kp * n].view(blocks, kp // ks, k, ks // kc, 2, kc // 4, n, 4)
        t = t.permute(4, 2, 0, 6, 1, 3, 5, 7).reshape(2, k, blocks * n, kp)[:, :, :c, :c]
        ws.append((t[0], t[1]))
    return ws


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as `cvt.rna.tf32.f32` (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi): what the float32
    kernels multiply (A_hi B_hi + A_hi B_lo + A_lo B_hi); x - hi - lo is at
    most 2^-22 of |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _check_input(x: torch.Tensor, spec: StageSpec) -> None:
    library.check_plane(x)
    if x.shape[1] != spec.channels:
        raise ValueError(f"x has {x.shape[1]} channels, spec says {spec.channels}")


def _kernel_args(packed: dict, spec: StageSpec, dtype: torch.dtype, device: torch.device):
    """Checks the packed arrays against spec; returns the conv weights in
    `dtype` and the float32 columns, on `device`."""
    c = spec.channels
    n_convs = sum(2 * len(d) for d in spec.dilations)
    if len(packed["w"]) != n_convs:
        raise ValueError(f"packed has {len(packed['w'])} convs, spec needs {n_convs}")
    ws = [w.to(device=device, dtype=dtype).contiguous() for w in packed["w"]]
    kernel_of = [k for k, dl in zip(spec.kernel_sizes, spec.dilations) for _ in range(2 * len(dl))]
    for w, k in zip(ws, kernel_of):
        if w.shape != (k, c, c):
            raise ValueError(f"conv weight {tuple(w.shape)} is not [{k}, {c}, {c}]")
    cols = {key: packed[key].to(device=device, dtype=torch.float32).contiguous() for key in ("b", "a", "ib")}
    for key, col in cols.items():
        if col.shape != (c, n_convs):
            raise ValueError(f"packed[{key!r}] is {tuple(col.shape)}, not [{c}, {n_convs}]")
    return ws, cols, n_convs


def _k2_args(packed: dict, spec: StageSpec, dtype: torch.dtype, device: torch.device) -> dict:
    """What K2's launches need besides the planes, made once per dtype and
    device and kept in `packed` (a snapshot of the weights, like `packed`
    itself): the weights in the layout of the dtype's kernel (bf16
    `tc_weights`, float32 `tf32_weights`), the float32 columns and the taps
    of each contract; float32 also its plans by (k, d)."""
    key = ("K2", dtype, device)
    if key not in packed:
        ws, cols, n_convs = _kernel_args(packed, spec, dtype, device)
        args = {**cols, "n_convs": n_convs, "bf16": dtype == torch.bfloat16,
                "taps": {False: library.taps(FILT), True: library.taps(FILT_BF16 if dtype == torch.bfloat16 else FILT)}}
        if args["bf16"]:
            args["w_tc"], args["offsets"] = tc_weights(ws, spec.channels)
            args["plan"] = tc_plan(spec.channels)
        else:
            args["w_tf32"], args["offsets"] = tf32_weights(ws, spec.channels)
            args["plans"] = {(k, d): tf32_plan(spec.channels, k, d)
                             for k, dils in zip(spec.kernel_sizes, spec.dilations) for d in {1, *dils}}
        packed[key] = args
    return packed[key]


def _launch(lib, args: dict, spec: StageSpec, n: int, src, out, res, acc_in, mean_of: int, v1: bool,
            parts: int = 3) -> None:
    """One K2 launch on planes that passed the checks: the bf16 kernel for
    a bf16 stage, the split-TF32 kernel for a float32 one. `parts` < 3
    drops parts of the kernel (probes/stage_parts.py)."""
    bsz, c, t = src.shape
    k, d = conv_site(spec, n)
    ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
    cols = [args["b"].data_ptr() + 4 * n, args["n_convs"], args["a"].data_ptr() + 4 * n,
            args["ib"].data_ptr() + 4 * n, args["n_convs"]]
    strm = library.stream(src)
    if args["bf16"]:
        bf = lambda v: int(v is not None and v.dtype == torch.bfloat16)  # noqa: E731
        nb, _, kp, kc = args["plan"]
        rc = lib.dmel_act_conv_tc(
            src.data_ptr(), bf(src), args["w_tc"].data_ptr() + 2 * args["offsets"][n], nb, kp, kc, *cols,
            ptr(res), bf(res), ptr(acc_in), out.data_ptr(), bf(out), float(mean_of), int(not v1),
            bsz, c, t, k, d, args["taps"][not v1], parts, strm,
        )
        library.check(lib, rc, "dmel_act_conv_tc")
        amp_stage.launches_by_kernel["act_conv_tc_kernel"] += 1
    else:
        plan = args["plans"][(k, d)]
        rc = lib.dmel_act_conv_tf32(
            src.data_ptr(), args["w_tf32"].data_ptr() + 4 * args["offsets"][n], plan.n, plan.kp, plan.ks,
            plan.kc, plan.slots, *cols, ptr(res), ptr(acc_in), out.data_ptr(), float(mean_of), bsz, c, t, k, d,
            args["taps"][False], parts, strm,
        )
        library.check(lib, rc, "dmel_act_conv_tf32")
        amp_stage.launches_by_kernel["act_conv_tf32_kernel"] += 1
    amp_stage.launches += 1


def _run_kernel(x: torch.Tensor, packed: dict, spec: StageSpec, v1: bool = False, parts: int = 3) -> torch.Tensor:
    """K2's launches (`launch_plan`) on planes of `_plane_dtypes`; out may
    alias res (xb += ...) and acc_in, never src."""
    lib = library.load()
    _check_input(x, spec)
    args = _k2_args(packed, spec, x.dtype, x.device)
    planes = {name: x if name == "x" else torch.empty(x.shape, dtype=dt, device=x.device)
              for name, dt in _plane_dtypes(x.dtype, v1).items()}
    for n, src, out, res, acc_in, mean_of in launch_plan(spec):
        _launch(lib, args, spec, n, planes[src], planes[out], planes.get(res), planes.get(acc_in), mean_of, v1, parts)
    return planes["y"]


def amp_stage(x: torch.Tensor, packed: dict, spec: StageSpec, v1: bool = False) -> torch.Tensor:
    """[B, C, T] -> [B, C, T], one fused stage; `v1` picks the v1 contract."""
    if x.device.type == "cpu":
        return (stage_reference_v1 if v1 else stage_reference)(x, packed, spec)
    return _run_kernel(x, packed, spec, v1)


amp_stage.launches = 0  # K2 launches (18 per stage call), counted in _launch
amp_stage.launches_by_kernel = {"act_conv_tc_kernel": 0, "act_conv_tf32_kernel": 0}  # bf16 / float32 launches


def act_conv(
    src: torch.Tensor,
    packed: dict,
    spec: StageSpec,
    n: int,
    dtype: torch.dtype,
    *,
    v1: bool = False,
    res: Optional[torch.Tensor] = None,
    acc_in: Optional[torch.Tensor] = None,
    mean_of: int = 1,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """One K2 launch, `act_conv_reference`'s function, by the kernel of the
    stage dtype `dtype` (its plain version on a CPU tensor). A float32
    stage takes float32 planes; a bf16 one float32 or bf16 src, res and
    out, and a float32 acc_in."""
    if src.device.type == "cpu":
        return act_conv_reference(src, packed, spec, n, dtype, v1=v1, res=res, acc_in=acc_in,
                                  mean_of=mean_of, out_dtype=out_dtype)
    lib = library.load()
    _check_input(src, spec)
    for name, v in (("res", res), ("acc_in", acc_in)):
        if v is not None:
            library.check_plane(v, name)
            if v.shape != src.shape or v.device != src.device:
                raise ValueError(f"{name} must be {tuple(src.shape)} on {src.device}")
    float32 = [acc_in] if dtype == torch.bfloat16 else [src, res, acc_in, torch.empty(0, dtype=out_dtype)]
    if any(v is not None and v.dtype != torch.float32 for v in float32):
        raise TypeError("acc_in, and every plane of a float32 stage, must be float32")
    args = _k2_args(packed, spec, dtype, src.device)
    out = torch.empty(src.shape, dtype=out_dtype, device=src.device)
    _launch(lib, args, spec, n, src, out, res, acc_in, mean_of, v1)
    return out


# ---- K2-v1: the whole stage in one launch -----------------------------------

V1_MAX_CHANNELS = 48  # widest stage whose planes, conv input and weights fit a block beside W = 256 columns

# The kernels' plan (csrc/stage_fused_v1.cu): a cluster of V1_CLUSTER CTAs,
# each owning W columns (a multiple of 256: 64 rows for each of 4
# warpgroups); halo widths as the kernel's TC_XH, TC_PA, and its activation
# scratch (16 warps x 2 x 136 floats).
V1_CLUSTER = 8
_TC_XH, _TC_PA, _TC_SCR_BYTES = 8, 32, 4 * 16 * 2 * 136
# float32: the 64-row tiles a warpgroup holds the sums of (W / 256 at most),
# by N, and the per-tap weight slots
_V1_TF32_TILES, V1_TF32_MAX_SLOTS = {24: 4, 32: 2, 48: 1}, 4


def v1_tc_bytes(c: int, kp: int, n: int, w: int, kmax: int) -> int:
    """Shared memory of a bf16 K2-v1 block (the kernel's v1tc_layout): the
    float32 xb and t planes of W + 16 columns, the bf16 conv input of W + 64
    rows x KP channels, one conv's weights, the activation scratch, the
    mbarrier and the base's alignment."""
    lw, ra = w + 2 * _TC_XH, w + 2 * _TC_PA
    return (2 * _align128(4 * c * lw) + _align128(2 * kp * ra) + _align128(2 * kmax * kp * n)
            + _TC_SCR_BYTES + 16 + 128)


def v1_tf32_bytes(c: int, kp: int, n: int, w: int, slots: int) -> int:
    """Shared memory of a float32 K2-v1 block (the kernel's v1tc_layout):
    the float32 xb and t planes, the float32 conv input of W + 64 rows x KP
    channels, `slots` per-tap slots of hi + lo weights (KP x N x 8 bytes),
    the activation scratch, a full and an empty mbarrier per slot and the
    base's alignment."""
    lw, ra = w + 2 * _TC_XH, w + 2 * _TC_PA
    return (2 * _align128(4 * c * lw) + _align128(4 * kp * ra) + _align128(8 * slots * kp * n)
            + _TC_SCR_BYTES + 16 * slots + 128)


def v1_tc_plan(c: int, spec: StageSpec, smem_bytes: int) -> Tuple[int, int, int]:
    """(N, KP, W) of the bf16 kernel: N and KP as K2's `tc_plan` (C rounded
    up to a wgmma width, and to 16), W the most columns a multiple of 256
    (at most 1024) whose block fits `smem_bytes`; 0 if none does."""
    n, _, kp, _ = tc_plan(c)
    kmax = max(spec.kernel_sizes)
    w = max((w for w in (256, 512, 768, 1024) if v1_tc_bytes(c, kp, n, w, kmax) <= smem_bytes), default=0)
    return n, kp, w


def v1_tf32_plan(c: int, spec: StageSpec, smem_bytes: int) -> Tuple[int, int, int, int]:
    """(N, KP, W, slots) of the float32 kernel: N as the bf16 plan's, KP C
    rounded up to 8 (a TF32 product takes 8 channels), W the most columns
    a multiple of 256 whose block fits `smem_bytes` with two weight slots
    (and whose tiles a warpgroup can hold the sums of: W <= 1024, 512, 256
    at N = 24, 32, 48), then as many slots as fit, up to
    V1_TF32_MAX_SLOTS; W = 0 if none does."""
    n, _, _, _ = tc_plan(c)
    kp = -(-c // 8) * 8
    tiles = _V1_TF32_TILES.get(n, 0)
    w = max((w for w in (256, 512, 768, 1024)
             if w // 256 <= tiles and v1_tf32_bytes(c, kp, n, w, 2) <= smem_bytes), default=0)
    slots = max((s for s in range(3, V1_TF32_MAX_SLOTS + 1) if w and v1_tf32_bytes(c, kp, n, w, s) <= smem_bytes),
                default=2)
    return n, kp, w, slots


def v1_tc_tiles(t: int, w: int, g: int, reach: int) -> list:
    """The bf16 kernel's tiling of [0, t), as (cluster window start,
    window length, [(CTA's first stored column, its last + 1)]) per
    cluster: a cluster stores S = g w - 2 reach columns from its start,
    computes R more on each side (clipped to [0, t)), CTA r owns window
    columns [r w, r w + w)."""
    s = g * w - 2 * reach
    out = []
    for t0 in range(0, t, s):
        wlo = max(t0 - reach, 0)
        n = min(t0 + s + reach, t) - wlo
        coff, nc = t0 - wlo, min(s, t - t0)
        stored = [(wlo + max(r * w, coff), wlo + min(r * w + w, coff + nc)) for r in range(g)]
        out.append((wlo, n, [(lo, hi) for lo, hi in stored if lo < hi]))
    return out


def _v1_args(x: torch.Tensor, packed: dict, spec: StageSpec, lib) -> dict:
    """What a K2-v1 launch needs besides x, made once per dtype and device
    and kept in `packed` (a snapshot of the weights, like `packed` itself):
    the weights in the kernel's layout (bf16: `tc_weights`'; float32:
    `tf32_weights`' with a tap per slot), the float32 columns, the tile
    plan and the spec as C arrays."""
    key = ("v1", x.dtype, x.device)
    if key not in packed:
        ws, cols, _ = _kernel_args(packed, spec, x.dtype, x.device)
        c = spec.channels
        max_d = max(len(d) for d in spec.dilations)
        if len(spec.kernel_sizes) > 8 or max_d > 8:
            raise ValueError(f"K2-v1 takes at most 8 resblocks of at most 8 dilations, got {spec}")
        ints = ctypes.c_int * len(spec.kernel_sizes)
        dils = [d for row in spec.dilations for d in (*row, *([0] * (max_d - len(row))))]
        args = {**cols, "max_d": max_d, "ks": ints(*spec.kernel_sizes), "n_dils": ints(*map(len, spec.dilations)),
                "dils": (ctypes.c_int * len(dils))(*dils), "taps": library.taps(FILT)}
        smem = lib.dmel_stage_v1_smem_bytes()
        if x.dtype == torch.bfloat16:
            (n, kp, tile), slots = v1_tc_plan(c, spec, smem), 0
            w = tc_weights(ws, c)[0]
        else:
            n, kp, tile, slots = v1_tf32_plan(c, spec, smem)
            w = tf32_weights(ws, c, per_tap=True)[0]
        if tile == 0 or spec.conv_reach > _TC_PA:
            raise ValueError(f"K2-v1 cannot hold {spec} in one block's shared memory")
        args.update(w=w, n=n, kp=kp, tile=tile, slots=slots)
        packed[key] = args
    return packed[key]


def _run_kernel_v1(x: torch.Tensor, packed: dict, spec: StageSpec, parts: int = 3, config=None) -> torch.Tensor:
    """One K2-v1 launch (bf16, or float32 on split-TF32 products). `parts`
    < 3 drops parts of it (probes/stage_parts.py)."""
    if x.dim() == 3 and x.shape[1] > V1_MAX_CHANNELS:
        raise ValueError(
            f"K2-v1 holds a whole stage in shared memory and takes at most "
            f"{V1_MAX_CHANNELS} channels, got {x.shape[1]} (amp_stage takes any width)"
        )
    lib = library.load()
    _check_input(x, spec)
    bsz, c, t = x.shape
    if bsz > 65535:
        raise ValueError(f"batch {bsz} must fit the launch grid (65535)")
    a = _v1_args(x, packed, spec, lib)
    y = torch.empty_like(x)
    acc = torch.empty(x.shape, dtype=torch.float32, device=x.device)  # the running sum
    rc = lib.dmel_stage_v1_tc(
        x.data_ptr(), a["w"].data_ptr(), a["b"].data_ptr(), a["a"].data_ptr(), a["ib"].data_ptr(), y.data_ptr(),
        acc.data_ptr(), a["n"], a["kp"], bsz, c, t, a["tile"], spec.receptive, V1_CLUSTER, a["slots"],
        len(spec.kernel_sizes), a["ks"], a["n_dils"], a["dils"], a["max_d"], a["taps"], parts, config,
        library.stream(x),
    )
    library.check(lib, rc, "dmel_stage_v1_tc")
    amp_stage_v1.launches += 1
    amp_stage_v1.launches_by_kernel["stage_v1_tf32_kernel" if a["slots"] else "stage_v1_tc_kernel"] += 1
    return y


def v1_launch_config(x: torch.Tensor, packed: dict, spec: StageSpec) -> dict:
    """One K2-v1 launch on x, and what it ran as: grid, threads, shared
    memory per block, cluster size and W."""
    cfg = (ctypes.c_int * 6)()
    _run_kernel_v1(x, packed, spec, config=cfg)
    return {"grid": (cfg[0], cfg[1]), "threads": cfg[2], "smem_bytes": cfg[3], "cluster": cfg[4], "tile": cfg[5]}


def amp_stage_v1(x: torch.Tensor, packed: dict, spec: StageSpec) -> torch.Tensor:
    """[B, C, T] -> [B, C, T], one fused stage in one launch (C <= V1_MAX_CHANNELS)."""
    if x.device.type == "cpu":
        return stage_reference_v1(x, packed, spec)
    return _run_kernel_v1(x, packed, spec)


amp_stage_v1.launches = 0  # K2-v1 launches (1 per stage call), counted in _run_kernel_v1
amp_stage_v1.launches_by_kernel = {"stage_v1_tc_kernel": 0, "stage_v1_tf32_kernel": 0}  # bf16 / float32 launches
