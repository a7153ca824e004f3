"""Fused AMP resblock stage (port of `dmel_codec_tpu/ops/stage_fused.py`).

One BigVGAN upsample stage's resblock group — for k in (3, 7, 11):
xb = x; for d in (1, 3, 5): xb += conv_{k,1}(act(conv_{k,d}(act(xb))));
output = mean of the three xb — on channels-first [B, C, T], from
`pack_stage`'s arrays (weight norm folded, alpha/beta pre-exp'd):
  * on a CPU tensor `amp_stage` runs the plain version, `stage_reference`;
  * on a CUDA tensor it runs kernel K2 (csrc/stage_fused.cu): one launch per
    act -> conv pair, 18 per stage, with no torch op in between.
`amp_stage(..., v1=True)` runs the same kernel under the v1 contract (its
plain version `stage_reference_v1`): the JAX `fused_amp_stage`
(`use_v2=False`) at stages wider than K2-v1 takes.
`amp_stage_v1` is the same function as one launch per stage (kernel K2-v1,
csrc/stage_fused_v1.cu; the JAX `fused_amp_stage`, `use_v2=False`), for
C <= V1_MAX_CHANNELS; its plain version is `stage_reference_v1`.

bf16 contracts. K2 (the JAX v2 kernel's, stage_fused.py:398-403):
activation input, activation output and conv output are rounded to the
input dtype, the residual spine and the running sum stay float32. K2-v1
and K2 in v1 mode (the JAX v1 kernel's, stage_fused.py:145-149, 253-268,
297): only the conv operands (the activation's output and the weights)
are rounded to the input dtype; everything else stays float32 until the
one cast at the end.
For float32 inputs both plain versions are exactly the JAX package's oracle.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from dmel_codec_tpu_torch.nn.resample import downsample1d, upsample1d
from dmel_codec_tpu_torch.nn.snake import snake_coefficients
from dmel_codec_tpu_torch.ops import library
from dmel_codec_tpu_torch.ops.anti_alias import FILT


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


def _reference(x: torch.Tensor, packed: dict, spec: StageSpec, round_planes: bool) -> torch.Tensor:
    """The stage in float32 arithmetic, result in x's dtype. The conv's
    operands are always rounded to x's dtype; `round_planes` also rounds
    the activation's input and the conv's output (K2's contract)."""
    dt = x.dtype
    filt = torch.from_numpy(FILT)

    def rnd(v):
        return v.to(dt).float()

    def rnd_plane(v):
        return rnd(v) if round_planes else v

    n = 0  # conv n and the activation in front of it
    acc = None
    for k, dils in zip(spec.kernel_sizes, spec.dilations):
        xb = x.float()
        for d in dils:
            y = xb
            for which_d in (d, 1):
                a = packed["a"][:, n, None].float()
                ib = packed["ib"][:, n, None].float()
                u = upsample1d(rnd_plane(y), filt, 2, 12)
                s = torch.sin(u * a)
                y = rnd(downsample1d(u + ib * s * s, filt, 2, 12))
                w = packed["w"][n].to(dt).float().permute(1, 2, 0)  # [co, ci, k]
                b = packed["b"][:, n].float()
                y = rnd_plane(F.conv1d(y, w, b, padding=which_d * (k - 1) // 2, dilation=which_d))
                n += 1
            xb = xb + y
        acc = xb if acc is None else acc + xb
    return (acc / len(spec.kernel_sizes)).to(dt)


def stage_reference(x: torch.Tensor, packed: dict, spec: StageSpec) -> torch.Tensor:
    """K2's plain version: planes between the ops rounded to x's dtype."""
    return _reference(x, packed, spec, round_planes=True)


def stage_reference_v1(x: torch.Tensor, packed: dict, spec: StageSpec) -> torch.Tensor:
    """K2-v1's plain version: planes float32, only conv operands rounded."""
    return _reference(x, packed, spec, round_planes=False)


def _co_tile(c: int) -> int:
    """Output-channel tile of a K2 block (kernel instantiations 24/48/64;
    channels past C are masked)."""
    for tile in (64, 48, 24):
        if c % tile == 0:
            return tile
    return 24


def _check_input(x: torch.Tensor, spec: StageSpec) -> None:
    library.check_plane(x)
    if x.shape[1] != spec.channels:
        raise ValueError(f"x has {x.shape[1]} channels, spec says {spec.channels}")


def _kernel_args(x: torch.Tensor, packed: dict, spec: StageSpec):
    """Checks x and the packed arrays against spec; returns the conv
    weights in x's dtype and the float32 columns, on x's device."""
    _check_input(x, spec)
    c = x.shape[1]
    n_convs = sum(2 * len(d) for d in spec.dilations)
    if len(packed["w"]) != n_convs:
        raise ValueError(f"packed has {len(packed['w'])} convs, spec needs {n_convs}")
    ws = [w.to(device=x.device, dtype=x.dtype).contiguous() for w in packed["w"]]
    kernel_of = [k for k, dl in zip(spec.kernel_sizes, spec.dilations) for _ in range(2 * len(dl))]
    for w, k in zip(ws, kernel_of):
        if w.shape != (k, c, c):
            raise ValueError(f"conv weight {tuple(w.shape)} is not [{k}, {c}, {c}]")
    cols = {
        key: packed[key].to(device=x.device, dtype=torch.float32).contiguous()
        for key in ("b", "a", "ib")
    }
    for key, col in cols.items():
        if col.shape != (c, n_convs):
            raise ValueError(f"packed[{key!r}] is {tuple(col.shape)}, not [{c}, {n_convs}]")
    return ws, cols, n_convs


def _run_kernel(x: torch.Tensor, packed: dict, spec: StageSpec, v1: bool = False) -> torch.Tensor:
    """K2's 18 launches. v2: planes rounded to x's dtype (`plane_bf16`);
    v1: the planes stay float32 (t1 too) and only the activation's output,
    a conv operand, is rounded (`operand_bf16`)."""
    lib = library.load()
    ws, cols, n_convs = _kernel_args(x, packed, spec)
    bsz, c, t = x.shape
    dt = x.dtype
    bf = int(dt == torch.bfloat16)
    plane_bf = 0 if v1 else bf
    f32 = torch.float32
    xb = torch.empty(x.shape, dtype=f32, device=x.device)
    acc = torch.empty_like(xb)
    t1 = torch.empty_like(xb) if v1 else torch.empty_like(x)
    y = torch.empty_like(x)
    taps = library.taps(FILT)
    strm = library.stream(x)
    co_tile = _co_tile(c)

    def step(src, n, k, d, out, res=None, acc_in=None, scale=1.0):
        """Conv n (dilation d) on activation n of src."""
        rc = lib.dmel_act_conv(
            src.data_ptr(), int(src.dtype == torch.bfloat16),
            ws[n].data_ptr(), bf,
            cols["b"].data_ptr() + 4 * n, n_convs,
            cols["a"].data_ptr() + 4 * n, cols["ib"].data_ptr() + 4 * n, n_convs,
            None if res is None else res.data_ptr(), int(res is not None and res.dtype == torch.bfloat16),
            None if acc_in is None else acc_in.data_ptr(),
            out.data_ptr(), int(out.dtype == torch.bfloat16), scale, bf, plane_bf,
            bsz, c, t, k, d, co_tile, taps, strm,
        )
        library.check(lib, rc, "dmel_act_conv")
        amp_stage.launches += 1

    n_blk = len(spec.kernel_sizes)
    n = 0
    for kb, (k, dils) in enumerate(zip(spec.kernel_sizes, spec.dilations)):
        for p, d in enumerate(dils):
            resid = x if p == 0 else xb
            step(resid, n, k, d, t1)  # t1 = conv_{k,d}(act(xb))
            if p < len(dils) - 1:  # xb += conv_{k,1}(act(t1))
                step(t1, n + 1, k, 1, xb, res=resid)
            else:  # last pair of the block: fold xb into the running sum
                final = kb == n_blk - 1
                step(
                    t1, n + 1, k, 1, y if final else acc,
                    res=resid, acc_in=acc if kb > 0 else None,
                    scale=1.0 / n_blk if final else 1.0,
                )
            n += 2
    return y


def amp_stage(x: torch.Tensor, packed: dict, spec: StageSpec, v1: bool = False) -> torch.Tensor:
    """[B, C, T] -> [B, C, T], one fused stage; `v1` picks the v1 contract."""
    if x.device.type == "cpu":
        return (stage_reference_v1 if v1 else stage_reference)(x, packed, spec)
    return _run_kernel(x, packed, spec, v1)


amp_stage.launches = 0  # K2 launches (18 per stage call), counted in _run_kernel


# ---- K2-v1: the whole stage in one launch -----------------------------------

V1_MAX_CHANNELS = 48  # widest stage whose three float32 planes and halo fit a block


def v1_tile(c: int, spec: StageSpec, scratch_floats: int, smem_bytes: int) -> int:
    """Columns a K2-v1 block stores: the most that fit the block's shared
    memory (`smem_bytes`, the library's budget) beside the halo (a multiple
    of 4, at most 1024). Per block: the scratch, three planes of
    C x (W + 2 R) (one with 2 * conv_reach zero columns more) and the
    running sum C x W."""
    fixed = scratch_floats + c * (6 * spec.receptive + 2 * spec.conv_reach)
    w = (smem_bytes // 4 - fixed) // (4 * c)
    return min(w // 4 * 4, 1024)


def _v1_args(x: torch.Tensor, packed: dict, spec: StageSpec, lib) -> dict:
    """What a K2-v1 launch needs besides x, made once per dtype and device
    and kept in `packed` (a snapshot of the weights, like `packed` itself):
    the weights in the kernel's layout, the float32 columns, the tile plan
    and the spec as C arrays."""
    key = ("v1", x.dtype, x.device)
    if key not in packed:
        ws, cols, _ = _kernel_args(x, packed, spec)
        c = spec.channels
        scratch = lib.dmel_stage_v1_scratch_floats()
        tile = v1_tile(c, spec, scratch, lib.dmel_stage_v1_smem_bytes())
        cp = -(-c // 8) * 8
        ci_chunk = min(c, scratch // (max(spec.kernel_sizes) * cp))
        max_d = max(len(d) for d in spec.dilations)
        if tile < 4 or ci_chunk < 1 or len(spec.kernel_sizes) > 8 or max_d > 8:
            raise ValueError(f"K2-v1 cannot hold {spec} in one block's shared memory")
        ints = ctypes.c_int * len(spec.kernel_sizes)
        dils = [d for row in spec.dilations for d in (*row, *([0] * (max_d - len(row))))]
        packed[key] = {
            # [k, out, in] -> [k, in, out padded to a multiple of 8], one after another
            "wt": torch.cat([F.pad(w.transpose(1, 2), (0, cp - c)).reshape(-1) for w in ws]),
            **cols, "tile": tile, "ci_chunk": ci_chunk, "max_d": max_d,
            "ks": ints(*spec.kernel_sizes), "n_dils": ints(*map(len, spec.dilations)),
            "dils": (ctypes.c_int * len(dils))(*dils), "taps": library.taps(FILT),
        }
    return packed[key]


def _run_kernel_v1(x: torch.Tensor, packed: dict, spec: StageSpec) -> torch.Tensor:
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
    rc = lib.dmel_stage_v1(
        x.data_ptr(), a["wt"].data_ptr(), a["b"].data_ptr(), a["a"].data_ptr(),
        a["ib"].data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16),
        bsz, c, t, a["tile"], spec.receptive, spec.conv_reach, a["ci_chunk"],
        len(spec.kernel_sizes), a["ks"], a["n_dils"], a["dils"], a["max_d"], a["taps"],
        library.stream(x),
    )
    library.check(lib, rc, "dmel_stage_v1")
    amp_stage_v1.launches += 1
    return y


def amp_stage_v1(x: torch.Tensor, packed: dict, spec: StageSpec) -> torch.Tensor:
    """[B, C, T] -> [B, C, T], one fused stage in one launch (C <= V1_MAX_CHANNELS)."""
    if x.device.type == "cpu":
        return stage_reference_v1(x, packed, spec)
    return _run_kernel_v1(x, packed, spec)


amp_stage_v1.launches = 0  # K2-v1 launches (1 per stage call), counted in _run_kernel_v1
