"""Fused AMP resblock stage (port of `dmel_codec_tpu/ops/stage_fused.py`).

One BigVGAN upsample stage's resblock group — for k in (3, 7, 11):
xb = x; for d in (1, 3, 5): xb += conv_{k,1}(act(conv_{k,d}(act(xb))));
output = mean of the three xb — on channels-first [B, C, T], from
`pack_stage`'s arrays (weight norm folded, alpha/beta pre-exp'd):
  * on a CPU tensor `amp_stage` runs the plain version, `stage_reference`;
  * on a CUDA tensor it runs kernel K2 (csrc/stage_fused.cu): one launch per
    act -> conv pair, 18 per stage, with no torch op in between.

bf16 contract (the JAX kernel's, stage_fused.py:398-403): activation
input, activation output and conv output are rounded to the input dtype,
the residual spine and the running sum stay float32. For float32 inputs
`stage_reference` is exactly the JAX package's oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from dmel_codec_tpu_torch.nn.resample import downsample1d, upsample1d
from dmel_codec_tpu_torch.ops import library
from dmel_codec_tpu_torch.ops.anti_alias import FILT

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """Static description of one upsample stage's resblock group."""

    channels: int
    kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"  # "snake" | "snakebeta"
    logscale: bool = True


@torch.no_grad()
def pack_stage(resblocks: Sequence[torch.nn.Module], spec: StageSpec) -> dict:
    """AMPBlock1 modules -> {w: 18 x [k, C_out, C_in], b: [C, 18],
    a: [C, 18] (exp'd alpha), ib: [C, 18] (1/(beta+eps))}, float32; one
    column per conv and per the activation in front of it."""
    ws, biases, alphas, inv_betas = [], [], [], []
    for blk in resblocks:
        for c1, c2 in zip(blk.convs1, blk.convs2):
            for conv in (c1, c2):
                ws.append(conv.weight().float().permute(2, 0, 1).contiguous())
                biases.append(conv.bias.float())
        for act in blk.activations:
            alpha = act.act.alpha.float()
            beta = act.act.beta.float() if spec.activation == "snakebeta" else None
            if spec.logscale:
                alpha = torch.exp(alpha)
                beta = torch.exp(beta) if beta is not None else None
            alphas.append(alpha)
            inv_betas.append(1.0 / ((alpha if beta is None else beta) + _EPS))
    return {
        "w": ws,
        "b": torch.stack(biases, dim=1),
        "a": torch.stack(alphas, dim=1),
        "ib": torch.stack(inv_betas, dim=1),
    }


def stage_reference(x: torch.Tensor, packed: dict, spec: StageSpec) -> torch.Tensor:
    """Plain version: float32 arithmetic with the bf16 contract's rounding
    points, result in x's dtype."""
    dt = x.dtype
    filt = torch.from_numpy(FILT)

    def rnd(v):
        return v.to(dt).float()

    n = 0  # conv n and the activation in front of it
    acc = None
    for k, dils in zip(spec.kernel_sizes, spec.dilations):
        xb = x.float()
        for d in dils:
            y = xb
            for which_d in (d, 1):
                a = packed["a"][:, n, None].float()
                ib = packed["ib"][:, n, None].float()
                u = upsample1d(rnd(y), filt, 2, 12)
                s = torch.sin(u * a)
                y = rnd(downsample1d(u + ib * s * s, filt, 2, 12))
                w = packed["w"][n].to(dt).float().permute(1, 2, 0)  # [co, ci, k]
                b = packed["b"][:, n].float()
                y = rnd(F.conv1d(y, w, b, padding=which_d * (k - 1) // 2, dilation=which_d))
                n += 1
            xb = xb + y
        acc = xb if acc is None else acc + xb
    return (acc / len(spec.kernel_sizes)).to(dt)


def _co_tile(c: int) -> int:
    """Output-channel tile of a K2 block (kernel instantiations 24/48/64;
    channels past C are masked)."""
    for tile in (64, 48, 24):
        if c % tile == 0:
            return tile
    return 24


def _run_kernel(x: torch.Tensor, packed: dict, spec: StageSpec) -> torch.Tensor:
    lib = library.load()
    library.check_plane(x)
    bsz, c, t = x.shape
    if c != spec.channels:
        raise ValueError(f"x has {c} channels, spec says {spec.channels}")
    n_convs = sum(2 * len(d) for d in spec.dilations)
    if len(packed["w"]) != n_convs:
        raise ValueError(f"packed has {len(packed['w'])} convs, spec needs {n_convs}")
    dt = x.dtype
    bf = int(dt == torch.bfloat16)
    ws = [w.to(device=x.device, dtype=dt).contiguous() for w in packed["w"]]
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
    f32 = torch.float32
    xb = torch.empty(x.shape, dtype=f32, device=x.device)
    acc = torch.empty_like(xb)
    t1 = torch.empty_like(x)
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
            out.data_ptr(), int(out.dtype == torch.bfloat16), scale, bf,
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


def amp_stage(x: torch.Tensor, packed: dict, spec: StageSpec) -> torch.Tensor:
    """[B, C, T] -> [B, C, T], one fused stage."""
    if x.device.type == "cpu":
        return stage_reference(x, packed, spec)
    return _run_kernel(x, packed, spec)


amp_stage.launches = 0  # K2 launches (18 per stage call), counted in _run_kernel
