"""One resblock conv of the stages too wide for K2, float32 (kernel K3).

`stage_conv` computes
    out = (conv_{k,d}(a) + b [+ res] [+ acc_in]) / mean_of
on channels-first [B, C, T] float32, `a` being K1's output (the activation
in front of the conv), the conv zero-padded by d (k - 1) / 2 on both sides:
  * on a CPU tensor it runs the plain version, `stage_conv_reference`
    (`act_conv_reference` of ops/stage_fused without the activation);
  * on a CUDA tensor it launches kernel K3 (csrc/stage_conv_tf32.cu) or
    raises: the conv as three TF32 products of each operand split into
    hi + lo on the tensor cores, as K2's float32 launches run theirs.
`FusedBigVGAN` drives it along K2's `launch_plan` for the float32 "block"
stages (C > fuse_max_channels: s0 and s1 of the 24 kHz vocoder), one K1
and one K3 launch per conv, the residual adds, the running sum over the
blocks and their mean in K3's epilogue. The conv's weights go to the card
once, split and laid out by `conv_weights` (`conv_unpack` is its inverse).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from dmel_codec_tpu_torch.ops import library
from dmel_codec_tpu_torch.ops.stage_fused import split_tf32

# The kernel's constants (csrc/stage_conv_tf32.cu): input channels a slot,
# output channels a weight block, activation and weight slots, rows of an
# activation slot at most (one TMA box), and the shared memory a block may
# use. (consumer warpgroups, output channels) of a block, widest first.
K3_KC, K3_NB, K3_A_SLOTS, K3_B_SLOTS, K3_MAX_S = 16, 64, 3, 8, 256
K3_SMEM = 227 * 1024
K3_CONFIGS = ((3, 128), (3, 64), (1, 64))
H100_SMS = 132


class ConvPlan(NamedTuple):
    """A K3 launch's tiling: consumer warpgroups and output channels of a
    block, its output samples (64 a warpgroup), rows of its activation
    slot, the grid (output-channel tiles, time tiles, batch rows) and its
    shared memory in bytes."""

    wgs: int
    bn: int
    bm: int
    rows: int
    grid: Tuple[int, int, int]
    smem_bytes: int


def conv_smem_bytes(wgs: int, bn: int) -> int:
    """Shared memory of a K3 block (the kernel's K3Cfg): the activation and
    weight rings or the epilogue's [BN][BM + 4] tile over them, whichever
    is larger, the rings' barriers and the base's alignment."""
    rings = K3_A_SLOTS * K3_KC * K3_MAX_S * 4 + K3_B_SLOTS * K3_KC * bn * 8
    return max(rings, bn * (64 * wgs + 4) * 4) + 16 * (K3_A_SLOTS + K3_B_SLOTS) + 128


def slot_rows(bm: int, reach: int) -> int:
    """Rows of an activation slot: the tile, the conv's reach on both sides
    and up to 3 rows before them (a TMA box starts on 16 bytes), rounded up
    to 8 mod 16 floats (the fragment loads' 32 lanes then hit 32 banks)."""
    return (bm + 2 * reach + 3 + 7) // 16 * 16 + 8


def conv_plan(b: int, c: int, t: int, k: int, d: int, sms: int = H100_SMS) -> ConvPlan:
    """K3's tiling of a conv of size k and dilation d on [b, c, t]: the
    first of K3_CONFIGS whose slot holds the reach and whose tiles are at
    least `sms` (one a streaming multiprocessor), else the one of them that
    makes the most tiles."""
    reach = d * (k - 1) // 2
    plans = []
    for wgs, bn in K3_CONFIGS:
        bm = 64 * wgs
        rows = slot_rows(bm, reach)
        if rows > K3_MAX_S:
            continue
        grid = (-(-c // bn), -(-t // bm), b)
        plans.append(ConvPlan(wgs, bn, bm, rows, grid, conv_smem_bytes(wgs, bn)))
        if math.prod(grid) >= sms:
            return plans[-1]
    if not plans:
        raise ValueError(f"K3 cannot hold a conv reaching {reach} samples a side")
    return max(plans, key=lambda p: math.prod(p.grid))


def conv_weights(w: torch.Tensor) -> torch.Tensor:
    """A [C_out, C_in, k] float32 conv weight -> the layout K3 streams, each
    weight split into hi = tf32(w), lo = tf32(w - hi) (`split_tf32`):
    [C_out / 64 blocks][C_in / 16 chunks][tap][hi, lo][4][64][4] float32,
    zero-padded; one (chunk, tap) slot of a block is 8 KB."""
    co, ci, k = w.shape
    nblk, kp = -(-co // K3_NB), -(-ci // K3_KC) * K3_KC
    wp = torch.zeros((k, nblk * K3_NB, kp), dtype=torch.float32, device=w.device)
    wp[:, :co, :ci] = w.permute(2, 0, 1)
    t = torch.stack(split_tf32(wp))  # [2, k, blocks * 64, kp]
    t = t.view(2, k, nblk, K3_NB, kp // K3_KC, K3_KC // 4, 4)
    return t.permute(2, 4, 1, 0, 5, 3, 6).contiguous().view(-1)


def conv_unpack(flat: torch.Tensor, c_out: int, c_in: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`conv_weights`' inverse: (hi, lo), each [C_out, C_in, k]."""
    nblk, kp = -(-c_out // K3_NB), -(-c_in // K3_KC) * K3_KC
    t = flat.view(nblk, kp // K3_KC, k, 2, K3_KC // 4, K3_NB, 4).permute(3, 2, 0, 5, 1, 4, 6)
    t = t.reshape(2, k, nblk * K3_NB, kp)[:, :, :c_out, :c_in].permute(0, 2, 3, 1)
    return t[0], t[1]


def stage_conv_reference(
    a: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    dilation: int,
    *,
    res: Optional[torch.Tensor] = None,
    acc_in: Optional[torch.Tensor] = None,
    mean_of: int = 1,
) -> torch.Tensor:
    """One K3 launch as plain PyTorch: F.conv1d with the bias, as
    `AMPBlock1.forward` calls it, then res, acc_in and the mean, each as
    the block route adds them."""
    y = F.conv1d(a, w, bias, padding=dilation * (w.shape[2] - 1) // 2, dilation=dilation)
    if res is not None:
        y = res + y
    if acc_in is not None:
        y = acc_in + y
    if mean_of != 1:
        y = y / mean_of
    return y


@functools.cache
def _sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, res, acc_in) -> None:
    library.check_plane(a, "a")
    b, c, t = a.shape
    if a.dtype != torch.float32 or w.dim() != 3 or w.shape[:2] != (c, c) or w.shape[2] % 2 == 0:
        raise ValueError(f"K3 takes float32 a [B, C, T] and a [C, C, k] weight of odd k, got "
                         f"{a.dtype} {tuple(a.shape)}, {tuple(w.shape)}")
    if bias.shape != (c,) or bias.dtype != torch.float32 or bias.device != a.device or not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous float32 [{c}] on {a.device}")
    for name, v in (("res", res), ("acc_in", acc_in)):
        if v is not None:
            library.check_plane(v, name)
            if v.shape != a.shape or v.dtype != torch.float32 or v.device != a.device:
                raise ValueError(f"{name} must be float32 {tuple(a.shape)} on {a.device}")


def stage_conv(
    a: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    dilation: int,
    *,
    res: Optional[torch.Tensor] = None,
    acc_in: Optional[torch.Tensor] = None,
    mean_of: int = 1,
    packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B, C, T] float32 -> [B, C, T] float32, `stage_conv_reference`'s
    function: by K3 on a CUDA tensor, by the plain version on a CPU one.
    w: [C, C, k] float32, bias: [C]; `packed` is `conv_weights(w)` on a's
    device (made here when absent)."""
    if a.device.type == "cpu":
        return stage_conv_reference(a, w, bias, dilation, res=res, acc_in=acc_in, mean_of=mean_of)
    _check(a, w, bias, res, acc_in)
    lib = library.load()
    b, c, t = a.shape
    k = w.shape[2]
    plan = conv_plan(b, c, t, k, dilation, _sm_count(a.device))
    if packed is None:
        packed = conv_weights(w.to(device=a.device, dtype=torch.float32))
    if packed.device != a.device or packed.numel() != 2 * k * -(-c // K3_NB) * K3_NB * -(-c // K3_KC) * K3_KC:
        raise ValueError(f"packed is not conv_weights of a [{c}, {c}, {k}] weight on {a.device}")
    if t % 4:  # the tensor map wants each row on 16 bytes: zero columns up to a multiple of 4
        a = F.pad(a, (0, -t % 4))
    out = torch.empty((b, c, t), dtype=torch.float32, device=a.device)
    ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
    rc = lib.dmel_stage_conv_tf32(
        a.data_ptr(), b, c, t, a.shape[2], packed.data_ptr(), bias.data_ptr(), ptr(res), ptr(acc_in),
        out.data_ptr(), float(mean_of), k, dilation, plan.wgs, plan.bn, library.stream(a),
    )
    library.check(lib, rc, "dmel_stage_conv_tf32")
    stage_conv.launches += 1
    stage_conv.launches_by_kernel["stage_conv_tf32_kernel"] += 1
    return out


stage_conv.launches = 0  # K3 launches (18 per float32 "block" stage), counted after each launch
stage_conv.launches_by_kernel = {"stage_conv_tf32_kernel": 0}
