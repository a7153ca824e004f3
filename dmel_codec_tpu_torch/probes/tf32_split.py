"""The split-TF32 arithmetic of K2's and K2-v1's float32 convs, on one conv
of the flagship vocoder: each float32 operand x is split into
hi = tf32(x) and lo = tf32(x - hi) (round to nearest, ties away, as
`cvt.rna.tf32.f32`), and the conv is A_hi B_hi + A_hi B_lo + A_lo B_hi
(three products; four with A_lo B_lo) in float32 sums. A product of two
TF32 values is exact in float32, so what differs from the float32 conv is
the split's remainder (about 2^-22 of each operand) and the order of the
sums.

    python -m dmel_codec_tpu_torch.probes.tf32_split

On the card the split products run on the tensor cores through cuDNN's
TF32 convs (the pre-split operands lose nothing there), beside the float32
conv with TF32 off and a float64 one. Prints, per shape, the largest error
of each against float64, relative to max |float64| and to max(1, max |y|)
(the kernels' tolerance measure); `main()` returns the table. The split is
`ops/stage_fused.split_tf32`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from dmel_codec_tpu_torch.ops.stage_fused import split_tf32
from dmel_codec_tpu_torch.probes.timing import require_gpu

# (name, B, C, T, k, d): the widest and the narrowest conv of s2 and s4 of a 16 x 4 s request (B cut to 2)
SHAPES = (("s2 k 11 d 5", 2, 192, 372 * 32, 11, 5), ("s2 k 3 d 1", 2, 192, 372 * 32, 3, 1),
          ("s4 k 11 d 5", 2, 48, 372 * 128, 11, 5), ("s4 k 7 d 3", 2, 48, 372 * 128, 7, 3))


def split_conv(x: torch.Tensor, w: torch.Tensor, d: int, products: int = 3) -> torch.Tensor:
    """conv1d (same padding, dilation d) of float32 x [B, C, T] with w
    [C_out, C_in, k] as the sum of the split products."""
    (xh, xl), (wh, wl) = split_tf32(x), split_tf32(w)
    pad = d * (w.shape[2] - 1) // 2
    terms = [(xh, wh), (xh, wl), (xl, wh), (xl, wl)][:products]
    y = None
    for a, b in terms:
        t = F.conv1d(a, b, padding=pad, dilation=d)
        y = t if y is None else y + t
    return y


def main() -> dict:
    require_gpu("tf32_split")
    saved = torch.backends.cudnn.allow_tf32
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = {}
    try:
        for name, b, c, t, k, d in SHAPES:
            # activation outputs are O(1); weights as `random_pack`'s
            x = torch.randn((b, c, t), device="cuda", generator=gen)
            w = torch.randn((c, c, k), device="cuda", generator=gen) / math.sqrt(k * c)
            pad = d * (k - 1) // 2
            want = F.conv1d(x.double(), w.double(), padding=pad, dilation=d)
            scale, floor = want.abs().max().item(), max(1.0, want.abs().max().item())
            got = {}
            torch.backends.cudnn.allow_tf32 = False
            got["float32"] = F.conv1d(x, w, padding=pad, dilation=d)
            torch.backends.cudnn.allow_tf32 = True
            got["tf32 (one product)"] = F.conv1d(x, w, padding=pad, dilation=d)
            got["split, 3 products"] = split_conv(x, w, d, 3)
            got["split, 4 products"] = split_conv(x, w, d, 4)
            row = table[name] = {}
            for what, y in got.items():
                err = (y.double() - want).abs().max().item()
                row[what] = {"rel_max": err / scale, "rel_tol": err / floor}
                print(f"{name} [{b}, {c}, {t}]: {what:<20} largest error {err:.3e} = {err / scale:.3e} of max |y| "
                      f"({scale:.3f}), {err / floor:.3e} of max(1, max |y|)")
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return table


if __name__ == "__main__":
    main()
