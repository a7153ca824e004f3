"""Seeded random parameters, made on the device in one draw.

The layout (names and shapes) comes from a reference's `param_shapes`, so
the program receives them by name (`load_state_dict(..., strict=True)`) and
the reference is handed the same tensors, made again from the same seed.
"""

from __future__ import annotations

import fnmatch
from typing import Dict, Mapping, Optional

import torch


def _scale(name: str, shape: tuple) -> tuple:
    """(scale, offset) of a parameter drawn as offset + scale * N(0, 1)."""
    leaf = name.rsplit(".", 1)[-1]
    module = name.rsplit(".", 1)[0] if "." in name else ""
    if leaf == "bias":
        return 0.02, 0.0
    if leaf == "weight" and "norm" in module.lower():
        return 0.02, 1.0
    if leaf in ("alpha", "beta", "gamma"):
        return 0.1, 0.0
    if "embed" in module:
        return 0.02, 0.0
    fan_in = 1
    for d in shape[1:]:
        fan_in *= d
    return 1.0 / max(1, fan_in) ** 0.5, 0.0


@torch.no_grad()
def make(shapes: Mapping[str, tuple], seed: int, dtype: torch.dtype, device,
         gains: Optional[Mapping[str, float]] = None) -> Dict[str, torch.Tensor]:
    """name -> tensor of `shapes`, all from ONE seeded draw on `device` in
    `dtype`: dense weights N(0, 1 / fan_in), biases N(0, 0.02^2), norm
    weights 1 + N(0, 0.02^2), embeddings N(0, 0.02^2), snake and layer-scale
    parameters N(0, 0.01); a weight norm's g is the norm of its v times the
    gain of the first pattern in `gains` (fnmatch) that the module's name
    matches (1 where none does: weight = v)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    total = sum(int(torch.Size(s).numel()) for n, s in shapes.items() if not n.endswith("weight_g"))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for name, shape in shapes.items():
        if name.endswith("weight_g"):
            continue
        n = int(torch.Size(shape).numel())
        scale, offset = _scale(name, tuple(shape))
        t = flat[off:off + n].view(shape).mul_(scale)
        out[name] = t.add_(offset) if offset else t
        off += n
    for name, shape in shapes.items():
        if name.endswith("weight_g"):
            v = out[name[: -len("weight_g")] + "weight_v"]
            module = name[: -len(".weight_g")]
            gain = next((g for pattern, g in (gains or {}).items() if fnmatch.fnmatchcase(module, pattern)), 1.0)
            out[name] = (gain * v.float().square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()).to(dtype)
    return {name: out[name] for name in shapes}
