"""LoRA adapters for LM finetuning (port of `dmel_codec_tpu/train/lora.py`).

Adapters live in a SEPARATE tree, {parameter name: {"a": [in, r],
"b": [r, out]}}, and the merged weights `W + (alpha / rank) * (a @ b).T` are
computed functionally before the model is called (the trainer's `loss_fn`
swaps them in with `torch.func.functional_call`), so the model code is
untouched, gradients reach only the adapter tree, and a "LoRA-only
checkpoint" is a checkpoint of that tree.

Default targets: the attention projections (q/k/v/o) of both decoders. A
target is a 2-D `[out, in]` Linear weight, so `a @ b` is merged transposed.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

DEFAULT_TARGETS = r"self_attn\.(q|k|v|o)_proj\.weight$"


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    # regex matched against the dotted parameter name
    targets: str = DEFAULT_TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _iter_targets(params: Dict[str, torch.Tensor], pattern: str) -> Iterator[Tuple[str, torch.Tensor]]:
    rx = re.compile(pattern)
    for name, leaf in params.items():
        if rx.search(name) and leaf.dim() == 2:
            yield name, leaf


def init_lora(
    params: Dict[str, torch.Tensor], config: LoRAConfig, generator: Optional[torch.Generator] = None
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Adapter tree for every targeted weight. `a` gets a scaled-normal
    init, `b` zeros, so the merged model starts EXACTLY at the base model.
    The leaves require grad; `generator` must live on the parameters'
    device."""
    lora: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, leaf in _iter_targets(params, config.targets):
        d_out, d_in = leaf.shape
        a = torch.randn((d_in, config.rank), dtype=leaf.dtype, device=leaf.device, generator=generator)
        lora[name] = {
            "a": (a / max(d_in, 1) ** 0.5).requires_grad_(),
            "b": torch.zeros((config.rank, d_out), dtype=leaf.dtype, device=leaf.device, requires_grad=True),
        }
    if not lora:
        raise ValueError(f"no parameters matched LoRA targets {config.targets!r}")
    return lora


def merge_lora(
    params: Dict[str, torch.Tensor], lora: Dict[str, Dict[str, torch.Tensor]], config: LoRAConfig
) -> Dict[str, torch.Tensor]:
    """params with W := W + scale * (a @ b).T at every adapted leaf (pure:
    new tensors; the base enters detached, so no gradient reaches it)."""
    merged = {}
    for name, leaf in params.items():
        ab = lora.get(name)
        if ab is None:
            merged[name] = leaf
        else:
            merged[name] = leaf.detach() + config.scale * (ab["a"] @ ab["b"]).T.to(leaf.dtype)
    return merged


def lora_leaves(lora: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The adapter tree flattened to {"<name>.a" / "<name>.b": tensor}."""
    return {f"{name}.{k}": ab[k] for name, ab in lora.items() for k in ("a", "b")}


def lora_param_count(lora: Dict[str, Any]) -> int:
    return sum(t.numel() for t in lora_leaves(lora).values())


def loss_and_grads_lora(
    loss_fn: Callable, base_params: Dict[str, torch.Tensor], lora: Dict[str, Dict[str, torch.Tensor]],
    config: LoRAConfig, *args,
):
    """`loss_fn(merged_params, *args, wrt=adapter leaves)` -> ((loss, out),
    grads): the gradients with respect to the ADAPTER tree only, as a tree
    of its structure (the base stays frozen: no base-sized gradients)."""
    leaves = lora_leaves(lora)
    value, grads = loss_fn(merge_lora(base_params, lora, config), *args, wrt=list(leaves.values()))
    flat = dict(zip(leaves, grads))
    return value, {name: {k: flat[f"{name}.{k}"] for k in ("a", "b")} for name in lora}
