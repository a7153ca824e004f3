"""FSDP (ZeRO-3) over the mesh's data axis, written by hand over the
trainer's parameter dict.

Each rank keeps only its shard of every parameter that `mesh.with_fsdp`
cuts, and so AdamW keeps its moments (and the accumulator its sums) at the
shard's shape. The whole leaf exists only while it is used:

  * a forward pre-hook on each unit (every decoder `Block`; every other
    module that owns a cut parameter directly: the embeddings, projectors
    and heads) gathers the unit's parameters over the data group
    (`all_gather_into_tensor`) and swaps them in, a forward hook swaps the
    shards back after the unit has run;
  * the gather is an autograd function whose backward reduce-scatters the
    whole leaf's gradient over the data group (`reduce_scatter_tensor`,
    summed: each rank's loss is its share of the global mean, as in data
    parallelism), so the gradient of a shard is the shard of the summed
    gradient;
  * inside `GatherOnUse.saved_tensors_freed()` a whole leaf that an
    operation keeps for its backward (a matmul keeps its weight) is kept as
    a note of its shard and gathered again when the backward needs it: the
    gathered leaves of a unit are freed once the unit's forward is done, and
    exist again only for the unit's backward.

Under `remat` the blocks' forward runs again in the backward, and its hooks
gather again. Every rank runs the same graph, so the collectives of the
backward come in the same order on every rank.

The JAX package writes none of this: XLA's partitioner derives the same
all-gather-on-use, reduce-scatter-on-gradient schedule from the annotations.
PyTorch's FSDP2 (`fully_shard`) owns the modules' parameters and expects
`.backward()`, where the trainer runs `functional_call` on its own dict and
takes `torch.autograd.grad` of it.
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import Dict, Iterator, List, Tuple

import torch
from torch import nn
from torch.utils.weak import WeakIdKeyDictionary

from dmel_codec_tpu_torch.parallel.mesh import DATA_AXIS, Spec, all_gather_dim, reduce_scatter_dim


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(shard, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.dim, ctx.group), None, None


class _Regather:
    """What a saved gathered leaf (or a view of it) is kept as."""

    def __init__(self, shard, dim, group, view):
        self.shard, self.dim, self.group, self.view = shard, dim, group, view

    def unpack(self) -> torch.Tensor:
        size, stride, offset = self.view
        with torch.no_grad():
            return all_gather_dim(self.shard.detach(), self.dim, self.group).as_strided(size, stride, offset)


def _units(model: nn.Module, names: List[str]) -> Dict[nn.Module, List[Tuple[nn.Module, str, str]]]:
    """unit module -> [(owner module, attribute, full parameter name)] for the
    parameters `names`: a parameter belongs to the innermost `Block` above
    it, else to the module that owns it."""
    from dmel_codec_tpu_torch.models.transformer import Block

    modules = dict(model.named_modules())
    blocks = [p for p, m in modules.items() if isinstance(m, Block)]
    units: Dict[nn.Module, List[Tuple[nn.Module, str, str]]] = {}
    for name in names:
        owner_path, _, attr = name.rpartition(".")
        block = max((p for p in blocks if owner_path == p or owner_path.startswith(p + ".")), key=len, default=None)
        unit = modules[block] if block is not None else modules[owner_path]
        units.setdefault(unit, []).append((modules[owner_path], attr, name))
    return units


class GatherOnUse:
    """Gather-on-use hooks on `model` for every parameter that `specs` cuts
    over the data axis (`group` is the data group), and the record of the
    gathered leaves that are alive (`gathered`: a leaf -> its shard, dim and
    group; weak, so a freed leaf leaves it)."""

    def __init__(self, model: nn.Module, specs: Dict[str, Spec], group):
        self.group = group
        self.gathered = WeakIdKeyDictionary()
        self.cut = {n: s.index(DATA_AXIS) for n, s in specs.items() if DATA_AXIS in s}
        self.handles = []
        for unit, members in _units(model, list(self.cut)).items():
            shards: List[torch.Tensor] = []
            self.handles.append(unit.register_forward_pre_hook(partial(self._gather, members=members, shards=shards)))
            self.handles.append(unit.register_forward_hook(partial(self._release, members=members, shards=shards)))

    def _gather(self, module, args, members, shards) -> None:
        for owner, attr, name in members:
            shard = owner._parameters[attr]
            shards.append(shard)
            full = _Gather.apply(shard, self.cut[name], self.group)
            self.gathered[full] = (shard, self.cut[name], self.group)
            owner._parameters[attr] = full

    def _release(self, module, args, output, members, shards):
        for (owner, attr, _), shard in zip(members, shards):
            owner._parameters[attr] = shard
        shards.clear()
        return output

    def _pack(self, t: torch.Tensor):
        entry = self.gathered.get(t if t._base is None else t._base)
        if entry is None:
            return t
        return _Regather(*entry, (t.size(), t.stride(), t.storage_offset()))

    @staticmethod
    def _unpack(saved):
        return saved.unpack() if isinstance(saved, _Regather) else saved

    @contextlib.contextmanager
    def saved_tensors_freed(self) -> Iterator[None]:
        """Within the block, an operation that keeps a gathered leaf for its
        backward keeps a note of the shard instead (see the module's doc)."""
        with torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack):
            yield
