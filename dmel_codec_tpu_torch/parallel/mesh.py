"""Data parallelism over `torch.distributed` (the data half of
`dmel_codec_tpu/parallel/mesh.py`: `data_mesh`, `shard_batch`, `replicated`).

One process per device. Each rank loads its own shard of the cuts
(`host_shard()` -> the loaders' `shard_index`, `num_shards`), the
parameters are replicated (the same seed at init, a broadcast from rank 0
when a run starts), and the train steps sum the gradients over the ranks
before the clip, the non-finite guard and the update.

The JAX step takes its masked means over the whole global batch. A rank's
masked mean of its own shard, averaged over the ranks, is another number
whenever the ranks hold different numbers of valid frames or tokens (which
bucketed batches and zero-length fillers make the rule). So inside
`global_batch(dp)` every masked mean of the losses and metrics divides its
LOCAL sum by the count summed over the ranks (`global_count`), each rank's
loss is its share of the global loss, and the gradients and logged values
are SUMMED over the ranks: the step is the JAX step on the union batch.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist


class DataParallel:
    """Collectives of one data-parallel train step over a process group
    (default: the world)."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the ranks (a new tensor, outside autograd)."""
        out = x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    @torch.no_grad()
    def sum_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum each tensor over the ranks in place, one collective per dtype
        (the tensors are packed into one flat buffer)."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
            offset = 0
            for t in group:
                t.copy_(flat[offset: offset + t.numel()].view_as(t))
                offset += t.numel()

    @torch.no_grad()
    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Overwrite each tensor with rank `src`'s."""
        for t in tensors:
            dist.broadcast(t, src=src, group=self.group)

    def sum_metrics(self, metrics: Dict[str, object]) -> Dict[str, object]:
        """The tensor-valued metrics summed over the ranks in one collective;
        plain numbers (the same on every rank) pass through."""
        keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
        if not keys:
            return dict(metrics)
        packed = self.sum(torch.stack([metrics[k].detach().float().reshape(()) for k in keys]))
        return metrics | dict(zip(keys, packed.unbind()))

    def same_step(self, step: int) -> None:
        """Raise unless every rank is at `step` (all ranks must resume from
        the same checkpoint)."""
        t = torch.tensor([step, -step], dtype=torch.float64, device=self._device())
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        if int(t[0]) != step or int(-t[1]) != step:
            raise RuntimeError(
                f"rank {self.rank} is at step {step}, but the ranks range over steps {int(-t[1])}..{int(t[0])}: "
                "every rank must see the same checkpoint directory"
            )

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def _device(self) -> torch.device:
        if dist.get_backend(self.group) == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")


def data_parallel(use_mesh: bool = True) -> Optional[DataParallel]:
    """The data-parallel collectives when a process group is up and
    `use_mesh` is true (the JAX loops' `data_mesh() if cfg.use_mesh`), else
    None: the single-process path."""
    if use_mesh and dist.is_available() and dist.is_initialized():
        return DataParallel()
    return None


_ACTIVE: Optional[DataParallel] = None


@contextlib.contextmanager
def global_batch(dp: Optional[DataParallel]) -> Iterator[None]:
    """Within the block, `global_count` sums over `dp`'s ranks (no-op for None)."""
    global _ACTIVE
    previous, _ACTIVE = _ACTIVE, dp
    try:
        yield
    finally:
        _ACTIVE = previous


def global_count(n: torch.Tensor) -> torch.Tensor:
    """A rank's count of valid positions, summed over the ranks of the active
    data-parallel step (`global_batch`); `n` itself outside one."""
    return n if _ACTIVE is None else _ACTIVE.sum(n)
