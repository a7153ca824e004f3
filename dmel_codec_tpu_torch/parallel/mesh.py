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

Tensor parallelism and FSDP (the other half of the JAX `parallel/mesh.py`)
lay the LM's parameters out on a 2-D (data, model) `DeviceMesh`
(`dp_tp_mesh`). The JAX package only annotates its leaves and lets XLA's
partitioner place the collectives; here the specs say where each leaf is
cut (`lm_param_pspec`: Megatron's column / row split over the model axis;
`with_fsdp`: ZeRO-3 over the data axis), `shard_lm_params` cuts it, and the
collectives are explicit: `parallel/tensor.py` (the model axis, inside the
model) and `parallel/fsdp.py` (the data axis, around each block).
`ParamLayout` holds a laid-out state's specs and groups, and gives the
optimizer a global norm and a non-finite decision that agree on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
MODEL_AXIS = "model"

Spec = Tuple[Optional[str], ...]  # per dimension: the mesh axis it is cut over, or None


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


# ---------------------------------------------------------------------------
# The (data, model) mesh and the LM's parameter layout
# ---------------------------------------------------------------------------


def mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def data_mesh(data: Optional[int] = None) -> DeviceMesh:
    """1-D data mesh over the first `data` ranks (default: all)."""
    data = dist.get_world_size() if data is None else data
    return DeviceMesh(mesh_device_type(), torch.arange(data), mesh_dim_names=(DATA_AXIS,))


def dp_tp_mesh(model: int, data: Optional[int] = None) -> DeviceMesh:
    """2-D (data, model) mesh over the first data * model ranks of the
    process group: `model`-way tensor parallel within groups of contiguous
    ranks (`np.arange(data * model).reshape(data, model)`, the JAX package's
    device grid), data parallel across them. `data` defaults to world //
    model. Every rank of the group must call it (it makes the subgroups)."""
    world = dist.get_world_size()
    if data is None:
        data = world // model
    if model < 1 or data < 1 or data * model > world:
        raise ValueError(f"a {data} x {model} (data, model) mesh needs {data * model} of the {world} ranks")
    return DeviceMesh(mesh_device_type(), torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The mesh's extent along `axis`; 1 for an axis the mesh lacks."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_group(mesh: DeviceMesh, axis: str):
    """This rank's process group along `axis`, or None for an axis the mesh lacks."""
    return mesh.get_group(axis) if axis in (mesh.mesh_dim_names or ()) else None


# column-parallel: output features cut (their consumers keep the shard
# local); row-parallel: input features cut (the contraction over the shard
# is completed by one all-reduce per block)
_TP_COL_PARENTS = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "text_head", "audio_head")
_TP_ROW_PARENTS = ("o_proj", "down_proj")


def lm_param_pspec(name: str, tensor: torch.Tensor, model_size: int) -> Spec:
    """Megatron spec of one LM parameter, by its name in `ChatMusicLM`.

    The JAX rules on torch's layouts: an `nn.Linear` weight is [out, in]
    where a flax kernel is [in, out], so a column-parallel weight and its
    bias are cut on dim 0 and a row-parallel weight on dim 1. A dimension
    that `model_size` does not divide falls back to replication."""
    parts = name.split(".")
    parent = parts[-2] if len(parts) >= 2 else ""
    replicated: Spec = (None,) * tensor.dim()

    def cut(dim: int) -> Spec:
        if tensor.shape[dim] % model_size:
            return replicated
        return tuple(MODEL_AXIS if i == dim else None for i in range(tensor.dim()))

    if parent in _TP_COL_PARENTS and parts[-1] in ("weight", "bias"):
        return cut(0)
    if parent in _TP_ROW_PARENTS and parts[-1] == "weight":
        return cut(1)
    return replicated


def with_fsdp(spec: Spec, tensor: torch.Tensor, data_size: int, flax_kernel: bool = False) -> Spec:
    """ZeRO-3 over the data axis on top of `spec`: cut the largest
    dimension that is still whole and that `data_size` divides. 0-D and 1-D
    leaves (norm weights, biases) stay as they are.

    Ties go to the dimension that comes first in the JAX package's layout:
    `flax_kernel` marks an `nn.Linear` weight, whose dimensions are the
    flax kernel's reversed (a square `q_proj` is then cut on `in`, torch's
    dim 1, as the JAX function cuts the kernel's axis 0). At `data_size` 1
    the cut is the whole dimension: the collectives run over one rank."""
    if tensor.dim() < 2:
        return spec
    entries = list(spec) + [None] * (tensor.dim() - len(spec))
    order = range(tensor.dim() - 1, -1, -1) if flax_kernel else range(tensor.dim())
    free = [i for i in order if entries[i] is None and tensor.shape[i] % data_size == 0]
    if not free:
        return tuple(entries)
    entries[max(free, key=lambda i: tensor.shape[i])] = DATA_AXIS
    return tuple(entries)


def is_linear_weight(name: str, tensor: torch.Tensor) -> bool:
    """True for the 2-D weights of `ChatMusicLM` that are `nn.Linear`s (the
    three embedding tables are the other 2-D leaves)."""
    return tensor.dim() == 2 and not name.endswith("embed.weight")


def lm_param_specs(params: Dict[str, torch.Tensor], model_size: Optional[int] = None,
                   data_size: Optional[int] = None) -> Dict[str, Spec]:
    """The spec of every LM parameter: Megatron specs over a model axis of
    `model_size`, then ZeRO-3 over a data axis of `data_size`; None leaves
    that axis out."""
    specs = {}
    for name, t in params.items():
        spec = lm_param_pspec(name, t, model_size) if model_size is not None else (None,) * t.dim()
        specs[name] = spec if data_size is None else with_fsdp(spec, t, data_size, is_linear_weight(name, t))
    return specs


def lm_param_shardings(params: Dict[str, torch.Tensor], mesh: DeviceMesh, fsdp: bool = False) -> Dict[str, Spec]:
    """`lm_param_specs` on `mesh`: Megatron specs when the mesh has a model
    axis (even one of size 1), the data axis too with `fsdp`."""
    has_model = MODEL_AXIS in (mesh.mesh_dim_names or ())
    return lm_param_specs(params, axis_size(mesh, MODEL_AXIS) if has_model else None,
                          axis_size(mesh, DATA_AXIS) if fsdp else None)


def _coordinate(mesh: DeviceMesh, axis: str) -> Tuple[int, int]:
    return mesh.get_local_rank(axis), axis_size(mesh, axis)


def shard_lm_params(params: Dict[str, torch.Tensor], mesh: DeviceMesh, fsdp: bool = False,
                    specs: Optional[Dict[str, Spec]] = None) -> Dict[str, torch.Tensor]:
    """This rank's piece of every parameter (new contiguous tensors): each
    dimension of the spec that names an axis is cut into equal contiguous
    chunks, and the rank keeps the chunk of its coordinate on that axis."""
    specs = specs if specs is not None else lm_param_shardings(params, mesh, fsdp)
    out = {}
    with torch.no_grad():
        for name, t in params.items():
            piece = t.detach()
            for dim, axis in enumerate(specs[name]):
                if axis is not None:
                    index, size = _coordinate(mesh, axis)
                    chunk = t.shape[dim] // size
                    piece = piece.narrow(dim, index * chunk, chunk)
            out[name] = piece.contiguous().clone()
    return out


def all_gather_dim(shard: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of one tensor joined along `dim`, in rank order
    (contiguous)."""
    size = dist.get_world_size(group)
    moved = shard.movedim(dim, 0).contiguous()
    out = torch.empty((size * moved.shape[0],) + tuple(moved.shape[1:]), dtype=shard.dtype, device=shard.device)
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(full: torch.Tensor, dim: int, group) -> torch.Tensor:
    """`full` summed over the group and cut along `dim`: this rank's chunk."""
    size = dist.get_world_size(group)
    moved = full.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // size,) + tuple(moved.shape[1:]), dtype=full.dtype, device=full.device)
    dist.reduce_scatter_tensor(out, moved, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim).contiguous()


class ParamLayout:
    """The specs of a laid-out state and its mesh's groups.

    A leaf cut over the model axis holds a different part on each model
    rank, a leaf cut over the data axis a different part on each data rank;
    every other leaf is the same on the ranks of that axis. The global norm
    sums the squares of a cut leaf over the ranks that hold its parts and
    counts a replicated leaf once, and the non-finite guard takes one
    decision over the whole mesh."""

    def __init__(self, mesh: DeviceMesh, specs: Dict[str, Spec]):
        self.mesh = mesh
        self.specs = specs
        self.model_group = axis_group(mesh, MODEL_AXIS)
        self.data_group = axis_group(mesh, DATA_AXIS)
        # 0: replicated, 1: cut over model, 2: cut over data, 3: both
        self.kind = {n: (MODEL_AXIS in s) + 2 * (DATA_AXIS in s) for n, s in specs.items()}

    def data_sharded(self, name: str) -> bool:
        return DATA_AXIS in self.specs[name]

    def _sum_over(self, x: torch.Tensor, group) -> torch.Tensor:
        if group is not None:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    def global_norm(self, names: Sequence[str], tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The L2 norm of the whole (unsharded) tree of `tensors`, named by
        `names`: the same float on every rank."""
        squares = torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]) ** 2
        kinds = torch.tensor([self.kind[n] for n in names], device=squares.device)
        by_kind = torch.zeros(4, device=squares.device).index_add_(0, kinds, squares)
        by_kind[2:] = self._sum_over(by_kind[2:].clone(), self.data_group)
        by_kind[1::2] = self._sum_over(by_kind[1::2].clone(), self.model_group)
        return by_kind.sum().sqrt()

    def all_finite(self, tensors: Sequence[torch.Tensor]) -> bool:
        """Whether every rank's tensors are all finite: one answer everywhere."""
        ok = torch.stack([torch.isfinite(t).all() for t in tensors]).all().float().reshape(1)
        for group in (self.data_group, self.model_group):
            if group is not None:
                dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=group)
        return bool(ok.item())
