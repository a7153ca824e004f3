"""Multi-process initialization for the training entry points (port of
`dmel_codec_tpu/parallel/multihost.py` onto `torch.distributed`).

One process per device: `initialize` joins the process group, NCCL for a
CUDA device and gloo for the CPU, and gives this process its device,
`cuda:<local rank>`. Rank, world size and the rendezvous come from the
`distributed:` YAML section, else from the variables `torchrun` sets
(`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`):

    distributed:
      enabled: true
      coordinator_address: "10.0.0.1:29500"   # else MASTER_ADDR:MASTER_PORT
      num_processes: 8                         # else WORLD_SIZE
      process_id: 0                            # else RANK
      local_device_ids: [0]                    # else LOCAL_RANK, else rank % cards

Enable it with `--distributed` on the training CLIs or `enabled: true`.
`host_shard()` is then (rank, world size), which the loaders take as
(`shard_index`, `num_shards`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from dmel_codec_tpu_torch.utils.logging import RankedLogger

log = RankedLogger(__name__)


@dataclasses.dataclass
class DistributedConfig:
    """YAML-mappable multi-process settings (`distributed:` section)."""

    enabled: bool = False
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    # the device of this process, as its index among the host's cards
    local_device_ids: Optional[Tuple[int, ...]] = None


def _setting(value, env: str, what: str):
    if value is not None:
        return value
    if env in os.environ:
        return os.environ[env]
    raise ValueError(
        f"distributed training needs {what}: set it in the config's `distributed:` section or launch "
        f"with torchrun (which sets {env})"
    )


def initialize(cfg: Optional[DistributedConfig], device="cuda") -> Tuple[bool, torch.device]:
    """Join the process group if `cfg.enabled`. Returns (whether a process
    group is up after the call, this process's device).

    A group that is already up (made by the caller) is used as it is. On a
    CUDA device without an index the process takes `cuda:<local rank>`."""
    device = torch.device(device)
    if cfg is None or not cfg.enabled:
        return False, device
    if dist.is_initialized():
        return True, _local_device(cfg, device, dist.get_rank())
    rank = int(_setting(cfg.process_id, "RANK", "this process's rank (process_id)"))
    world = int(_setting(cfg.num_processes, "WORLD_SIZE", "the number of processes (num_processes)"))
    address = cfg.coordinator_address
    if address is None:
        address = (f"{_setting(None, 'MASTER_ADDR', 'the coordinator address')}:"
                   f"{_setting(None, 'MASTER_PORT', 'the coordinator port')}")
    device = _local_device(cfg, device, rank)
    backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world, rank=rank, **kwargs)
    log.info(f"process group up: {backend}, rank {rank} of {world}, device {device}")
    return True, device


def _local_device(cfg: DistributedConfig, device: torch.device, rank: int) -> torch.device:
    if device.type != "cuda" or device.index is not None:
        return device
    if cfg.local_device_ids:
        index = int(cfg.local_device_ids[0])
    elif "LOCAL_RANK" in os.environ:
        index = int(os.environ["LOCAL_RANK"])
    else:
        index = rank % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


@contextlib.contextmanager
def distributed(cfg: Optional[DistributedConfig], device="cuda") -> Iterator[torch.device]:
    """`initialize` for the length of a `with` block, which yields the
    device; a process group made here is destroyed at the end."""
    made = cfg is not None and cfg.enabled and not dist.is_initialized()
    _, device = initialize(cfg, device)
    try:
        yield device
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def host_shard(mesh=None) -> Tuple[int, int]:
    """(shard_index, num_shards) for per-process data loading: (rank, world
    size) under a process group, else (0, 1). On a `mesh` with a data axis
    (`parallel/mesh.dp_tp_mesh`), (data coordinate, data size): the ranks of
    one model group read the same batch."""
    if mesh is not None and "data" in (mesh.mesh_dim_names or ()):
        return mesh.get_local_rank("data"), mesh.size(mesh.mesh_dim_names.index("data"))
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
