"""Parallelism over `torch.distributed`: process-group initialization
(`multihost.py`) and data parallelism (`mesh.py`)."""

from dmel_codec_tpu_torch.parallel.mesh import DataParallel, data_parallel, global_batch, global_count
from dmel_codec_tpu_torch.parallel.multihost import DistributedConfig, distributed, host_shard, initialize

__all__ = [
    "DataParallel", "DistributedConfig", "data_parallel", "distributed", "global_batch", "global_count",
    "host_shard", "initialize",
]
