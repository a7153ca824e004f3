"""Parallelism over `torch.distributed`: process-group initialization
(`multihost.py`), data parallelism, the (data, model) mesh and the LM's
parameter layout (`mesh.py`), Megatron tensor parallelism (`tensor.py`),
FSDP (`fsdp.py`), time-sharded codec inference (`sequence.py`) and the
GPipe decoder (`pipeline.py`)."""

from dmel_codec_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, DataParallel, ParamLayout, data_mesh, data_parallel, dp_tp_mesh, global_batch,
    global_count, lm_param_pspec, lm_param_shardings, lm_param_specs, shard_lm_params, with_fsdp,
)
from dmel_codec_tpu_torch.parallel.multihost import DistributedConfig, distributed, host_shard, initialize
from dmel_codec_tpu_torch.parallel.pipeline import STAGE_AXIS, pipelined_decoder, split_stage_params, stage_mesh
from dmel_codec_tpu_torch.parallel.sequence import time_sharded_decode, time_sharded_encode

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "STAGE_AXIS", "DataParallel", "DistributedConfig", "ParamLayout", "data_mesh",
    "data_parallel", "distributed", "dp_tp_mesh", "global_batch", "global_count", "host_shard", "initialize",
    "lm_param_pspec", "lm_param_shardings", "lm_param_specs", "pipelined_decoder", "shard_lm_params",
    "split_stage_params", "stage_mesh", "time_sharded_decode", "time_sharded_encode", "with_fsdp",
]
