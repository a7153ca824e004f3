"""FSQ and the downsample-FSQ token bottleneck."""

from dmel_codec_tpu_torch.quantize.fsq import FSQ, GroupedResidualFSQ, ResidualFSQ
from dmel_codec_tpu_torch.quantize.downsample_fsq import DownsampleFiniteScalarQuantize, FSQResult

__all__ = [
    "FSQ",
    "ResidualFSQ",
    "GroupedResidualFSQ",
    "DownsampleFiniteScalarQuantize",
    "FSQResult",
]
