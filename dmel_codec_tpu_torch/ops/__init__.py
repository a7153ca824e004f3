"""Hand-written CUDA kernels (sources in ../csrc) and their plain versions."""

from dmel_codec_tpu_torch.ops.anti_alias import anti_alias_activation, anti_alias_activation_reference

__all__ = [
    "anti_alias_activation",
    "anti_alias_activation_reference",
]
