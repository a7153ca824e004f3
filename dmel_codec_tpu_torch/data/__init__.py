"""Host-side audio loading: WAV files, cut manifests, the bucketed loader."""

from dmel_codec_tpu_torch.data.manifest import Cut, load_manifest, save_manifest
from dmel_codec_tpu_torch.data.audio import load_audio, peak_normalize, resample_audio
from dmel_codec_tpu_torch.data.loader import BucketBatcher, DataLoader

__all__ = [
    "Cut",
    "load_manifest",
    "save_manifest",
    "load_audio",
    "resample_audio",
    "peak_normalize",
    "BucketBatcher",
    "DataLoader",
]
