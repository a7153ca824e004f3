"""Host C++ kernels of the data loader (WAV decode, resampling), built with
the host compiler at first use and bound with ctypes (`native/build.py`)."""

from dmel_codec_tpu_torch.native.build import load_library, native_available

__all__ = ["load_library", "native_available"]
