"""dmel_codec_tpu_torch — the dMel codec serving path in PyTorch + CUDA.

A port of `dmel_codec_tpu` (JAX, the reference it is tested against) for
NVIDIA Hopper. Same layer map as the JAX package:

  dsp/       log-mel front end
  nn/        WaveNet, ConvNeXt, snake, kaiser-sinc resamplers, weight-norm convs
  ops/       hand-written CUDA kernels (csrc/) with a plain PyTorch version each
  quantize/  FSQ + grouped/residual wrappers + the downsample sandwich
  models/    DMelCodec and the BigVGAN vocoder (module and serving forms)
  utils/     masks
  convert.py JAX parameter trees -> this package's state_dicts

Modules run channels-first ([B, C, T]) inside; the public codec and vocoder
entry points keep the JAX package's layouts. Nothing here imports jax.
"""

__version__ = "0.1.0"
