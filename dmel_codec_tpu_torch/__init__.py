"""dmel_codec_tpu_torch — the dMel codec and its slow-fast LM in PyTorch + CUDA.

A port of `dmel_codec_tpu` (JAX, the reference it is tested against) for
NVIDIA Hopper. Same layer map as the JAX package:

  dsp/       log-mel front end
  nn/        WaveNet, ConvNeXt, snake, kaiser-sinc resamplers, weight-norm convs
  ops/       hand-written CUDA kernels (csrc/) with a plain PyTorch version each
  quantize/  FSQ + grouped/residual wrappers + the downsample sandwich
  models/    DMelCodec, the BigVGAN vocoder (module and serving forms), the
             Qwen2-style decoder and the slow-fast LM, chunked (streaming)
             codec inference, the zoo (SEANet / SpeechTokenizer / EnCodec,
             fish-speech Firefly) and the reference encoder
  lm/        token grids, tokenizer, sampling, generation, audio -> grid batches
  train/     the LM trainer (full and LoRA) and the codec GAN trainer, their fit
             loops, losses, the optimizer, schedules, checkpoints
  eval/      codec evaluation: metrics, native PESQ, ECAPA speaker similarity,
             the `Evaluation` harness and the codec zoo's adapters
  cli/       entry points (infer_lm, stream_codec, train_lm, train_codec,
             evaluate)
  probes/    development probes of the kernels (K1 ablations, K1's tiling,
             row-shifted reads, the tap-matmul form of a conv)
  data/      WAV loading, cut manifests, the bucketed batch loader
  utils/     masks, precision, YAML configs, logging
  convert.py JAX parameter trees -> this package's state_dicts

Modules run channels-first ([B, C, T]) inside; the public codec and vocoder
entry points keep the JAX package's layouts. Nothing here imports jax.
"""

__version__ = "0.1.0"
