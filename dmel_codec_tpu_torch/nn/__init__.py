"""Building blocks: WaveNet, ConvNeXt, snake, resamplers, weight-norm convs."""
