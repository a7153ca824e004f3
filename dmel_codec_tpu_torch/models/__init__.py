"""DMelCodec and the BigVGAN vocoder."""
