"""Building blocks: WaveNet, ConvNeXt, snake, resamplers, weight-norm convs."""

from dmel_codec_tpu_torch.nn.convnext import ChannelLayerNorm, ConvNeXtBlock
from dmel_codec_tpu_torch.nn.resample import DownSample1d, UpSample1d, kaiser_sinc_filter1d
from dmel_codec_tpu_torch.nn.snake import Snake, SnakeBeta, snake, snake_beta
from dmel_codec_tpu_torch.nn.wavenet import ResidualBlock, WaveNet
from dmel_codec_tpu_torch.nn.weight_norm import WNConv1d, WNConv2d

__all__ = [
    "WaveNet",
    "ResidualBlock",
    "ConvNeXtBlock",
    "ChannelLayerNorm",
    "Snake",
    "SnakeBeta",
    "snake",
    "snake_beta",
    "kaiser_sinc_filter1d",
    "UpSample1d",
    "DownSample1d",
    "WNConv1d",
    "WNConv2d",
]
