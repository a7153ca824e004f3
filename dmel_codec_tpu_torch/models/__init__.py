"""DMelCodec, the BigVGAN vocoder, the discriminator, the slow-fast LM and
its decoder, the reference encoder and the fish-speech Firefly models."""

from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
from dmel_codec_tpu_torch.models.discriminator import MelDiscriminator
from dmel_codec_tpu_torch.models.firefly import FireflyGAN, HiFiGANGenerator
from dmel_codec_tpu_torch.models.lm import ChatMusicLM, SlowFastLMConfig
from dmel_codec_tpu_torch.models.reference_encoder import ReferenceEncoder
from dmel_codec_tpu_torch.models.transformer import Decoder, TransformerConfig

__all__ = [
    "DMelCodec",
    "DMelCodecConfig",
    "MelDiscriminator",
    "BigVGAN",
    "BigVGANConfig",
    "FireflyGAN",
    "HiFiGANGenerator",
    "ChatMusicLM",
    "SlowFastLMConfig",
    "Decoder",
    "TransformerConfig",
    "ReferenceEncoder",
]
