"""SEANet + residual-VQ codec family (EnCodec / SpeechTokenizer), port of
`dmel_codec_tpu/models/seanet.py`.

SpeechTokenizer (arXiv:2308.16692) is EnCodec's SEANet encoder / decoder
with a BIDIRECTIONAL 2-layer LSTM in the encoder (its skip duplicates the
input along channels), an 8-layer RVQ and a linear `transform` head to the
semantic dimension. EnCodec 24 kHz: causal convs, a unidirectional LSTM
(`y + x`), no semantic head.

The modules carry the speechtokenizer package's names
(`encoder.model.N.conv.conv.weight_g / weight_v`, `decoder.model.N.convtr.
convtr.*`, resblocks' `block.1 / block.3 / shortcut`, `lstm.weight_ih_l0`,
`quantizer.vq.layers.Q._codebook.embed`, `transform.*`), so a package
checkpoint loads with a strict `load_state_dict` (`load_speechtokenizer`)
and the JAX package's `speechtokenizer_params_from_torch` reads the
`state_dict()`. Convs run channels-first [B, C, T]; the public methods keep
the JAX layouts (audio [B, T], latents [B, L, D], codes [Q, B, L]).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from dmel_codec_tpu_torch.nn.weight_norm import WNConv1d, WNConvTranspose1d


@dataclasses.dataclass(frozen=True)
class SEANetConfig:
    """Shared config for the EnCodec / SpeechTokenizer architecture family
    (a copy of the JAX package's).

    Field names follow the speechtokenizer config.json keys where they
    exist; `ratios` is in DECODER (upsampling) order, the encoder walks it
    reversed, as EnCodec does.
    """

    sample_rate: int = 16000
    audio_channels: int = 1
    n_filters: int = 64
    dimension: int = 1024  # latent width (EnCodec hidden_size)
    ratios: Tuple[int, ...] = (8, 5, 4, 2)
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_base: int = 2
    n_residual_layers: int = 1
    compress: int = 2
    lstm_layers: int = 2
    bidirectional: bool = True  # encoder LSTM (SpeechTokenizer); EnCodec: False
    causal: bool = False  # SpeechTokenizer: False; EnCodec 24k: True
    pad_mode: str = "reflect"
    trim_right_ratio: float = 1.0
    use_conv_shortcut: bool = True  # true_skip=False in EnCodec terms
    # quantizer
    n_q: int = 8
    codebook_size: int = 1024
    # semantic head (SpeechTokenizer only; None/equal dims -> identity)
    semantic_dimension: Optional[int] = 768

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.ratios))

    @staticmethod
    def speechtokenizer(**overrides) -> "SEANetConfig":
        """Flagship SpeechTokenizer config (the package's config.json)."""
        return SEANetConfig(**overrides)

    @staticmethod
    def encodec_24k(**overrides) -> "SEANetConfig":
        """facebook/encodec_24khz-shaped config."""
        base = dict(
            sample_rate=24000,
            n_filters=32,
            dimension=128,
            ratios=(8, 5, 4, 2),
            bidirectional=False,
            causal=True,
            n_q=32,
            codebook_size=1024,
            semantic_dimension=None,
        )
        base.update(overrides)
        return SEANetConfig(**base)

    @staticmethod
    def from_json(path: str, **overrides) -> "SEANetConfig":
        """Load a speechtokenizer-style config.json (the dict the package's
        SpeechTokenizer.load_from_checkpoint reads)."""
        with open(path) as f:
            raw = json.load(f)
        mapped = dict(
            sample_rate=int(raw.get("sample_rate", 16000)),
            n_filters=int(raw.get("n_filters", 64)),
            dimension=int(raw.get("dimension", 1024)),
            ratios=tuple(raw.get("strides", (8, 5, 4, 2))),
            residual_kernel_size=int(raw.get("residual_kernel_size", 3)),
            dilation_base=int(raw.get("dilation_base", 2)),
            n_residual_layers=int(raw.get("n_residual_layers", 1)),
            lstm_layers=int(raw.get("lstm_layers", 2)),
            bidirectional=bool(raw.get("bidirectional", True)),
            n_q=int(raw.get("n_q", 8)),
            codebook_size=int(raw.get("codebook_size", 1024)),
            semantic_dimension=raw.get("semantic_dimension", 768),
        )
        mapped.update(overrides)
        return SEANetConfig(**mapped)


def _pad1d(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    """Torch-semantics 1-D pad on the time axis of [B, C, T], as
    EncodecConv1d._pad1d: reflect padding of an input no longer than the pad
    gets a temporary zero extension (torch's reflect pad raises there),
    trimmed back after reflection."""
    if left == 0 and right == 0:
        return x
    if mode != "reflect":
        return F.pad(x, (left, right))
    length = x.shape[-1]
    max_pad = max(left, right)
    extra = max_pad - length + 1 if length <= max_pad else 0
    if extra:
        x = F.pad(x, (0, extra))
    y = F.pad(x, (left, right), mode="reflect")
    return y[..., : y.shape[-1] - extra] if extra else y


class _NormConv1d(nn.Module):
    """The package's NormConv1d: a weight-normed conv under `conv`."""

    def __init__(self, conv: WNConv1d):
        super().__init__()
        self.conv = conv


class _NormConvTranspose1d(nn.Module):
    """The package's NormConvTranspose1d: a weight-normed conv under `convtr`."""

    def __init__(self, convtr: WNConvTranspose1d):
        super().__init__()
        self.convtr = convtr


class SEANetConv1d(nn.Module):
    """Weight-normalised conv with EnCodec's causal / asymmetric padding
    (EncodecConv1d.forward): padding_total = k_eff - stride; causal pads
    fully left; non-causal splits with the LARGER half left; an extra right
    pad rounds the input up to a whole number of frames."""

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        kernel_size: int,
        stride: int = 1,
        dilation: int = 1,
        causal: bool = False,
        pad_mode: str = "reflect",
    ):
        super().__init__()
        self.conv = _NormConv1d(WNConv1d(in_ch, out_ch, kernel_size, dilation=dilation, stride=stride))
        self.kernel_size, self.stride, self.dilation = kernel_size, stride, dilation
        self.causal, self.pad_mode = causal, pad_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k_eff = (self.kernel_size - 1) * self.dilation + 1
        padding_total = k_eff - self.stride
        length = x.shape[-1]
        n_frames = (length - k_eff + padding_total) / self.stride + 1
        ideal = (int(np.ceil(n_frames)) - 1) * self.stride + k_eff - padding_total
        extra = ideal - length
        if self.causal:
            x = _pad1d(x, padding_total, extra, self.pad_mode)
        else:
            right = padding_total // 2
            x = _pad1d(x, padding_total - right, right + extra, self.pad_mode)
        return self.conv.conv(x)


class SEANetConvTranspose1d(nn.Module):
    """Weight-normalised transposed conv with EnCodec's output trimming
    (EncodecConvTranspose1d.forward): full transposed conv, then unpad
    padding_total = k - stride split causally (by `trim_right_ratio`) or
    evenly."""

    def __init__(
        self, in_ch: int, out_ch: int, kernel_size: int, stride: int, causal: bool = False,
        trim_right_ratio: float = 1.0,
    ):
        super().__init__()
        self.convtr = _NormConvTranspose1d(WNConvTranspose1d(in_ch, out_ch, kernel_size, stride))
        padding_total = kernel_size - stride
        if causal:
            self.right = int(np.ceil(padding_total * trim_right_ratio))
        else:
            self.right = padding_total // 2
        self.left = padding_total - self.right

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.convtr.convtr(x)
        return y[..., self.left : y.shape[-1] - self.right]


class SEANetResnetBlock(nn.Module):
    """ELU -> conv(k, dilated, dim -> dim / compress) -> ELU -> conv(1, -> dim)
    + shortcut (EncodecResnetBlock)."""

    def __init__(self, dim: int, dilation: int, cfg: SEANetConfig):
        super().__init__()
        hidden = dim // cfg.compress
        conv = dict(causal=cfg.causal, pad_mode=cfg.pad_mode)
        self.block = nn.Sequential(
            nn.ELU(),
            SEANetConv1d(dim, hidden, cfg.residual_kernel_size, dilation=dilation, **conv),
            nn.ELU(),
            SEANetConv1d(hidden, dim, 1, **conv),
        )
        self.shortcut = SEANetConv1d(dim, dim, 1, **conv) if cfg.use_conv_shortcut else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.shortcut(x) + self.block(x)


class SLSTM(nn.Module):
    """EnCodec / SpeechTokenizer LSTM block with skip connection on [B, C, T].

    torch's LSTM (gate order i, f, g, o). Bidirectional output is
    [fwd ⊕ bwd] and the skip duplicates the input channels
    (speechtokenizer's SLSTM); unidirectional: y + x (EnCodec)."""

    def __init__(self, dim: int, num_layers: int = 2, bidirectional: bool = False):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, num_layers, batch_first=True, bidirectional=bidirectional)
        self.bidirectional = bidirectional

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, _ = self.lstm(x.transpose(1, 2))
        return y.transpose(1, 2) + (torch.cat([x, x], dim=1) if self.bidirectional else x)


class SEANetEncoder(nn.Module):
    """audio [B, 1, T] -> latent [B, dimension, L] (EncodecEncoder layout, +
    the bidirectional LSTM of SpeechTokenizer). `model`'s indices are the
    package's (ELUs occupy slots)."""

    def __init__(self, cfg: SEANetConfig):
        super().__init__()
        c = cfg
        conv = dict(causal=c.causal, pad_mode=c.pad_mode)
        layers = [SEANetConv1d(c.audio_channels, c.n_filters, c.kernel_size, **conv)]
        mult = 1
        for ratio in reversed(c.ratios):
            width = mult * c.n_filters
            layers += [SEANetResnetBlock(width, c.dilation_base**j, c) for j in range(c.n_residual_layers)]
            layers += [nn.ELU(), SEANetConv1d(width, width * 2, ratio * 2, stride=ratio, **conv)]
            mult *= 2
        layers += [SLSTM(mult * c.n_filters, c.lstm_layers, bidirectional=c.bidirectional), nn.ELU()]
        lstm_out = mult * c.n_filters * (2 if c.bidirectional else 1)
        layers.append(SEANetConv1d(lstm_out, c.dimension, c.last_kernel_size, **conv))
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class SEANetDecoder(nn.Module):
    """latent [B, dimension, L] -> audio [B, audio_channels, T] (EncodecDecoder;
    the LSTM is always unidirectional)."""

    def __init__(self, cfg: SEANetConfig):
        super().__init__()
        c = cfg
        conv = dict(causal=c.causal, pad_mode=c.pad_mode)
        mult = int(2 ** len(c.ratios))
        layers = [
            SEANetConv1d(c.dimension, mult * c.n_filters, c.kernel_size, **conv),
            SLSTM(mult * c.n_filters, c.lstm_layers),
        ]
        for ratio in c.ratios:
            width = mult * c.n_filters
            layers += [
                nn.ELU(),
                SEANetConvTranspose1d(width, width // 2, ratio * 2, ratio, c.causal, c.trim_right_ratio),
            ]
            layers += [SEANetResnetBlock(width // 2, c.dilation_base**j, c) for j in range(c.n_residual_layers)]
            mult //= 2
        layers += [nn.ELU(), SEANetConv1d(c.n_filters, c.audio_channels, c.last_kernel_size, **conv)]
        self.model = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.model(z)


class _Codebook(nn.Module):
    """The package's EuclideanCodebook buffers; only `embed` [N, D] is used."""

    def __init__(self, codebook_size: int, dim: int):
        super().__init__()
        embed = torch.randn(codebook_size, dim)
        self.register_buffer("inited", torch.ones(1))
        self.register_buffer("cluster_size", torch.zeros(codebook_size))
        self.register_buffer("embed", embed)
        self.register_buffer("embed_avg", embed.clone())


class _VectorQuantization(nn.Module):
    def __init__(self, codebook_size: int, dim: int):
        super().__init__()
        self._codebook = _Codebook(codebook_size, dim)


class _ResidualVectorQuantization(nn.Module):
    def __init__(self, num_quantizers: int, codebook_size: int, dim: int):
        super().__init__()
        self.layers = nn.ModuleList(_VectorQuantization(codebook_size, dim) for _ in range(num_quantizers))


class ResidualVQ(nn.Module):
    """Euclidean residual vector quantizer (`vq.layers.Q._codebook.embed`).

    The nearest code of each layer is the argmax of 2 x·e - ‖e‖², the JAX
    package's formula, so that near-ties break alike."""

    def __init__(self, num_quantizers: int, codebook_size: int, dim: int):
        super().__init__()
        self.vq = _ResidualVectorQuantization(num_quantizers, codebook_size, dim)

    def _books(self, st: int, n: int):
        return [layer._codebook.embed for layer in self.vq.layers[st : st + n]]

    @staticmethod
    def _nearest(residual: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
        # residual [B, L, D], codebook [N, D] -> indices [B, L]
        dots = torch.einsum("bld,nd->bln", residual, codebook)
        return torch.argmax(2 * dots - codebook.square().sum(dim=-1), dim=-1)

    def encode(self, z: torch.Tensor, n_q: Optional[int] = None, st: int = 0) -> torch.Tensor:
        """z [B, L, D] -> codes [n_q - st, B, L] (speechtokenizer's
        quantizer.encode runs layers[st:n_q] on the raw features)."""
        n_q = len(self.vq.layers) if n_q is None else n_q
        residual, codes = z, []
        for book in self._books(st, n_q - st):
            book = book.to(z.dtype)
            idx = self._nearest(residual, book)
            residual = residual - book[idx]
            codes.append(idx)
        return torch.stack(codes)

    def decode(self, codes: torch.Tensor, st: int = 0) -> torch.Tensor:
        """codes [Q', B, L] -> features [B, L, D], summing layers st..."""
        return self.decode_layers(codes, st).sum(dim=0)

    def decode_layers(self, codes: torch.Tensor, st: int = 0) -> torch.Tensor:
        """Per-layer quantized features [Q', B, L, D] (the package's
        forward_feature)."""
        return torch.stack([book[idx] for book, idx in zip(self._books(st, codes.shape[0]), codes)])


class SpeechTokenizer(nn.Module):
    """SpeechTokenizer / EnCodec model surface (encode / decode / latents).

    `encode(audio) -> codes [n_q, B, L]` (the package's codebook-first
    layout), `decode(codes) -> audio`, encoder features, per-layer quantized
    features. With `bidirectional=False, semantic_dimension=None` this is
    EnCodec (24 kHz with causal=True)."""

    def __init__(self, config: SEANetConfig = SEANetConfig()):
        super().__init__()
        c = self.config = config
        self.encoder = SEANetEncoder(c)
        self.decoder = SEANetDecoder(c)
        self.quantizer = ResidualVQ(c.n_q, c.codebook_size, c.dimension)
        if c.semantic_dimension and c.semantic_dimension != c.dimension:
            self.transform = nn.Linear(c.dimension, c.semantic_dimension)
        else:
            self.transform = None

    def encode_unquantized(self, audio: torch.Tensor) -> torch.Tensor:
        """audio [B, T] -> encoder latent [B, L, D]."""
        return self.encoder(audio[:, None, :]).transpose(1, 2)

    def encode(self, audio: torch.Tensor, n_q: Optional[int] = None, st: int = 0) -> torch.Tensor:
        """audio [B, T] -> codes [n_q, B, L]."""
        return self.quantizer.encode(self.encode_unquantized(audio), n_q, st)

    def decode(self, codes: torch.Tensor, st: int = 0) -> torch.Tensor:
        """codes [Q', B, L] -> audio [B, T]."""
        features = self.quantizer.decode(codes, st)
        return self.decoder(features.transpose(1, 2))[:, 0]

    def forward_feature(self, audio: torch.Tensor, n_q: Optional[int] = None) -> torch.Tensor:
        """Per-RVQ-layer quantized features [Q, B, L, D]."""
        return self.quantizer.decode_layers(self.encode(audio, n_q))

    def semantic_features(self, audio: torch.Tensor) -> torch.Tensor:
        """RVQ-layer-0 features through the semantic head [B, L, S]."""
        q0 = self.forward_feature(audio, n_q=1)[0]
        return q0 if self.transform is None else self.transform(q0)

    def forward(self, audio: torch.Tensor, n_q: Optional[int] = None):
        """Round trip: (rec_audio [B, T], codes)."""
        codes = self.encode(audio, n_q)
        return self.decode(codes), codes


def load_speechtokenizer(
    config_json: str, ckpt_path: Optional[str] = None
) -> Tuple[SpeechTokenizer, SEANetConfig]:
    """The package's SpeechTokenizer.load_from_checkpoint (config.json +
    SpeechTokenizer.pt): (model on the CPU, config). `ckpt_path=None` keeps
    the random init; a checkpoint loads strictly."""
    cfg = SEANetConfig.from_json(config_json)
    model = SpeechTokenizer(cfg)
    if ckpt_path is not None:
        sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
        model.load_state_dict(sd)
    return model.eval(), cfg
