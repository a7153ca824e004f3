"""BigVGAN vocoder, mel -> waveform (port of `dmel_codec_tpu/models/bigvgan.py`).

conv_pre (k7) -> N x [weight-norm transposed-conv upsample -> averaged
parallel AMP resblocks] -> anti-aliased snake -> conv_post (k7) ->
clamp (or tanh). Module names are the reference generator's (conv_pre,
ups.{i}.0, resblocks.{n}.convs1/convs2 (AMPBlock1) or .convs (AMPBlock2),
.activations.{a}.act, activation_post, conv_post), so
`bigvgan_generator.pt` state_dict keys line up (`load_torch_checkpoint`,
`from_pretrained`). The reference's filter buffers are module constants
here (ops/anti_alias.FILT) and are dropped on load.

Two forwards on the same weights:
  * `BigVGAN.forward` — the module form; every activation goes through
    ops/anti_alias (kernel K1 on the card);
  * `FusedBigVGAN` — the serving form (the JAX `bigvgan_apply_fused`):
    weight norm materialised once, and every stage with
    C <= fuse_max_channels runs its three resblocks as one fused stage
    (ops/stage_fused: kernel K2, or K2-v1 with `use_v2=False` where it
    holds the stage).
Input mel [B, T, num_mels], output waveform [B, T * prod(upsample_rates)].
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from dmel_codec_tpu_torch.nn.snake import SnakeBeta
from dmel_codec_tpu_torch.nn.weight_norm import WNConv1d, WNConvTranspose1d
from dmel_codec_tpu_torch.ops.anti_alias import anti_alias_activation
from dmel_codec_tpu_torch.ops.stage_fused import (
    V1_MAX_CHANNELS,
    StageSpec,
    amp_stage,
    amp_stage_v1,
    pack_stage,
)
from dmel_codec_tpu_torch.utils.trace import span


@dataclasses.dataclass(frozen=True)
class BigVGANConfig:
    """Defaults = the bigvgan_v2_24khz_100band_256x generator."""

    num_mels: int = 100
    upsample_rates: Tuple[int, ...] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock: str = "1"  # "1": AMPBlock1, "2": AMPBlock2
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"
    snake_logscale: bool = True
    use_bias_at_final: bool = False
    use_tanh_at_final: bool = False

    @property
    def hop_total(self) -> int:
        return math.prod(self.upsample_rates)

    @property
    def num_kernels(self) -> int:
        return len(self.resblock_kernel_sizes)

    def stage_channels(self, i: int) -> int:
        return self.upsample_initial_channel // (2 ** (i + 1))


def _get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class AliasFreeActivation(nn.Module):
    """2x upsample -> snake/snakebeta -> 2x downsample per channel
    (the reference's Activation1d; parameters under `.act`)."""

    def __init__(self, channels: int, activation: str, logscale: bool):
        super().__init__()
        self.act = SnakeBeta(channels, activation, logscale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return anti_alias_activation(x, self.act.alpha, self.act.beta, self.act.logscale)


class AMPBlock1(nn.Module):
    """Dilated + plain conv pairs with anti-aliased snake before each conv."""

    def __init__(self, channels: int, kernel_size: int, dilation: Sequence[int], activation: str, logscale: bool):
        super().__init__()
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, d, _get_padding(kernel_size, d))
            for d in dilation
        )
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, 1, _get_padding(kernel_size, 1))
            for _ in dilation
        )
        self.activations = nn.ModuleList(
            AliasFreeActivation(channels, activation, logscale) for _ in range(2 * len(dilation))
        )

    def forward(self, x: torch.Tensor, weights: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """weights: the convs' materialised weights in (convs1[0], convs2[0],
        convs1[1], ...) order; computed from (v, g) when absent."""
        for j, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            w1, w2 = (c1.weight(), c2.weight()) if weights is None else weights[2 * j : 2 * j + 2]
            xt = self.activations[2 * j](x)
            xt = F.conv1d(xt, w1, c1.bias, padding=c1.padding, dilation=c1.dilation)
            xt = self.activations[2 * j + 1](xt)
            xt = F.conv1d(xt, w2, c2.bias, padding=c2.padding)
            x = x + xt
        return x


class AMPBlock2(nn.Module):
    """One dilated conv per anti-aliased snake."""

    def __init__(self, channels: int, kernel_size: int, dilation: Sequence[int], activation: str, logscale: bool):
        super().__init__()
        self.convs = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, d, _get_padding(kernel_size, d))
            for d in dilation
        )
        self.activations = nn.ModuleList(
            AliasFreeActivation(channels, activation, logscale) for _ in dilation
        )

    def forward(self, x: torch.Tensor, weights: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """weights: the convs' materialised weights; computed from (v, g) when absent."""
        for j, conv in enumerate(self.convs):
            w = conv.weight() if weights is None else weights[j]
            xt = F.conv1d(self.activations[j](x), w, conv.bias, padding=conv.padding, dilation=conv.dilation)
            x = x + xt
        return x


class BigVGAN(nn.Module):
    """mel [B, T, num_mels] -> waveform [B, T * prod(upsample_rates)]."""

    def __init__(self, config: BigVGANConfig = BigVGANConfig()):
        super().__init__()
        cfg = self.config = config
        block_cls = {"1": AMPBlock1, "2": AMPBlock2}[cfg.resblock]
        ch0 = cfg.upsample_initial_channel
        self.conv_pre = WNConv1d(cfg.num_mels, ch0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch = cfg.stage_channels(i)
            self.ups.append(nn.ModuleList([WNConvTranspose1d(2 * ch, ch, k, u, (k - u) // 2)]))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(block_cls(ch, rk, rd, cfg.activation, cfg.snake_logscale))
        ch = cfg.stage_channels(len(cfg.upsample_rates) - 1)
        self.activation_post = AliasFreeActivation(ch, cfg.activation, cfg.snake_logscale)
        self.conv_post = WNConv1d(ch, 1, 7, padding=3, bias=cfg.use_bias_at_final)

    def stage_blocks(self, i: int) -> Sequence[nn.Module]:
        nk = self.config.num_kernels
        return self.resblocks[i * nk : (i + 1) * nk]

    def _finish(self, x: torch.Tensor) -> torch.Tensor:
        if self.config.use_tanh_at_final:
            return torch.tanh(x)
        return torch.clamp(x, -1.0, 1.0)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up[0](x)
            blocks = self.stage_blocks(i)
            x = sum(blk(x) for blk in blocks) / len(blocks)
        x = self.conv_post(self.activation_post(x))[:, 0]
        return self._finish(x)


def _block_convs(block: nn.Module) -> Sequence[WNConv1d]:
    """A resblock's convs in the order its forward takes their weights."""
    if isinstance(block, AMPBlock2):
        return list(block.convs)
    return [conv for pair in zip(block.convs1, block.convs2) for conv in pair]


class FusedBigVGAN:
    """Serving forward of a BigVGAN (port of `bigvgan_apply_fused`).

    Built once per weight set: every conv's weight norm is materialised, and
    each AMPBlock1 stage with C <= fuse_max_channels is packed for the fused
    stage op (weights in the model's dtype). Same function as
    `BigVGAN.forward`. `routes` says, stage by stage, what runs the resblock
    group and under which contract: "block" (per block, activations through
    K1), "K2" (v2), and with `use_v2=False` (the JAX v1 contract at every
    fused stage) "K2-v1" for stages of at most V1_MAX_CHANNELS channels and
    "K2/v1" (K2's launches in v1 mode) for wider ones. The routes are fixed
    here and no run changes them. A call marks its parts with the spans
    `vocoder.pre`, `vocoder.s<i>` and `vocoder.post` (`utils/trace.py`).
    """

    @torch.no_grad()
    def __init__(self, model: BigVGAN, fuse_max_channels: int = 192, use_v2: bool = True):
        self.model = model
        cfg = self.config = model.config
        dtype = model.conv_pre.weight_v.dtype
        self.conv_pre = model.conv_pre.weight()
        self.conv_post = model.conv_post.weight()
        self.ups = [up[0].weight() for up in model.ups]
        self.routes = []
        self.stages = []  # per stage: (spec, packed) fused, or (None, weights) per-block
        for i in range(len(cfg.upsample_rates)):
            ch = cfg.stage_channels(i)
            blocks = model.stage_blocks(i)
            if cfg.resblock == "1" and ch <= fuse_max_channels:
                spec = StageSpec(
                    channels=ch,
                    kernel_sizes=tuple(cfg.resblock_kernel_sizes),
                    dilations=tuple(tuple(d) for d in cfg.resblock_dilation_sizes),
                    activation=cfg.activation,
                    logscale=cfg.snake_logscale,
                )
                packed = pack_stage(blocks, spec)
                packed["w"] = [w.to(dtype) for w in packed["w"]]
                self.stages.append((spec, packed))
                self.routes.append("K2" if use_v2 else "K2-v1" if ch <= V1_MAX_CHANNELS else "K2/v1")
            else:
                weights = [[conv.weight() for conv in _block_convs(b)] for b in blocks]
                self.stages.append((None, weights))
                self.routes.append("block")

    @property
    def device(self) -> torch.device:
        return self.conv_pre.device

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_pre.dtype

    @torch.no_grad()
    def pre(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T, num_mels] -> conv_pre output [B, C0, T]."""
        return F.conv1d(mel.transpose(1, 2), self.conv_pre, self.model.conv_pre.bias, padding=3)

    @torch.no_grad()
    def stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Upsample stage i: transposed conv, then the resblock group."""
        up = self.model.ups[i][0]
        x = F.conv_transpose1d(x, self.ups[i], up.bias, stride=up.stride, padding=up.padding)
        return self.resblocks(i, x)

    @torch.no_grad()
    def resblocks(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Stage i's resblock group on its upsampled input, by its route."""
        spec, arg = self.stages[i]
        if spec is not None:
            if self.routes[i] == "K2-v1":
                return amp_stage_v1(x, arg, spec)
            return amp_stage(x, arg, spec, v1=self.routes[i] == "K2/v1")
        blocks = self.model.stage_blocks(i)
        return sum(b(x, w) for b, w in zip(blocks, arg)) / len(blocks)

    @torch.no_grad()
    def post(self, x: torch.Tensor) -> torch.Tensor:
        m = self.model
        x = F.conv1d(m.activation_post(x), self.conv_post, m.conv_post.bias, padding=3)
        return m._finish(x[:, 0])

    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        with span("vocoder.pre"):
            x = self.pre(mel)
        for i in range(len(self.stages)):
            with span(f"vocoder.s{i}"):
                x = self.stage(i, x)
        with span("vocoder.post"):
            return self.post(x)


# ---- the reference's checkpoint format ---------------------------------------

# Persistent buffers of the reference's Activation1d; constants here.
_FILTER_BUFFERS = (".upsample.filter", ".downsample.lowpass.filter")


def _module_state_dict(sd: dict) -> dict:
    """A reference generator state_dict in this module's names: the filter
    buffers dropped, and weight norm's parametrization keys
    (`parametrizations.weight.original0/1` = g / v) as `weight_g` / `weight_v`."""
    out = {}
    for key, value in sd.items():
        if key.endswith(_FILTER_BUFFERS):
            continue
        key = key.replace(".parametrizations.weight.original0", ".weight_g")
        key = key.replace(".parametrizations.weight.original1", ".weight_v")
        out[key] = value
    return out


def load_torch_checkpoint(path: str, config: BigVGANConfig) -> BigVGAN:
    """A `bigvgan_generator.pt` file (`{"generator": state_dict}` or a bare
    state_dict) -> BigVGAN in the checkpoint's dtype, on the CPU, in eval
    mode. Apart from the filter buffers the keys must match exactly."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = _module_state_dict(ckpt.get("generator", ckpt))
    model = BigVGAN(config)
    model.to(next(v.dtype for v in sd.values() if v.is_floating_point()))
    model.load_state_dict(sd, strict=True)
    return model.eval()


def _resolve_pretrained_files(
    model_id: str,
    cache_dir: Optional[str] = None,
    revision: Optional[str] = None,
    local_files_only: bool = False,
) -> Tuple[str, str]:
    """A local directory or a Hugging Face hub id -> (config.json,
    bigvgan_generator.pt) paths. A hub id resolves through the local hub
    cache first; only a cache miss tries a download, which
    `local_files_only=True` forbids. A directory never touches the hub."""
    if os.path.isdir(model_id):
        return (
            os.path.join(model_id, "config.json"),
            os.path.join(model_id, "bigvgan_generator.pt"),
        )
    try:
        from huggingface_hub import hf_hub_download
        from huggingface_hub.utils import LocalEntryNotFoundError
    except ImportError as e:
        raise ImportError(
            f"{model_id!r} is not a directory, and resolving it as a hub id needs "
            "huggingface_hub, which is not installed"
        ) from e
    paths = []
    for filename in ("config.json", "bigvgan_generator.pt"):
        kw = dict(revision=revision, cache_dir=cache_dir)
        try:
            path = hf_hub_download(model_id, filename, local_files_only=True, **kw)
        except LocalEntryNotFoundError:
            if local_files_only:
                raise
            path = hf_hub_download(model_id, filename, **kw)
        paths.append(path)
    return paths[0], paths[1]


def from_pretrained(
    model_id: str,
    cache_dir: Optional[str] = None,
    revision: Optional[str] = None,
    local_files_only: bool = False,
) -> BigVGAN:
    """A BigVGAN release (`config.json` + `bigvgan_generator.pt`) from a local
    directory or a Hugging Face hub id, resolved as `_resolve_pretrained_files`
    says."""
    config_path, weights_path = _resolve_pretrained_files(
        model_id, cache_dir=cache_dir, revision=revision, local_files_only=local_files_only
    )
    with open(config_path) as f:
        h = json.load(f)
    config = BigVGANConfig(
        num_mels=h["num_mels"],
        upsample_rates=tuple(h["upsample_rates"]),
        upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
        upsample_initial_channel=h["upsample_initial_channel"],
        resblock=str(h["resblock"]),
        resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in h["resblock_dilation_sizes"]),
        activation=h["activation"],
        snake_logscale=bool(h["snake_logscale"]),
        use_bias_at_final=bool(h.get("use_bias_at_final", True)),
        use_tanh_at_final=bool(h.get("use_tanh_at_final", True)),
    )
    return load_torch_checkpoint(weights_path, config)
