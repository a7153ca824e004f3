"""Plain reference of the dMel codec: log-mel front end, band-grouped
WaveNet encoder, temporally downsampled grouped FSQ, and the noise-driven
WaveNet mel decoder.

Stands for `dmel_codec_tpu_torch/dsp/spectrogram.py` + `dsp/mel.py`,
`nn/wavenet.py`, `nn/convnext.py`, `quantize/fsq.py`,
`quantize/downsample_fsq.py` and `models/codec.py` (the JAX package's
modules of the same names), written out as functions of a flat parameter
dict under the checkpoint names of the original torch codec
(`ishine/dmel_codec`). Channels-first [B, C, T] inside, mels [B, T, M].
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# ---- sizes -----------------------------------------------------------------


def sizes(cfg: dict) -> dict:
    """The derived sizes of a codec configuration (`DMelCodecConfig`'s
    properties)."""
    g = cfg["dmel_groups"]
    return {
        "band": cfg["n_mels"] // g,
        "concat": g * cfg["encoder_residual_channels"],
        "down": math.prod(cfg["downsample_factor"]),
    }


def _wavenet_shapes(prefix: str, cin: int, cout, c: int, layers: int, cond) -> List[Tuple[str, tuple]]:
    out = []
    if cin != c:
        out += [(f"{prefix}.input_projection.conv.weight", (c, cin, 1)), (f"{prefix}.input_projection.conv.bias", (c,))]
    for i in range(layers):
        p = f"{prefix}.residual_layers.{i}"
        out += [(f"{p}.conv_layer.conv.weight", (2 * c, c, 3)), (f"{p}.conv_layer.conv.bias", (2 * c,))]
        if cond is not None:
            out += [(f"{p}.condition_projection.conv.weight", (2 * c, cond, 1)),
                    (f"{p}.condition_projection.conv.bias", (2 * c,))]
        out += [(f"{p}.output_projection.conv.weight", (2 * c, c, 1)), (f"{p}.output_projection.conv.bias", (2 * c,))]
    out += [(f"{prefix}.skip_projection.conv.weight", (c, c, 1)), (f"{prefix}.skip_projection.conv.bias", (c,))]
    if cout is not None and cout != c:
        out += [(f"{prefix}.output_projection.conv.weight", (cout, c, 1)), (f"{prefix}.output_projection.conv.bias", (cout,))]
    return out


def _convnext_shapes(prefix: str, c: int) -> List[Tuple[str, tuple]]:
    return [
        (f"{prefix}.dwconv.weight", (c, 1, 7)), (f"{prefix}.dwconv.bias", (c,)),
        (f"{prefix}.norm.weight", (c,)), (f"{prefix}.norm.bias", (c,)),
        (f"{prefix}.pwconv1.weight", (4 * c, c)), (f"{prefix}.pwconv1.bias", (4 * c,)),
        (f"{prefix}.pwconv2.weight", (c, 4 * c)), (f"{prefix}.pwconv2.bias", (c,)),
        (f"{prefix}.gamma", (c,)),
    ]


def param_shapes(cfg: dict) -> "OrderedDict[str, tuple]":
    """Every parameter of the codec, by checkpoint name, in a fixed order."""
    s = sizes(cfg)
    res, g, nl = cfg["encoder_residual_channels"], cfg["dmel_groups"], len(cfg["levels"])
    out = _wavenet_shapes("encoder", s["band"], None, res, cfg["encoder_layers"], None)
    for i in range(g):
        p = f"quantizer.residual_fsq.rvqs.{i}"
        out += [(f"{p}.project_in.weight", (nl, res)), (f"{p}.project_in.bias", (nl,)),
                (f"{p}.project_out.weight", (res, nl)), (f"{p}.project_out.bias", (res,))]
    for i, f in enumerate(cfg["downsample_factor"]):
        out += [(f"quantizer.downsample.{i}.0.weight", (res, res, f)), (f"quantizer.downsample.{i}.0.bias", (res,))]
        out += _convnext_shapes(f"quantizer.downsample.{i}.1", res)
    for i, f in enumerate(reversed(cfg["downsample_factor"])):
        out += [(f"quantizer.upsample.{i}.0.weight", (res, res, f)), (f"quantizer.upsample.{i}.0.bias", (res,))]
        out += _convnext_shapes(f"quantizer.upsample.{i}.1", res)
    out += _wavenet_shapes("decoder", s["concat"], cfg["n_mels"], s["concat"], cfg["decoder_layers"], s["concat"])
    out += [("quality_projection.weight", (s["concat"], 1)), ("quality_projection.bias", (s["concat"],))]
    return OrderedDict(out)


# ---- log-mel front end (dsp/mel.py, dsp/spectrogram.py) ----------------------


def _hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, f / f_sp)


def _mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    logstep = np.log(6.4) / 27.0
    min_log_mel = min_log_hz / f_sp
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, f_min: float, f_max: float) -> np.ndarray:
    """Slaney-scale, slaney-normalised triangles [n_mels, n_fft // 2 + 1]
    (librosa.filters.mel)."""
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    return (weights * (2.0 / (mel_f[2:] - mel_f[:n_mels]))[:, None]).astype(np.float32)


def log_mel(audio: torch.Tensor, sample_rate: int, n_mels: int, hop: int, n_fft: int = 1024,
            f_max: float = 12000.0) -> torch.Tensor:
    """audio [B, L] -> log-mel [B, frames, n_mels], float32: reflect pad of
    (n_fft - hop) / 2, a periodic Hann window, |STFT| with 1e-9 under the
    root, the mel projection, log of max(x, 1e-5)."""
    n = np.arange(n_fft, dtype=np.float64)
    window = torch.from_numpy((0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))).astype(np.float32)).to(audio.device)
    basis = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels, 0.0, f_max)).to(audio.device)
    pad = (n_fft - hop) // 2
    x = F.pad(audio.float()[:, None, :], (pad, pad), mode="reflect")[:, 0]
    spec = torch.fft.rfft(x.unfold(-1, n_fft, hop) * window, dim=-1)
    mag = torch.sqrt(spec.real.square() + spec.imag.square() + 1e-9)
    return torch.log(torch.clamp(mag @ basis.T, min=1e-5))


# ---- building blocks ----------------------------------------------------------


def _conv(p: Params, name: str, x: torch.Tensor, dilation: int = 1, padding: int = 0) -> torch.Tensor:
    return F.conv1d(x, p[f"{name}.weight"], p[f"{name}.bias"], dilation=dilation, padding=padding)


def wavenet(p: Params, prefix: str, x: torch.Tensor, layers: int, condition=None) -> torch.Tensor:
    """WaveNet stack [B, Cin, T] -> [B, Cout, T]: SiLU input projection,
    gated dilated residual layers (dilation 2^(i mod 4)), residual scaled by
    1/sqrt(2), skip sum by 1/sqrt(layers), SiLU output projection."""
    if f"{prefix}.input_projection.conv.weight" in p:
        x = F.silu(_conv(p, f"{prefix}.input_projection.conv", x))
    skip_sum = 0.0
    for i in range(layers):
        lp, d = f"{prefix}.residual_layers.{i}", 2 ** (i % 4)
        y = _conv(p, f"{lp}.conv_layer.conv", x, dilation=d, padding=d)
        if condition is not None:
            y = y + _conv(p, f"{lp}.condition_projection.conv", condition)
        gate, filt = y.chunk(2, dim=1)
        residual, skip = _conv(p, f"{lp}.output_projection.conv", torch.sigmoid(gate) * torch.tanh(filt)).chunk(2, dim=1)
        x = (x + residual) / math.sqrt(2.0)
        skip_sum = skip_sum + skip
    y = _conv(p, f"{prefix}.skip_projection.conv", skip_sum / math.sqrt(layers))
    if f"{prefix}.output_projection.conv.weight" in p:
        y = _conv(p, f"{prefix}.output_projection.conv", F.silu(y))
    return y


def convnext(p: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """ConvNeXt-1D block: depthwise k7 -> LayerNorm(1e-6) -> 4x MLP, exact
    GELU -> layer scale -> residual."""
    c = x.shape[1]
    y = F.conv1d(x, p[f"{prefix}.dwconv.weight"], p[f"{prefix}.dwconv.bias"], padding=3, groups=c).transpose(1, 2)
    y = F.layer_norm(y, (c,), p[f"{prefix}.norm.weight"], p[f"{prefix}.norm.bias"], eps=1e-6)
    y = F.linear(F.gelu(F.linear(y, p[f"{prefix}.pwconv1.weight"], p[f"{prefix}.pwconv1.bias"])),
                 p[f"{prefix}.pwconv2.weight"], p[f"{prefix}.pwconv2.bias"])
    return x + (p[f"{prefix}.gamma"] * y).transpose(1, 2)


# ---- finite scalar quantization -------------------------------------------------


def _fsq_consts(levels, device):
    lv = torch.tensor(levels, dtype=torch.float32, device=device)
    basis = torch.tensor(np.concatenate(([1], np.cumprod(levels[:-1]))), dtype=torch.float32, device=device)
    return lv, basis, torch.floor(lv / 2)


def fsq_bound(z: torch.Tensor, levels) -> torch.Tensor:
    lv, _, _ = _fsq_consts(levels, z.device)
    half_l = (lv - 1) * (1 + 1e-3) / 2
    offset = torch.where(torch.remainder(lv, 2) == 0, 0.5, 0.0)
    return torch.tanh(z + torch.atanh(offset / half_l)) * half_l - offset


def fsq_indices(latents: torch.Tensor, p: Params, prefix: str, levels) -> torch.Tensor:
    """One group's residual FSQ with one quantizer: project to len(levels),
    bound, then bound, round half to even and read the mixed-radix index
    (truncated to int, as the library does). [B, L, d] -> [B, L]."""
    _, basis, half = _fsq_consts(levels, latents.device)
    x = F.linear(latents, p[f"{prefix}.project_in.weight"], p[f"{prefix}.project_in.bias"]).float()
    codes = torch.round(fsq_bound(fsq_bound(x, levels), levels)) / half
    return ((codes * half + half) * basis).sum(-1).to(torch.int32)


def fsq_decode(indices: torch.Tensor, p: Params, prefix: str, levels) -> torch.Tensor:
    """[B, L] indices -> [B, L, d] float32 (project_out in float32)."""
    lv, basis, half = _fsq_consts(levels, indices.device)
    codes = (torch.remainder(torch.floor(indices[..., None].float() / basis), lv) - half) / half
    return F.linear(codes, p[f"{prefix}.project_out.weight"].float(), p[f"{prefix}.project_out.bias"].float())


# ---- the codec ------------------------------------------------------------------


def frame_mask(lengths: torch.Tensor, t: int, dtype) -> torch.Tensor:
    return (torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]).to(dtype)[:, :, None]


def encode(p: Params, cfg: dict, mels: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """mels [B, T, M] + frame lengths -> FSQ indices [B, G, T / 4] (one
    quantizer per group)."""
    s, g = sizes(cfg), cfg["dmel_groups"]
    b, t, m = mels.shape
    band_masks = frame_mask(lengths, t, mels.dtype).transpose(1, 2).repeat_interleave(g, dim=0)
    bands = mels.transpose(1, 2).reshape(b * g, m // g, t) * band_masks
    z = wavenet(p, "encoder", bands, cfg["encoder_layers"]) * band_masks
    for i in range(len(cfg["downsample_factor"])):
        f = cfg["downsample_factor"][i]
        z = F.conv1d(z, p[f"quantizer.downsample.{i}.0.weight"], p[f"quantizer.downsample.{i}.0.bias"], stride=f)
        z = convnext(p, f"quantizer.downsample.{i}.1", z)
    latents = z.reshape(b, s["concat"], -1).transpose(1, 2)  # [B, L, G * res]
    res = cfg["encoder_residual_channels"]
    return torch.stack([
        fsq_indices(latents[..., k * res:(k + 1) * res], p, f"quantizer.residual_fsq.rvqs.{k}", tuple(cfg["levels"]))
        for k in range(g)
    ], dim=1)


def decode(p: Params, cfg: dict, indices: torch.Tensor, lengths: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """indices [B, G, L] + index lengths + noise [B, 4L, concat] -> mel
    [B, 4L, M], in the dtype of `noise` (the codec's activation dtype)."""
    s, g = sizes(cfg), cfg["dmel_groups"]
    res, dtype = cfg["encoder_residual_channels"], noise.dtype
    b, _, n = indices.shape
    z = torch.cat([fsq_decode(indices[:, k], p, f"quantizer.residual_fsq.rvqs.{k}", tuple(cfg["levels"]))
                   for k in range(g)], dim=-1).to(dtype)  # [B, L, concat]
    z = z.transpose(1, 2).reshape(b * g, res, n)
    for i, f in enumerate(reversed(cfg["downsample_factor"])):
        z = F.conv_transpose1d(z, p[f"quantizer.upsample.{i}.0.weight"], p[f"quantizer.upsample.{i}.0.bias"], stride=f)
        z = convnext(p, f"quantizer.upsample.{i}.1", z)
    z = z.reshape(b, s["concat"], -1).transpose(1, 2)  # [B, T, concat]
    masks = frame_mask(lengths * s["down"], z.shape[1], dtype)
    quality = F.linear(torch.full((b, 1), 2.0, dtype=dtype, device=z.device),
                       p["quality_projection.weight"], p["quality_projection.bias"])[:, None, :]
    z = z * masks + quality
    y = wavenet(p, "decoder", (noise * masks).transpose(1, 2), cfg["decoder_layers"], condition=z.transpose(1, 2))
    return y.transpose(1, 2) * masks
