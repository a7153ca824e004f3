"""ECAPA-TDNN speaker encoder (port of `dmel_codec_tpu/eval/ecapa.py`).

The original torch reference scores speaker similarity with speechbrain's
pretrained `spkrec-ecapa-voxceleb` ECAPA-TDNN. `ECAPA_TDNN` has
speechbrain's module names (lobes/models/ECAPA_TDNN.py), so an
`embedding_model.ckpt` loads into it with a strict `load_state_dict`
(`load_ecapa_checkpoint`) and no speechbrain import; they are the names
the JAX package's `ecapa_params_from_torch_state_dict` reads.

Architecture (voxceleb config): TDNN(80 -> 1024, k5) -> 3 SE-Res2Net
blocks (k3, dilations 2/3/4, res2net scale 8, SE bottleneck 128) -> MFA
concat -> TDNN(3072, k1) -> attentive statistics pooling (global context,
128 attention channels) -> BN -> 1x1 conv to the 192-dim embedding. Convs
are reflect-padded "same"; BatchNorm always normalises with its running
statistics (the module is an inference model).

Front end (`ecapa_fbank`): speechbrain Fbank defaults (16 kHz, 25 ms
periodic Hamming window / 10 ms hop, |X|^2, 80 HTK-mel triangular
filters, 10 log10 with amin 1e-10 and top_db 80), then per-utterance mean
subtraction. The top-db clamp takes the maximum over the whole batch, as
the JAX package does (`dmel_codec_tpu/eval/ecapa.py:92`): a clip's
features depend on the other clips of its batch. The harness embeds one
clip at a time, where the two are the same.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

# voxceleb flagship hyperparameters
CHANNELS = 1024
EMB_DIM = 192
SE_CHANNELS = 128
ATTN_CHANNELS = 128
RES2NET_SCALE = 8
KERNELS = (5, 3, 3, 3)
DILATIONS = (1, 2, 3, 4)
BN_EPS = 1e-5
STAT_EPS = 1e-12


# --------------------------------------------------------------------------
# fbank front end (16 kHz); the filterbank is a copy of the JAX package's
# --------------------------------------------------------------------------
def _htk_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _htk_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def _triangular_filterbank(n_mels: int, n_fft: int, sr: int, f_max: float):
    """HTK-mel triangular filters, no area norm (speechbrain Filterbank)."""
    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = _htk_hz(np.linspace(_htk_mel(0.0), _htk_mel(f_max), n_mels + 2))
    fb = np.zeros((n_fft // 2 + 1, n_mels), np.float32)
    for m in range(n_mels):
        lo, ctr, hi = mel_pts[m], mel_pts[m + 1], mel_pts[m + 2]
        up = (freqs - lo) / (ctr - lo)
        down = (hi - freqs) / (hi - ctr)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def ecapa_fbank(audio_16k: torch.Tensor) -> torch.Tensor:
    """[B, L] (or [L]) 16 kHz waveform -> [B, T, 80] mean-normalised log-fbanks,
    on the waveform's device."""
    n_fft, win, hop = 400, 400, 160
    x = torch.as_tensor(audio_16k, dtype=torch.float32)
    if x.dim() == 1:
        x = x[None]
    # center pad (constant), frame, hamming (periodic), rFFT power
    frames = F.pad(x, (n_fft // 2, n_fft // 2)).unfold(-1, win, hop)  # [B, T, win]
    window = torch.from_numpy(np.hamming(win + 1)[:-1].astype(np.float32)).to(x.device)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1).abs() ** 2
    fb = torch.from_numpy(_triangular_filterbank(80, n_fft, 16000, 8000.0)).to(x.device)
    db = 10.0 * torch.log10(torch.clamp(spec @ fb, min=1e-10))
    db = torch.maximum(db, db.max() - 80.0)  # top_db clamp over the whole batch
    return db - db.mean(dim=1, keepdim=True)  # sentence mean-norm


# --------------------------------------------------------------------------
# modules, with speechbrain's names
# --------------------------------------------------------------------------
class Conv1d(nn.Module):
    """speechbrain's Conv1d wrapper (`<name>.conv.weight`): reflect-padded
    "same" convolution."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(in_ch, out_ch, kernel_size, dilation=dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.conv.dilation[0] * (self.conv.kernel_size[0] - 1)
        if pad:
            x = F.pad(x, (pad // 2, pad - pad // 2), mode="reflect")
        return self.conv(x)


class BatchNorm1d(nn.Module):
    """speechbrain's BatchNorm1d wrapper (`<name>.norm.weight`), normalising
    with its running statistics whether or not the module is in training mode."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = nn.BatchNorm1d(channels, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.norm
        return F.batch_norm(x, n.running_mean, n.running_var, n.weight, n.bias, False, 0.0, n.eps)


class TDNNBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = Conv1d(in_ch, out_ch, kernel_size, dilation)
        self.norm = BatchNorm1d(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(F.relu(self.conv(x)))


class Res2NetBlock(nn.Module):
    def __init__(self, channels: int, scale: int, kernel_size: int, dilation: int):
        super().__init__()
        width = channels // scale
        self.scale = scale
        self.blocks = nn.ModuleList(TDNNBlock(width, width, kernel_size, dilation) for _ in range(scale - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chunks = torch.chunk(x, self.scale, dim=1)
        ys, y = [chunks[0]], None
        for i, block in enumerate(self.blocks, start=1):
            y = block(chunks[i] if i == 1 else chunks[i] + y)
            ys.append(y)
        return torch.cat(ys, dim=1)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x [B, C, T], mask [B, 1, T] -> [B, C]."""
    return (x * mask).sum(dim=2) / mask.sum(dim=2).clamp(min=1.0)


class SEBlock(nn.Module):
    def __init__(self, channels: int, se_channels: int):
        super().__init__()
        self.conv1 = Conv1d(channels, se_channels)
        self.conv2 = Conv1d(se_channels, channels)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        s = _masked_mean(x, mask)[:, :, None]
        s = torch.sigmoid(self.conv2(F.relu(self.conv1(s))))
        return x * s


class SERes2NetBlock(nn.Module):
    def __init__(self, channels: int, scale: int, se_channels: int, kernel_size: int, dilation: int):
        super().__init__()
        self.tdnn1 = TDNNBlock(channels, channels)
        self.res2net_block = Res2NetBlock(channels, scale, kernel_size, dilation)
        self.tdnn2 = TDNNBlock(channels, channels)
        self.se_block = SEBlock(channels, se_channels)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        y = self.tdnn2(self.res2net_block(self.tdnn1(x)))
        return self.se_block(y, mask) + x


class AttentiveStatisticsPooling(nn.Module):
    """Attention over time with global context; masked statistics."""

    def __init__(self, channels: int, attn_channels: int):
        super().__init__()
        self.tdnn = TDNNBlock(3 * channels, attn_channels)
        self.conv = Conv1d(attn_channels, channels)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [B, C, T], mask [B, 1, T] -> pooled [B, 2C] (mean ⊕ std)."""
        xm = x * mask
        mean = _masked_mean(xm, mask)
        var = _masked_mean((xm - mean[:, :, None]) ** 2, mask)
        std = torch.sqrt(var.clamp(min=STAT_EPS))
        ctx = torch.cat([x, mean[:, :, None].expand_as(x), std[:, :, None].expand_as(x)], dim=1)
        attn = self.conv(torch.tanh(self.tdnn(ctx)))
        attn = torch.softmax(attn.masked_fill(mask == 0, float("-inf")), dim=2)
        mu = (attn * x).sum(dim=2)
        sg = torch.sqrt(((attn * x * x).sum(dim=2) - mu * mu).clamp(min=STAT_EPS))
        return torch.cat([mu, sg], dim=1)


class ECAPA_TDNN(nn.Module):
    """[B, T, 80] fbanks (+ frame lengths) -> embeddings [B, emb_dim]."""

    def __init__(
        self,
        input_size: int = 80,
        channels: int = CHANNELS,
        emb_dim: int = EMB_DIM,
        res2net_scale: int = RES2NET_SCALE,
        se_channels: int = SE_CHANNELS,
        attn_channels: int = ATTN_CHANNELS,
    ):
        super().__init__()
        self.blocks = nn.ModuleList(
            [TDNNBlock(input_size, channels, KERNELS[0], DILATIONS[0])]
            + [SERes2NetBlock(channels, res2net_scale, se_channels, KERNELS[i], DILATIONS[i]) for i in (1, 2, 3)]
        )
        self.mfa = TDNNBlock(3 * channels, 3 * channels)
        self.asp = AttentiveStatisticsPooling(3 * channels, attn_channels)
        self.asp_bn = BatchNorm1d(6 * channels)
        self.fc = Conv1d(6 * channels, emb_dim)

    def forward(self, fbanks: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = fbanks.shape
        if lengths is None:
            lengths = torch.full((b,), t, device=fbanks.device)
        mask = (torch.arange(t, device=fbanks.device)[None, :] < lengths.to(fbanks.device)[:, None])
        mask = mask.to(fbanks.dtype)[:, None, :]  # [B, 1, T]
        x = self.blocks[0](fbanks.transpose(1, 2) * mask)
        outs = []
        for block in self.blocks[1:]:
            x = block(x, mask)
            outs.append(x)
        x = self.mfa(torch.cat(outs, dim=1))
        pooled = self.asp_bn(self.asp(x, mask)[:, :, None])
        return self.fc(pooled)[:, :, 0]


def ecapa_from_state_dict(sd: Mapping[str, torch.Tensor], device="cuda") -> ECAPA_TDNN:
    """An `ECAPA_TDNN` sized from a speechbrain-layout state dict (the
    res2net scale from the branch count, as the JAX converter infers it)
    and filled from it with a strict load."""
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    scale = 1 + sum(
        1 for k in sd if k.startswith("blocks.1.res2net_block.blocks.") and k.endswith(".conv.conv.weight")
    )
    channels, input_size, _ = sd["blocks.0.conv.conv.weight"].shape
    model = ECAPA_TDNN(
        input_size=input_size,
        channels=channels,
        emb_dim=sd["fc.conv.weight"].shape[0],
        res2net_scale=scale,
        se_channels=sd["blocks.1.se_block.conv1.conv.weight"].shape[0],
        attn_channels=sd["asp.tdnn.conv.conv.weight"].shape[0],
    )
    model.load_state_dict(sd)
    return model.to(device).eval()


def load_ecapa_checkpoint(path: str, device="cuda") -> ECAPA_TDNN:
    """A speechbrain `embedding_model.ckpt` (a state dict, or a module that has
    one) -> `ECAPA_TDNN` on `device`."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return ecapa_from_state_dict(sd, device)


@torch.no_grad()
def embed(model: ECAPA_TDNN, fbanks: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T, 80] fbanks (+ frame lengths) -> L2-unnormalised [B, emb]."""
    return model(fbanks, lengths)


def embed_audio(model: ECAPA_TDNN, audio_16k: np.ndarray) -> np.ndarray:
    """Waveform [L] or [B, L] @16 kHz -> embeddings [B, emb], on the model's device."""
    device = next(model.parameters()).device
    audio = torch.from_numpy(np.ascontiguousarray(audio_16k, dtype=np.float32)).to(device)
    return embed(model, ecapa_fbank(audio)).cpu().numpy()


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
