"""NVIDIA Nemotron-H's block (HF `NemotronHBlock` of
nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B, `model_type` "nemotron_h"): one
mixer a block, chosen by the layer's letter in
`TransformerConfig.layer_pattern` (HF `hybrid_override_pattern`): "M" a
Mamba-2 layer, "E" a mixture of squared-ReLU experts
(`models/deepseek_v3.py` `MoE`, with its expert share), "*" grouped-query
attention without positions. No counterpart in the JAX package;
`TransformerConfig(kind="nemotron_h")` builds it.

Block: x = x + mixer(RMSNorm(x)), eps rms_norm_eps (HF `layer_norm_epsilon`);
the residual in the model's dtype (`residual_in_fp32` false); the decoder's
final norm after the last block.

Mamba-2 mixer (M; HF `NemotronHMamba2Mixer`, "Transformers are SSMs",
arXiv:2405.21060), heads h of P = mamba_head_dim, state N = ssm_state_size,
G = mamba_n_groups groups of B / C, head h reading group h // (heads / G):
  [z | xBC | dt] = in_proj(x) (no bias), widths heads P, heads P + 2 G N, heads;
  xBC = SiLU(causal depthwise conv of mamba_conv_kernel taps + conv bias),
      split into x [heads, P], B [G, N], C [G, N];
  dt = softplus(dt + dt_bias), unclamped (HF's default time_step_limit (0, inf));
  A = -exp(A_log), one a head;
  h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T   ([heads, P, N], float32);
  y_t = h_t C_t + D x_t;
  out = out_proj(RMSNorm_grouped(y * SiLU(z))): the norm over groups of
      heads P / G channels, times its weight, eps rms_norm_eps.
Two forms of the same recurrence, chosen by shape when the call is made:
  * chunked (a call over several positions: the prefill, a teacher-forced
    forward), `ssd`: the state-space duality form over chunks of CHUNK
    positions, each chunk's pairs taken as one masked product and the
    states carried from chunk to chunk as one product over the chunks'
    decays; the B / C groups in passes of at most GROUP_BYTES of float32
    decay matrices. Every exponential it takes is of a non-positive sum
    of dt A, each summed from its own start (`segsum`);
  * recurrent (a one-position step over the cache: the decode): the state
    and the convolution's inputs stepped in place, with no host read, so
    a captured graph takes it.
A Mamba layer's cache is its state [B, heads, P, N] (float32) and the last
taps - 1 inputs of its convolution [B, taps - 1, heads P + 2 G N] ("state",
"conv"; `transformer.init_kv_cache`).

Attention (*; HF `NemotronHAttention`): q, k, v, o projections without
bias, num_heads query heads over num_kv_heads key / value heads of
`TransformerConfig.head_dim` (the configuration's attention_head_dim, not
hidden / heads), softmax scale head_dim^-1/2, causal, and no positional
rotation: the layer takes no positions (HF's and vLLM's take none; the
config's rope_theta and partial_rotary_factor are read by no layer). The
cache holds each position's k and v ("k", "v"). A call over several
positions from an empty cache or without one (causal over positions
0..S-1: the prefill) runs FA (`ops/flash_attention.flash_attention`) where
`fa_takes` holds (bf16 on the card, no gradient); any other call (the CPU,
float32, a chunk over a filled cache, the decode) the plain core `attend`,
at most SCORE_ELEMENTS scores at a time.

Experts (E): `deepseek_v3.MoE` with `TransformerConfig.mlp_hidden_act`
"relu2": each expert and the shared expert down(relu(up(x))^2), the
shared one of `shared_expert_intermediate_size`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dmel_codec_tpu_torch.models.deepseek_v3 import MoE
from dmel_codec_tpu_torch.models.kimi_linear import causal_conv
from dmel_codec_tpu_torch.models.transformer import RMSNorm, TransformerConfig
from dmel_codec_tpu_torch.ops.flash_attention import flash_attention
from dmel_codec_tpu_torch.utils.trace import span

CHUNK = 128  # the config's chunk_size
# A pass's float32 decay matrices (rows x chunks x heads x CHUNK x CHUNK) at most this in a chunked call
GROUP_BYTES = 1 << 30
# Largest score block of the plain attention core ([B, heads, queries, keys] in float32: 1 GiB)
SCORE_ELEMENTS = 1 << 28


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., T] -> [..., T, T]: out[i, j] = x[j + 1] + .. + x[i] for j <=
    i (0 on the diagonal), -inf above it. Each entry is a sum of its own
    terms from its own start, not a difference of two running sums, so a
    short span deep into a long one keeps its precision."""
    t = x.shape[-1]
    below = torch.ones(t, t, dtype=torch.bool, device=x.device).tril(-1)
    out = torch.where(below, x[..., :, None], 0.0).cumsum_(-2)
    return out.masked_fill_(torch.ones_like(below).triu(1), -math.inf)


def ssd(x, a, b, c, state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 recurrence h_t = exp(a_t) h_{t-1} + x_t b_t^T, y_t = h_t
    c_t over sequences, in chunks of CHUNK (the state-space duality form):
    x [R, S, G, H, P] (the inputs times dt), a [R, S, G, H] (dt A, <= 0), b,
    c [R, S, G, N] (each shared by its group's H heads), float32; state [R,
    G, H, P, N] before the first position (None: zeros) -> (y [R, S, G, H,
    P], the state after the last). The tail is padded to a whole chunk with
    a = 0 and zero inputs (the state passes through it unchanged). Per
    chunk, with L[i, j] = exp(a_{j+1} + .. + a_i) for j <= i:
      y = (L * C B^T) X + exp(a_1 + .. + a_i) C_i h_in,
      h_out = exp(a_1 + .. + a_end) h_in + sum_j L[end, j] x_j b_j^T;
    h_in of every chunk at once: the chunks' own contributions weighted by
    exp of the sums of the chunk totals between them."""
    r, s = x.shape[:2]
    nc = -(-s // CHUNK)

    def chunked(t):  # [R, S, ...] -> [R, nc, CHUNK, ...], the tail zeroed
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, nc * CHUNK - s))
        return t.view(r, nc, CHUNK, *t.shape[2:])

    xc = chunked(x).permute(0, 1, 3, 4, 2, 5).contiguous()  # [R, nc, G, H, l, P]
    ac = chunked(a).permute(0, 1, 3, 4, 2)  # [R, nc, G, H, l]
    bc = chunked(b).transpose(2, 3)  # [R, nc, G, l, N]
    cc = chunked(c).transpose(2, 3)
    cum = ac.cumsum(-1)
    decay = segsum(ac).exp_()  # L: [R, nc, G, H, l, l]
    to_end = decay[..., -1, :].clone()  # L[end, j]
    y = torch.matmul(decay.mul_(torch.matmul(cc, bc.transpose(-1, -2))[:, :, :, None]), xc)
    del decay
    own = torch.matmul((xc * to_end[..., None]).transpose(-1, -2), bc[:, :, :, None])  # [R, nc, G, H, P, N]
    g, h, p, n = own.shape[2:]
    totals = F.pad(cum[..., -1].permute(0, 2, 3, 1), (1, 0))  # [R, G, H, nc + 1]
    start = own.new_zeros(r, 1, g, h, p, n) if state is None else state[:, None].to(own.dtype)
    states = torch.cat([start, own], 1).permute(0, 2, 3, 1, 4, 5).reshape(r, g, h, nc + 1, p * n)
    states = torch.matmul(segsum(totals).exp_(), states)  # the state entering chunk z, z = 0 .. nc
    last = states[:, :, :, -1].reshape(r, g, h, p, n)
    entering = states[:, :, :, :-1].view(r, g, h, nc, p, n).permute(0, 3, 1, 2, 5, 4)  # [R, nc, G, H, N, P]
    y.add_(torch.matmul(cc[:, :, :, None], entering).mul_(cum.exp_()[..., None]))
    return y.permute(0, 1, 4, 2, 3, 5).reshape(r, nc * CHUNK, g, h, p)[:, :s], last


def pass_groups(rows: int, positions: int, groups: int, heads_per_group: int) -> int:
    """B / C groups a pass of a chunked call takes: the most, dividing
    `groups`, whose float32 decay matrices fit GROUP_BYTES; at least one."""
    per_group = rows * -(-positions // CHUNK) * heads_per_group * CHUNK * CHUNK * 4
    return max([g for g in range(1, groups + 1) if groups % g == 0 and g * per_group <= GROUP_BYTES] or [1])


class Mamba2Mixer(nn.Module):
    # rows x positions the chunked form has processed, every layer's call counted (tail padding
    # left out); `SlowFastGenerator` zeroes it and reports it
    scanned = {"positions": 0}

    def __init__(self, config: TransformerConfig):
        super().__init__()
        cfg = self.config = config
        h, nh, p = cfg.hidden_size, cfg.mamba_num_heads, cfg.mamba_head_dim
        g, n, taps = cfg.mamba_n_groups, cfg.ssm_state_size, cfg.mamba_conv_kernel
        self.inner = nh * p
        self.conv_dim = self.inner + 2 * g * n
        self.in_proj = nn.Linear(h, self.inner + self.conv_dim + nh, bias=False)
        self.conv1d = nn.Conv1d(self.conv_dim, self.conv_dim, taps, groups=self.conv_dim, bias=True)
        self.dt_bias = nn.Parameter(torch.empty(nh))
        self.A_log = nn.Parameter(torch.empty(nh))
        self.D = nn.Parameter(torch.empty(nh))
        self.norm = RMSNorm(self.inner, cfg.rms_norm_eps)  # applied by groups, gated (`_gated_norm`)
        self.out_proj = nn.Linear(self.inner, h, bias=False)

    @torch.no_grad()
    def reset_ssm(self, generator: Optional[torch.Generator] = None) -> None:
        """HF's draw (`NemotronHPreTrainedModel._init_weights`): A_log = log
        U(1, 16); dt_bias the inverse softplus of dt = exp U(log 1e-3, log
        1e-1), at least 1e-4 (time_step_min / max / floor); D = 1."""
        self.A_log.copy_(torch.empty_like(self.A_log).uniform_(1.0, 16.0, generator=generator).log())
        dt = torch.empty_like(self.dt_bias).uniform_(math.log(1e-3), math.log(1e-1), generator=generator).exp()
        dt = dt.clamp(min=1e-4)
        self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        self.D.fill_(1.0)

    def _split(self, zxbcdt: torch.Tensor) -> tuple:
        return zxbcdt.split([self.inner, self.conv_dim, self.config.mamba_num_heads], dim=-1)

    def _dt(self, dt: torch.Tensor, heads: slice) -> torch.Tensor:
        """(dt, dt A): dt [..., heads in `heads`] -> float32 [..., heads] each."""
        dt = F.softplus(dt.float() + self.dt_bias[heads].float())
        return dt, dt * -torch.exp(self.A_log[heads].float())

    def _gated_norm(self, y: torch.Tensor, z: torch.Tensor, channels: slice) -> torch.Tensor:
        """RMSNorm_grouped(y * SiLU(z)) of the channels `channels` (whole
        groups): y float32 [..., c], z [..., c] -> float32 [..., c]."""
        cfg = self.config
        y = y * F.silu(z.float())
        y = y.unflatten(-1, (-1, self.inner // cfg.mamba_n_groups))
        y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + self.norm.eps)
        return y.flatten(-2) * self.norm.weight[channels].float()

    def forward(self, x: torch.Tensor, cache: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """x [B, S, H] -> [B, S, H]. `cache`: this layer's (state [B, heads,
        P, N] float32, conv [B, taps - 1, conv channels]); a call over
        several positions starts from them and leaves its last state and
        inputs there, a one-position call steps them in place."""
        with span("lm.mamba"):
            if cache is not None and x.shape[1] == 1:
                return self._step(x, *cache)
            return self._chunked(x, cache)

    def _chunked(self, x: torch.Tensor, cache: Optional[Sequence[torch.Tensor]]) -> torch.Tensor:
        """B / C groups in passes (`pass_groups`): each pass's convolution
        channels, its heads' dt and its heads' SSD, D skip and gated norm."""
        cfg = self.config
        b, s, _ = x.shape
        Mamba2Mixer.scanned["positions"] += b * s
        state, conv = cache if cache is not None else (None, None)
        nh, p, g, n = cfg.mamba_num_heads, cfg.mamba_head_dim, cfg.mamba_n_groups, cfg.ssm_state_size
        hpg = nh // g
        z, xbc, dt = self._split(self.in_proj(x))
        out = x.new_empty(b, s, self.inner)
        ng = pass_groups(b, s, g, hpg)
        for g0 in range(0, g, ng):
            heads = slice(g0 * hpg, (g0 + ng) * hpg)
            ch = slice(heads.start * p, heads.stop * p)
            parts = (ch, slice(self.inner + g0 * n, self.inner + (g0 + ng) * n),
                     slice(self.inner + (g + g0) * n, self.inner + (g + g0 + ng) * n))
            prev = None if conv is None else torch.cat([conv[..., c] for c in parts], -1)
            u, tail = causal_conv(torch.cat([xbc[..., c] for c in parts], -1),
                                  torch.cat([self.conv1d.weight[c, 0] for c in parts]), prev,
                                  torch.cat([self.conv1d.bias[c] for c in parts]))
            if conv is not None:
                for c, t in zip(parts, tail.split([c.stop - c.start for c in parts], -1)):
                    conv[..., c].copy_(t)
            xs, bs, cs = u.split([ch.stop - ch.start, ng * n, ng * n], -1)
            dts, da = self._dt(dt[..., heads], heads)
            xs = xs.view(b, s, ng, hpg, p)
            first = None if state is None else state[:, heads].view(b, ng, hpg, p, n)
            with span("lm.mamba.scan"):
                y, last = ssd(xs * dts.view(b, s, ng, hpg, 1), da.view(b, s, ng, hpg), bs.view(b, s, ng, n),
                              cs.view(b, s, ng, n), first)
            if state is not None:
                state[:, heads].copy_(last.view(b, ng * hpg, p, n))
            y = y.add_(xs * self.D[heads].float().view(ng, hpg, 1)).flatten(2)
            out[..., ch].copy_(self._gated_norm(y, z[..., ch], ch))
        return self.out_proj(out)

    def _step(self, x: torch.Tensor, state: torch.Tensor, conv: torch.Tensor) -> torch.Tensor:
        """One position over the cache, in place: x [B, 1, H]."""
        cfg = self.config
        b = x.shape[0]
        nh, p, g, n = cfg.mamba_num_heads, cfg.mamba_head_dim, cfg.mamba_n_groups, cfg.ssm_state_size
        z, xbc, dt = self._split(self.in_proj(x[:, 0]))
        window = torch.cat([conv, xbc[:, None].to(conv.dtype)], dim=1)
        u = (window.float() * self.conv1d.weight[:, 0].t().float()).sum(1).add_(self.conv1d.bias.float())
        conv.copy_(window[:, 1:])
        xs, bs, cs = F.silu(u, inplace=True).split([self.inner, g * n, g * n], -1)
        dt, da = self._dt(dt, slice(0, nh))
        xs = xs.view(b, nh, p)
        by_head = (b * nh, 1, n)
        bs = bs.view(b, g, 1, n).expand(b, g, nh // g, n).reshape(by_head)
        cs = cs.view(b, g, 1, n).expand(b, g, nh // g, n).reshape(by_head)
        state.mul_(torch.exp(da)[..., None, None])
        state.view(b * nh, p, n).baddbmm_((xs * dt[..., None]).view(b * nh, p, 1), bs)
        y = torch.bmm(state.view(b * nh, p, n), cs.transpose(1, 2)).view(b, nh, p)
        y = y.add_(xs * self.D.float()[:, None]).flatten(1)
        return self.out_proj(self._gated_norm(y, z, slice(0, self.inner)).to(x.dtype))[:, None]


def causal_from_zero(positions: torch.Tensor) -> bool:
    """Whether every row's query positions [B, S] are 0 .. S-1: the causal
    mask FA computes (one host read)."""
    return bool((positions == torch.arange(positions.shape[1], device=positions.device)).all())


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, scale: float) -> torch.Tensor:
    """The plain attention core: q [B, S, heads, d], k, v [B, T, kv heads,
    d], mask [B, S, T] bool -> [B, S, heads, d] in the promotion of the
    queries' and values' dtypes; query heads grouped over their key / value
    head (never repeated), a float32 softmax, queries in chunks of at most
    SCORE_ELEMENTS scores."""
    b, s, nh, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    dtype = torch.promote_types(q.dtype, k.dtype)
    qg, keys = q.reshape(b, s, kv, nh // kv, d).to(dtype), k.to(dtype)
    step = max(1, SCORE_ELEMENTS // (b * nh * t))
    out = []
    for i in range(0, s, step):
        scores = torch.einsum("bskgd,btkd->bkgst", qg[:, i:i + step], keys).float() * scale
        scores = torch.where(mask[:, None, None, i:i + step], scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(torch.promote_types(dtype, v.dtype))
        out.append(torch.einsum("bkgst,btkd->bskgd", probs, v.to(probs.dtype)))
    return (out[0] if len(out) == 1 else torch.cat(out, dim=1)).reshape(b, s, nh, d)


class NoPEAttention(nn.Module):
    # calls over several positions of every instance, by core: "flash" (FA) or "plain";
    # `SlowFastGenerator` zeroes them and reports the FA share
    calls = {"flash": 0, "plain": 0}

    def __init__(self, config: TransformerConfig):
        super().__init__()
        cfg = self.config = config
        h, d = cfg.hidden_size, cfg.head_dim
        self.q_proj = nn.Linear(h, cfg.num_heads * d, bias=False)
        self.k_proj = nn.Linear(h, cfg.num_kv_heads * d, bias=False)
        self.v_proj = nn.Linear(h, cfg.num_kv_heads * d, bias=False)
        self.o_proj = nn.Linear(cfg.num_heads * d, h, bias=False)
        self.scale = 1.0 / math.sqrt(d)

    def fa_takes(self, q: torch.Tensor, k: torch.Tensor, mask_pos: Optional[torch.Tensor]) -> bool:
        """Whether the core may run as FA: bf16 queries and keys off the
        CPU, no gradient taken, heads FA takes (a multiple of 16 up to 128),
        and the decoder's own causal mask over positions 0 .. S-1 (the
        prefill from an empty cache, or no cache)."""
        d = q.shape[-1]
        return (not torch.is_grad_enabled() and q.device.type != "cpu" and q.dtype == k.dtype == torch.bfloat16
                and d % 16 == 0 and d <= 128 and mask_pos is not None and causal_from_zero(mask_pos))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], cache: Optional[Sequence[torch.Tensor]] = None,
                cache_rows: Optional[torch.Tensor] = None, mask_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, S, H]; mask [B, S, T] bool. With `cache` (k, v [B, max_len,
        kv heads, d]) the new keys and values are written in place at
        `cache_rows` and T = max_len. `mask_pos` [B, S]: where the mask is
        the decoder's own causal one, key t <= mask_pos[b, s]; None for a
        caller's mask."""
        with span("lm.attn"):
            cfg = self.config
            b, s, _ = x.shape
            q = self.q_proj(x).view(b, s, cfg.num_heads, -1)
            k = self.k_proj(x).view(b, s, cfg.num_kv_heads, -1)
            v = self.v_proj(x).view(b, s, cfg.num_kv_heads, -1)
            keys, values = k, v
            if cache is not None:
                ck, cv = cache
                ck.index_copy_(1, cache_rows, k.to(ck.dtype))
                cv.index_copy_(1, cache_rows, v.to(cv.dtype))
                keys, values = ck, cv
            flash = False
            if s > 1:
                flash = self.fa_takes(q, k, mask_pos)
                NoPEAttention.calls["flash" if flash else "plain"] += 1
            with span("lm.attn.attend"):
                out = flash_attention(q, k, v) if flash else attend(q, keys, values, mask, self.scale)
            return self.o_proj(out.reshape(b, s, -1).to(x.dtype))


class Block(nn.Module):
    """Pre-norm block around one mixer: Mamba-2 (M), experts (E) or NoPE
    attention (*), by the layer's letter of `layer_pattern`."""

    def __init__(self, config: TransformerConfig, layer: int):
        super().__init__()
        kind = config.layer_pattern[layer]
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        self.mixer = {"M": Mamba2Mixer, "E": MoE, "*": NoPEAttention}[kind](config)

    def forward(self, x, cos, sin, mask, cache: Optional[Sequence[torch.Tensor]] = None, cache_rows=None,
                mask_pos: Optional[torch.Tensor] = None):
        """`deepseek_v3.Block`'s call; `cache` is the layer's slots of the
        cache: ("state", "conv") of a Mamba layer, ("k", "v") of an
        attention layer, none of an expert layer. cos / sin are not read."""
        h = self.norm(x)
        if isinstance(self.mixer, Mamba2Mixer):
            return x + self.mixer(h, cache)
        if isinstance(self.mixer, NoPEAttention):
            return x + self.mixer(h, mask, cache, cache_rows, mask_pos)
        return x + self.mixer(h, cache_rows)
