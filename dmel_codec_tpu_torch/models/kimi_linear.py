"""Kimi Linear's block (HF `KimiDecoderLayer` of moonshotai/Kimi-Linear-48B-A3B;
"Kimi Linear: An Expressive, Efficient Attention Architecture",
arXiv:2510.26692): in the layers `TransformerConfig.kda_layers` (counted
from 0) Kimi Delta Attention (KDA), in the others the DeepSeek-V3 block's
latent attention without rotation (the config's `mla_use_nope`); then a dense SwiGLU in
the first `first_k_dense_replace` layers and the mixture of experts after,
with its expert share (`models/deepseek_v3.py`). No counterpart in the JAX
package; `TransformerConfig(kind="kimi_linear")` builds it.

KDA (fla's `naive_recurrent_kda`, the paper's section 3). Per head h
(kda_num_heads heads of d = kda_head_dim), position t and x_t the block's
normed input, every projection bias-free:
  q~, k~, v~ = SiLU(conv(W_q x)), SiLU(conv(W_k x)), SiLU(conv(W_v x)), each
      conv causal and depthwise over time, kda_conv_size taps a channel;
  q = q~ * rsqrt(sum q~^2 + 1e-6), k likewise, per head (fla's l2norm);
  a_t = -exp(A_log[h]) * softplus(W_fb W_fa x + dt_bias), one gate a channel, <= 0;
  beta_t = sigmoid(W_b x)[h];
  S_t = diag(exp(a_t)) S_{t-1}, then S_t += beta_t k_t (v_t - S_t^T k_t)^T
      (S is d x d, key by value, float32);
  o_t = d^-1/2 S_t^T q_t;
  y = W_o [RMSNorm(o_t) * o_norm.weight * sigmoid(W_gb W_ga x)], per head.
Two forms of the same recurrence, chosen by shape when the call is made:
  * chunked (a call over several positions: the prefill, a teacher-forced
    forward), `scan_chunks`: the WY form in chunks of CHUNK positions, each
    chunk's pairs taken in parallel and the state carried from chunk to
    chunk; heads in groups of at most GROUP_BYTES of float32 queries, whose
    operands are written once into chunk-major buffers. Every exponential it
    takes is of a non-positive sum of gates, so no gate overflows it. Where
    `k6_takes` holds (bf16 on the card, no gradient, heads of 128, 4 taps)
    the core from the projections' outputs to o runs as kernel K6 instead
    (`ops/kda_scan.py`: one launch a call over all heads);
  * recurrent (a one-position step over the cache: the decode): the state
    and the convolutions' inputs stepped in place, with no host read, so a
    captured graph takes it.
A KDA layer's cache is its state [B, heads, d, d] (float32) and the last
kda_conv_size - 1 inputs of its three convolutions ("state", "conv";
`transformer.init_kv_cache`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dmel_codec_tpu_torch.models.deepseek_v3 import LatentAttention, MoE
from dmel_codec_tpu_torch.models.transformer import MLP, RMSNorm, TransformerConfig
from dmel_codec_tpu_torch.ops import kda_scan as k6
from dmel_codec_tpu_torch.utils.trace import span

CHUNK = 64
# A head group's float32 queries (rows x positions x heads x d) at most this in a chunked call
GROUP_BYTES = 1 << 30
L2NORM_EPS = 1e-6  # fla's l2norm: x * rsqrt(sum x^2 + eps)


def l2norm_(x: torch.Tensor) -> torch.Tensor:
    """x * rsqrt(sum x^2 + L2NORM_EPS) over the last dim, in place."""
    return x.mul_(torch.linalg.vector_norm(x, dim=-1, keepdim=True).square_().add_(L2NORM_EPS).rsqrt_())


def head_group(rows: int, positions: int, heads: int, d: int) -> int:
    """Heads a group of a chunked call takes: the most, dividing `heads`,
    whose float32 queries fit GROUP_BYTES; at least one."""
    per_head = rows * positions * d * 4
    return max([g for g in range(1, heads + 1) if heads % g == 0 and g * per_head <= GROUP_BYTES] or [1])


def causal_conv(u: torch.Tensor, weight: torch.Tensor, prev: Optional[torch.Tensor],
                bias: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """SiLU of the causal depthwise convolution. u [B, S, c]; weight [c,
    taps] (tap taps - 1 on the current input); prev [B, taps - 1, c], the
    inputs before u (None: zeros); bias [c] or None -> (float32 [B, S, c],
    the last taps - 1 inputs [B, taps - 1, c]). The convolution runs as a
    2-D one over [B, c, 1, S + taps - 1] in channels-last memory, the
    layout the inputs already have, so nothing is transposed."""
    b, s, c = u.shape
    taps = weight.shape[1]
    if prev is None:
        prev = u.new_zeros(b, taps - 1, c)
    full = torch.cat([prev.to(u.dtype), u], dim=1)
    y = F.conv2d(full[:, None].permute(0, 3, 1, 2), weight[:, None, None, :].to(u.dtype),
                 None if bias is None else bias.to(u.dtype), groups=c)
    return F.silu(y.permute(0, 2, 3, 1)[:, 0].float(), inplace=True), full[:, s:]


def _pairs(G: torch.Tensor, q: torch.Tensor, k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Within each chunk, G the gates' running sums [N, C, d]: A[r, i] =
    sum_c k_r k_i exp(G_r - G_i) for i < r, and Aq[r, i] the same with q_r
    for i <= r, 0 elsewhere ([N, C, C] each). A pair is taken at the level
    of halving where r and i first fall in different halves, against the
    running sum at the end of i's half: both factors, exp(G_r - ref) and
    exp(ref - G_i), have non-positive exponents."""
    n, c, d = k.shape
    a = k.new_zeros(n, c, c)
    aq = k.new_zeros(n, c, c)
    b = c // 2
    while b >= 1:
        m = c // (2 * b)
        gv, kv, qv = (t.view(n, m, 2, b, d) for t in (G, k, q))
        ref = gv[:, :, 0, -1:]
        fk = torch.exp(ref - gv[:, :, 0]).mul_(kv[:, :, 0]).transpose(-1, -2)
        fq = torch.exp(gv[:, :, 1] - ref)
        blocks = (torch.matmul(kv[:, :, 1] * fq, fk), torch.matmul(fq.mul_(qv[:, :, 1]), fk))
        for out, part in zip((a, aq), blocks):
            # the block of rows (2j + 1) b .. (2j + 2) b - 1 and columns 2j b .. (2j + 1) b - 1, every j
            torch.diagonal(out.view(n, m, 2 * b, m, 2 * b), dim1=1, dim2=3)[:, b:, :b].copy_(part.permute(0, 2, 3, 1))
        b //= 2
    aq.diagonal(dim1=1, dim2=2).copy_((q * k).sum(-1))
    return a, aq


def tril_inverse(t: torch.Tensor) -> torch.Tensor:
    """The inverse of unit lower triangular matrices t [N, C, C] (C a power
    of two), by blocks of doubling size: inv [[L11, 0], [L21, L22]] =
    [[L11^-1, 0], [-L22^-1 L21 L11^-1, L22^-1]]."""
    n, c, _ = t.shape
    inv = torch.zeros_like(t)
    inv.diagonal(dim1=1, dim2=2).fill_(1.0)
    b = 1
    while b < c:
        m = c // (2 * b)
        tb = torch.diagonal(t.view(n, m, 2 * b, m, 2 * b), dim1=1, dim2=3).permute(0, 3, 1, 2)
        ib = torch.diagonal(inv.view(n, m, 2 * b, m, 2 * b), dim1=1, dim2=3).permute(0, 3, 1, 2)
        ib[..., b:, :b].copy_(-torch.matmul(ib[..., b:, b:], torch.matmul(tb[..., b:, :b], ib[..., :b, :b])))
        b *= 2
    return inv


def scan_chunks(q, k, v, g, beta, state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The KDA recurrence over chunk-major operands (the WY form): q
    (scaled), k, g [nc, N, CHUNK, d], v [nc, N, CHUNK, dv], beta [nc, N,
    CHUNK], float32, positions past the sequence's end with beta 0, gates 0
    and zero keys and values (they leave the state as it was); state [N, d,
    dv], the state before the first position (None: zeros) -> (o [nc, N,
    CHUNK, dv], the state after the last). Per chunk, G the gates' running
    sums from the chunk's start and S0 its first state: u = (I + diag(beta)
    A)^-1 diag(beta) (V - (e^G * K) S0) with A of `_pairs`; o = (e^G * Q) S0
    + Aq u; the next state e^G_end * S0 + (e^(G_end - G) * K)^T u."""
    nc, n0, c, d = k.shape
    dv = v.shape[-1]
    n = nc * n0
    G = g.reshape(n, c, d).cumsum(1)
    qc, kc, vc = q.reshape(n, c, d), k.reshape(n, c, d), v.reshape(n, c, dv)
    a, aq = _pairs(G, qc, kc)
    bc = beta.reshape(n, c, 1)
    a.mul_(bc).diagonal(dim1=1, dim2=2).fill_(1.0)
    tinv = tril_inverse(a)
    del a
    qg = torch.exp(G)  # e^G, then e^G * Q
    rhs = k.new_empty(n, c, d + dv)
    torch.mul(kc, qg, out=rhs[..., :d]).mul_(bc)
    torch.mul(vc, bc, out=rhs[..., d:])
    sol = torch.bmm(tinv, rhs).view(nc, n0, c, d + dv)
    del tinv, rhs
    w, u_in = sol[..., :d], sol[..., d:]
    qg.mul_(qc)
    end = G[:, -1:].clone()
    kd = G.sub_(end).neg_().exp_().mul_(kc).view(nc, n0, c, d)  # e^(G_end - G) * K
    decay = torch.exp(end).view(nc, n0, d, 1)
    states = k.new_empty(nc + 1, n0, d, dv)
    if state is None:
        states[0].zero_()
    else:
        states[0].copy_(state)
    u = k.new_empty(nc, n0, c, dv)
    for j in range(nc):
        torch.baddbmm(u_in[j], w[j], states[j], alpha=-1.0, out=u[j])
        torch.baddbmm(states[j] * decay[j], kd[j].transpose(1, 2), u[j], out=states[j + 1])
    o = torch.bmm(qg, states[:nc].view(n, d, dv)).view(nc, n0, c, dv)
    o.view(n, c, dv).baddbmm_(aq, u.view(n, c, dv))
    return o, states[nc]


def chunk_kda(q, k, v, g, beta, state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """`scan_chunks` over sequences: q (scaled), k, g [N, S, d], v [N, S,
    dv], beta [N, S], float32; state [N, d, dv] or None -> (o [N, S, dv],
    the state after the last position). The tail is padded to a whole
    chunk with beta 0, gates 0 and zero keys and values."""
    n0, s = k.shape[:2]
    nc = -(-s // CHUNK)

    def chunked(t):
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, nc * CHUNK - s))
        return t.view(n0, nc, CHUNK, *t.shape[2:]).transpose(0, 1).contiguous()

    o, last = scan_chunks(*(chunked(t) for t in (q, k, v, g, beta)), state)
    return o.transpose(0, 1).reshape(n0, nc * CHUNK, -1)[:, :s], last


class KimiDeltaAttention(nn.Module):
    # rows x positions the chunked form has processed, every layer's call counted (tail padding
    # left out); `SlowFastGenerator` zeroes it and reports it
    scanned = {"positions": 0}
    # chunked calls of every instance, by core: "fused" (K6) or "plain"; `SlowFastGenerator`
    # zeroes them and reports the fused share
    calls = {"fused": 0, "plain": 0}

    def __init__(self, config: TransformerConfig):
        super().__init__()
        cfg = self.config = config
        h, nh, d, taps = cfg.hidden_size, cfg.kda_num_heads, cfg.kda_head_dim, cfg.kda_conv_size
        width = nh * d
        self.q_proj = nn.Linear(h, width, bias=False)
        self.k_proj = nn.Linear(h, width, bias=False)
        self.v_proj = nn.Linear(h, width, bias=False)
        self.q_conv1d = nn.Conv1d(width, width, taps, groups=width, bias=False)
        self.k_conv1d = nn.Conv1d(width, width, taps, groups=width, bias=False)
        self.v_conv1d = nn.Conv1d(width, width, taps, groups=width, bias=False)
        self.f_a_proj = nn.Linear(h, d, bias=False)
        self.f_b_proj = nn.Linear(d, width, bias=False)
        self.A_log = nn.Parameter(torch.empty(nh))
        self.dt_bias = nn.Parameter(torch.empty(width))
        self.b_proj = nn.Linear(h, nh, bias=False)
        self.g_a_proj = nn.Linear(h, d, bias=False)
        self.g_b_proj = nn.Linear(d, width, bias=False)
        self.o_norm = RMSNorm(d, cfg.rms_norm_eps)
        self.o_proj = nn.Linear(width, h, bias=False)
        self.scale = 1.0 / math.sqrt(d)

    @torch.no_grad()
    def reset_gates(self, generator: Optional[torch.Generator] = None) -> None:
        """fla's draw: A_log = log U(1, 16); dt_bias the inverse softplus of
        dt = exp U(log 1e-3, log 1e-1), at least 1e-4."""
        self.A_log.copy_(torch.empty_like(self.A_log).uniform_(1.0, 16.0, generator=generator).log())
        dt = torch.empty_like(self.dt_bias).uniform_(math.log(1e-3), math.log(1e-1), generator=generator).exp()
        dt = dt.clamp(min=1e-4)
        self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))

    def _projections(self) -> tuple:
        return (self.q_proj, self.k_proj, self.v_proj), (self.q_conv1d, self.k_conv1d, self.v_conv1d)

    def _gate(self, pre: torch.Tensor, heads: slice) -> torch.Tensor:
        """a: pre [..., heads in `heads` x d] -> float32 [..., heads, d]."""
        d = self.config.kda_head_dim
        ch = slice(heads.start * d, heads.stop * d)
        sp = F.softplus(pre.unflatten(-1, (-1, d)) + self.dt_bias[ch].float().view(-1, d))
        return sp.mul_(-torch.exp(self.A_log[heads].float())[:, None])

    def _out(self, o: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
        """The gated norm of o [..., heads, d] (float32) by gate [..., heads
        x d] -> float32 [..., heads x d]: `o_norm`, then sigmoid(gate)."""
        norm = self.o_norm
        y = torch.sigmoid(gate.unflatten(-1, (-1, self.config.kda_head_dim)).float())
        y.mul_(o).mul_(torch.rsqrt(o.square().mean(-1, keepdim=True) + norm.eps)).mul_(norm.weight)
        return y.flatten(-2)

    def forward(self, x: torch.Tensor, cache: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """x [B, S, H] -> [B, S, H]. `cache`: this layer's (state [B, heads,
        d, d] float32, conv [B, taps - 1, 3 heads d]); a call over several
        positions starts from them and leaves its last state and inputs
        there, a one-position call steps them in place."""
        with span("lm.kda"):
            if cache is not None and x.shape[1] == 1:
                return self._step(x, *cache)
            return self._chunked(x, cache)

    def k6_takes(self, x: torch.Tensor, cache: Optional[Sequence[torch.Tensor]]) -> bool:
        """Whether the chunked core may run as K6: bf16 input, projections
        and convolutions off the CPU, no gradient taken, the sizes K6 takes
        (`ops/kda_scan.shape_fault`), and a cache, if any, of a float32
        state and bf16 convolution inputs."""
        cfg = self.config
        projs, convs = self._projections()
        return (not torch.is_grad_enabled() and x.device.type != "cpu" and x.dtype == torch.bfloat16
                and all(m.weight.dtype == torch.bfloat16 for m in (*projs, *convs, self.f_b_proj, self.b_proj))
                and (cache is None or (cache[0].dtype == torch.float32 and cache[1].dtype == torch.bfloat16))
                and not k6.shape_fault(cfg.kda_num_heads, cfg.kda_head_dim, cfg.kda_conv_size, CHUNK))

    def _chunked(self, x: torch.Tensor, cache: Optional[Sequence[torch.Tensor]]) -> torch.Tensor:
        """K6 where `k6_takes` holds; else heads in groups: each group's q,
        k, v and gates are written once, into chunk-major buffers [chunks,
        B, heads, CHUNK, d], for `scan_chunks`."""
        b, s, _ = x.shape
        KimiDeltaAttention.scanned["positions"] += b * s
        state, conv = cache if cache is not None else (None, None)
        projs, convs = self._projections()
        if self.k6_takes(x, cache):
            KimiDeltaAttention.calls["fused"] += 1
            f, beta = self.f_b_proj(self.f_a_proj(x)), self.b_proj(x)
            qkv = [p(x) for p in projs]
            with span("lm.kda.scan"):
                o = k6.kda_scan(*qkv, f, beta, [c.weight for c in convs], self.A_log, self.dt_bias, self.scale,
                                conv, state)
            return self.o_proj(self._out(o, self.g_b_proj(self.g_a_proj(x))).to(x.dtype))
        KimiDeltaAttention.calls["plain"] += 1
        cfg = self.config
        nh, d = cfg.kda_num_heads, cfg.kda_head_dim
        width = nh * d
        nc = -(-s // CHUNK)
        full, rest = divmod(s, CHUNK)
        fa, ga = self.f_a_proj(x), self.g_a_proj(x)
        beta = torch.sigmoid(self.b_proj(x).float())
        out = x.new_empty(b, s, width)
        tails = []
        group = head_group(b, nc * CHUNK, nh, d)

        def into(buf, t):
            """t [B, S, heads, ...] into buf [nc, B, heads, CHUNK, ...]; the tail past S zeroed."""
            pos = buf.movedim(0, 1).movedim(3, 2)  # [B, nc, CHUNK, heads, ...]
            if full:
                pos[:, :full].copy_(t[:, :full * CHUNK].unflatten(1, (full, CHUNK)))
            if rest:
                pos[:, full, :rest].copy_(t[:, full * CHUNK:])
                pos[:, full, rest:].zero_()

        for h0 in range(0, nh, group):
            heads = slice(h0, h0 + group)
            ch = slice(h0 * d, (h0 + group) * d)
            ops = x.new_empty((4, nc, b, group, CHUNK, d), dtype=torch.float32)  # q, k, v, gates
            betas = x.new_empty((nc, b, group, CHUNK), dtype=torch.float32)
            for j in range(3):
                prev = None if conv is None else conv[:, :, j * width + ch.start:j * width + ch.stop]
                y, tail = causal_conv(F.linear(x, projs[j].weight[ch]), convs[j].weight[ch, 0], prev)
                tails.append((j, ch, tail))
                y = y.view(b, s, group, d)
                if j < 2:  # l2-normalised, the queries scaled
                    l2norm_(y)
                if j == 0:
                    y.mul_(self.scale)
                into(ops[j], y)
            into(ops[3], self._gate(F.linear(fa, self.f_b_proj.weight[ch]), heads))
            into(betas, beta[:, :, heads])
            first = None if state is None else state[:, heads].reshape(b * group, d, d)
            with span("lm.kda.scan"):
                o, last = scan_chunks(*(t.view(nc, b * group, CHUNK, d) for t in ops),
                                      betas.view(nc, b * group, CHUNK), first)
            del ops
            if state is not None:
                state[:, heads].copy_(last.view(b, group, d, d))
            o = o.view(nc, b, group, CHUNK, d).movedim(0, 1).movedim(3, 2).reshape(b, nc * CHUNK, group, d)[:, :s]
            out[:, :, ch].copy_(self._out(o, F.linear(ga, self.g_b_proj.weight[ch])))
        if conv is not None:
            for j, ch, tail in tails:
                conv[:, :, j * width + ch.start:j * width + ch.stop].copy_(tail)
        return self.o_proj(out)

    def _step(self, x: torch.Tensor, state: torch.Tensor, conv: torch.Tensor) -> torch.Tensor:
        """One position over the cache, in place: x [B, 1, H]."""
        cfg = self.config
        b = x.shape[0]
        nh, d = cfg.kda_num_heads, cfg.kda_head_dim
        projs, convs = self._projections()
        xt = x[:, 0]
        window = torch.cat([conv, torch.cat([p(xt) for p in projs], dim=-1)[:, None].to(conv.dtype)], dim=1)
        taps = torch.cat([c.weight[:, 0] for c in convs])  # [3 heads d, taps]
        y = F.silu((window.float() * taps.t().float()).sum(1))
        conv.copy_(window[:, 1:])
        q, k, v = y.view(b, 3, nh, d).unbind(1)
        q, k = l2norm_(q).mul_(self.scale), l2norm_(k)
        a = self._gate(self.f_b_proj(self.f_a_proj(xt)), slice(0, nh))
        beta = torch.sigmoid(self.b_proj(xt).float())
        state.mul_(torch.exp(a)[..., None])
        predicted = torch.einsum("bhk,bhkv->bhv", k, state)
        state.view(b * nh, d, d).baddbmm_((beta[..., None] * k).view(b * nh, d, 1), (v - predicted).view(b * nh, 1, d))
        o = torch.einsum("bhk,bhkv->bhv", q, state)
        return self.o_proj(self._out(o, self.g_b_proj(self.g_a_proj(xt))).to(x.dtype)[:, None])


class Block(nn.Module):
    """Pre-norm block: KDA or latent attention, then the layer's MLP or MoE."""

    def __init__(self, config: TransformerConfig, layer: int):
        super().__init__()
        kda = layer in config.kda_layers
        self.self_attn = KimiDeltaAttention(config) if kda else LatentAttention(config)
        self.mlp = MoE(config) if layer >= config.first_k_dense_replace else MLP(config)
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps)

    def forward(self, x, cos, sin, mask, cache: Optional[Sequence[torch.Tensor]] = None, cache_rows=None,
                mask_pos: Optional[torch.Tensor] = None):
        """`deepseek_v3.Block`'s call; `cache` is the layer's slots of the
        cache: ("state", "conv") of a KDA layer, ("kv",) of latent attention."""
        h = self.input_layernorm(x)
        if isinstance(self.self_attn, KimiDeltaAttention):
            x = x + self.self_attn(h, cache)
        else:
            x = x + self.self_attn(h, cos, sin, mask, None if cache is None else cache[0], cache_rows, mask_pos)
        h = self.post_attention_layernorm(x)
        return x + (self.mlp(h, cache_rows) if isinstance(self.mlp, MoE) else self.mlp(h))
