"""The split-TF32 arithmetic of the float32 flash-attention kernels (FA's
`flash_attention_tf32_kernel`, FA-dQ's `dq_tf32_kernel`), emulated in torch
on the CPU and held against the JAX package's Pallas kernels.

The kernels run on the card only. What they compute is emulated here step
for step: every operand x split into hi = tf32(x) and lo = tf32(x - hi)
(`ops/stage_fused.split_tf32`, the kernels' `dmel::split_tf32`), each
product as A_lo B_hi + A_hi B_lo + A_hi B_hi per k-step of 8 (float32
products of TF32 values are exact; the sums are float32), 64-row query
tiles against 64-key tiles up to the diagonal, the online softmax in the
exp2 domain, P and dS kept float32 and split like any operand, and each
key tile's P V or dS K in a fresh accumulator added to the running sums.
The emulation is a model of the kernels, not a plain version: the plain
versions (`flash_attention_reference`, `flash_attention_dq_reference`)
stay float32 products. The fragment indexing the kernels use to take P's
and dS's A operand straight from the score tile's C fragment (each 8 keys
in the order {0, 2, 4, 6, 1, 3, 5, 7}) is checked lane by lane against
mma.sync.m16n8k8's documented fragment layout.

float32 on the CPU, inputs from a numpy seed, torch pinned to one thread.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jax_fa

from dmel_codec_tpu.models import transformer as jax_tf
from dmel_codec_tpu_torch.ops.stage_fused import split_tf32
from tests.test_torch_support import strict_f32, to_np  # noqa: F401  (strict_f32 is a fixture)

pytestmark = pytest.mark.usefixtures("strict_f32")

LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
TILE = 64  # query rows and keys per tile
SHAPE = (1, 4, 2, 64)  # B, H (query heads), KH (KV heads), hd: GQA 4 over 2


# ---- mma.sync.m16n8k8 .tf32, lane by lane ----------------------------------------------

def _lanes():
    lane = np.arange(32)
    return lane // 4, lane % 4  # g, t


def _mma_m16n8k8(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """d = A B + C from the 32 lanes' registers, in PTX's fragment layout:
    A 16 x 8 {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)}, B 8 x 8
    {(t, g), (t + 4, g)}, C and D 16 x 8 {(g, 2t), (g, 2t + 1), (g + 8, 2t),
    (g + 8, 2t + 1)}; a [32, 4], b [32, 2], c [32, 4] -> d [32, 4]."""
    g, t = _lanes()
    A, B, C = np.zeros((16, 8)), np.zeros((8, 8)), np.zeros((16, 8))
    A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a.T
    B[t, g], B[t + 4, g] = b.T
    C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1] = c.T
    D = A @ B + C
    return np.stack([D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1]], axis=1)


def _c_fragment(m: np.ndarray) -> np.ndarray:
    """A 16 x 8 matrix as the lanes hold it in a C fragment."""
    g, t = _lanes()
    return np.stack([m[g, 2 * t], m[g, 2 * t + 1], m[g + 8, 2 * t], m[g + 8, 2 * t + 1]], axis=1)


def test_permuted_fragments_give_the_product():
    """P (16 rows x 8 keys, as the score tile's C fragment leaves it in the
    lanes) times V (8 keys x 8 columns): the kernels' A = (c0, c2, c1, c3)
    with B read from keys 2t and 2t + 1 at column g (`c_to_a_split`,
    `lds_b_perm` in csrc/flash_common.cuh; V in P V, K in dS K) gives P V,
    as the unpermuted indexing (A from keys t and t + 4, B from rows t and
    t + 4) does. Mixing the two orders does not."""
    rng = np.random.default_rng(0)
    p, v = rng.standard_normal((16, 8)), rng.standard_normal((8, 8))
    g, t = _lanes()
    c = _c_fragment(p)
    zero = np.zeros((32, 4))
    permuted_a = c[:, [0, 2, 1, 3]]
    permuted_b = np.stack([v[2 * t, g], v[2 * t + 1, g]], axis=1)
    plain_a = np.stack([p[g, t], p[g + 8, t], p[g, t + 4], p[g + 8, t + 4]], axis=1)
    plain_b = np.stack([v[t, g], v[t + 4, g]], axis=1)
    want = _c_fragment(p @ v)
    np.testing.assert_allclose(_mma_m16n8k8(permuted_a, permuted_b, zero), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(_mma_m16n8k8(plain_a, plain_b, zero), want, rtol=0, atol=1e-12)
    assert np.abs(_mma_m16n8k8(permuted_a, plain_b, zero) - want).max() > 1e-3


def test_score_fragments_read_k_along_its_rows():
    """S = Q K^T: A from Q at (g, t) / (g, t + 4) and B from K's row g at
    columns t and t + 4 (`lds_a_split`, `lds_bt`) give Q K^T's C tile."""
    rng = np.random.default_rng(1)
    q, k = rng.standard_normal((16, 8)), rng.standard_normal((8, 8))
    g, t = _lanes()
    a = np.stack([q[g, t], q[g + 8, t], q[g, t + 4], q[g + 8, t + 4]], axis=1)
    b = np.stack([k[g, t], k[g, t + 4]], axis=1)
    np.testing.assert_allclose(_mma_m16n8k8(a, b, np.zeros((32, 4))), _c_fragment(q @ k.T), rtol=0, atol=1e-12)


# ---- the kernels' arithmetic, tile by tile --------------------------------------------

def _products(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """acc + a b as the kernels take it: per k-step of 8, A_lo B_hi, then
    A_hi B_lo, then A_hi B_hi into the same float32 sum."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        acc = acc + al[:, ks] @ bh[ks]
        acc = acc + ah[:, ks] @ bl[ks]
        acc = acc + ah[:, ks] @ bh[ks]
    return acc


def _key_tile(x: torch.Tensor, n0: int) -> torch.Tensor:
    """Keys [n0, n0 + 64) of a [S, hd] head, zero beyond S."""
    tile = torch.zeros((TILE, x.shape[1]), dtype=x.dtype)
    rows = x[n0 : n0 + TILE]
    tile[: rows.shape[0]] = rows
    return tile


def _visible(q0: int, rows: int, n0: int) -> torch.Tensor:
    return torch.arange(n0, n0 + TILE)[None, :] <= torch.arange(q0, q0 + rows)[:, None]


def _tiles(q, k):
    """(b, h, kv head, q0, rows) of every block of the launch."""
    b_, s, h_, _ = q.shape
    g = h_ // k.shape[2]
    for b in range(b_):
        for h in range(h_):
            for q0 in range(0, s, TILE):
                yield b, h, h // g, q0, min(TILE, s - q0)


def emulate_forward(q, k, v, products=_products):
    """`flash_attention_tf32_kernel`: (out [B, S, H, hd], L [B, H, S])."""
    hd = q.shape[3]
    sl2 = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    out, lse = torch.empty_like(q), torch.empty((q.shape[0], q.shape[2], q.shape[1]))
    for b, h, kh, q0, rows in _tiles(q, k):
        qt = q[b, q0 : q0 + rows, h]
        o = torch.zeros((rows, hd))
        m, l = torch.full((rows,), -math.inf), torch.zeros(rows)
        for n0 in range(0, q0 + 1, TILE):
            kt, vt = _key_tile(k[b, :, kh], n0), _key_tile(v[b, :, kh], n0)
            x = products(torch.zeros((rows, TILE)), qt, kt.T) * sl2
            x = x.masked_fill(~_visible(q0, rows, n0), -math.inf)
            mn = torch.maximum(m, x.max(1).values)
            corr = torch.exp2(m - mn)
            p = torch.exp2(x - mn[:, None])
            l, m = l * corr + p.sum(1), mn
            fresh = products(torch.zeros((rows, hd)), p, vt)  # this tile's P V
            o = o * corr[:, None] + fresh
        out[b, q0 : q0 + rows, h] = o / l[:, None]
        lse[b, h, q0 : q0 + rows] = (m + torch.log2(l)) * LN2
    return out, lse


def emulate_dq(q, k, v, dout, lse, delta):
    """`dq_tf32_kernel`: dQ [B, S, H, hd] from L and D [B, H, S]."""
    hd = q.shape[3]
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    sl2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    dq = torch.empty_like(q)
    for b, h, kh, q0, rows in _tiles(q, k):
        qt, dot = q[b, q0 : q0 + rows, h], dout[b, q0 : q0 + rows, h]
        l2 = lse[b, h, q0 : q0 + rows] * LOG2E
        d = delta[b, h, q0 : q0 + rows]
        acc = torch.zeros((rows, hd))
        for n0 in range(0, q0 + 1, TILE):
            kt, vt = _key_tile(k[b, :, kh], n0), _key_tile(v[b, :, kh], n0)
            sc = _products(torch.zeros((rows, TILE)), qt, kt.T)
            dp = _products(torch.zeros((rows, TILE)), dot, vt.T)
            p = torch.exp2(sc * sl2 - l2[:, None]).masked_fill(~_visible(q0, rows, n0), 0.0)
            ds = p * (dp - d[:, None])
            acc = acc + _products(torch.zeros((rows, hd)), ds, kt)  # this tile's dS K
        dq[b, q0 : q0 + rows, h] = acc * scale
    return dq


# ---- against the JAX package's Pallas kernels (interpret mode) ---------------------------

def _inputs(s: int, seed: int):
    b, h, kh, hd = SHAPE
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, n, hd)).astype(np.float32) for n in (h, kh, kh))
    grad = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    return [torch.from_numpy(a) for a in (q, k, v, grad)]


def _cfg():
    b, h, kh, hd = SHAPE
    return jax_tf.TransformerConfig(vocab_size=8, hidden_size=h * hd, intermediate_size=8, num_layers=1,
                                    num_heads=h, num_kv_heads=kh)


def _jax_forward(q, k, v):
    """jax's Pallas forward with its residuals, on the inputs
    `_flash_causal_attention` (dmel_codec_tpu/models/transformer.py) hands
    it: K / V repeated to full heads, S zero-padded to a multiple of 128.
    Returns out [B, S, H, hd] and L = m + log(l) [B, H, S]."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    pad = (-s) % 128

    def heads_first(x, repeat=1):
        x = jnp.repeat(jnp.asarray(to_np(x)), repeat, axis=2)
        return jnp.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0))).transpose(0, 2, 1, 3)

    qj, kj, vj = heads_first(q), heads_first(k, g), heads_first(v, g)
    sizes = jax_fa.BlockSizes.get_default(b, h, s + pad, s + pad, hd)
    with pltpu.force_tpu_interpret_mode():
        o, l, m = jax_fa._flash_attention(qj, kj, vj, None, None, True, True, 1.0 / math.sqrt(hd), sizes, False)
    out = np.asarray(o).transpose(0, 2, 1, 3)[:, :s]
    return out, np.asarray(m + jnp.log(l))[:, :, :s]


@pytest.mark.parametrize("s", [128, 160])
def test_emulated_forward_vs_jax_pallas_forward(s):
    """O and L of the split-TF32 forward against jax's Pallas forward kernel
    (the one `_flash_causal_attention` launches; its output checked equal to
    that path's), float32, GQA 4 over 2, hd 64, S = 128 and a ragged 160:
    the kernels' tolerance, 2e-5 x max |want|."""
    q, k, v, _ = _inputs(s, seed=s)
    want_out, want_lse = _jax_forward(q, k, v)
    with pltpu.force_tpu_interpret_mode():
        path = jax_tf._flash_causal_attention(*(jnp.asarray(to_np(t)) for t in (q, k, v)), _cfg())
    np.testing.assert_array_equal(np.asarray(path), want_out)
    out, lse = emulate_forward(q, k, v)
    np.testing.assert_allclose(to_np(out), want_out, rtol=0, atol=2e-5 * np.abs(want_out).max())
    np.testing.assert_allclose(to_np(lse), want_lse, rtol=0, atol=2e-5 * np.abs(want_lse).max())


@pytest.mark.parametrize("s", [128, 160])
def test_emulated_dq_vs_jax_pallas_dq(s):
    """dQ of the split-TF32 FA-dQ, fed the emulated forward's O and L and
    D = rowsum(dO * O) as the wrapper computes it, against `jax.grad`
    through `_flash_causal_attention`, which launches jax's
    `_flash_attention_bwd_dq` (interpret mode): 2e-5 x max |want|."""
    q, k, v, grad = _inputs(s, seed=s + 1)

    def loss(q_, k_, v_):
        return jnp.sum(jax_tf._flash_causal_attention(q_, k_, v_, _cfg()) * jnp.asarray(to_np(grad)))

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.grad(loss)(*(jnp.asarray(to_np(t)) for t in (q, k, v))))
    out, lse = emulate_forward(q, k, v)
    delta = (grad * out).sum(-1).transpose(1, 2).contiguous()
    got = emulate_dq(q, k, v, grad, lse, delta)
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_one_tf32_product_would_miss_the_tolerance():
    """The same forward with one TF32 product (A_hi B_hi alone) misses
    2e-5: the split is what holds the float32 contract."""
    q, k, v, _ = _inputs(128, seed=7)
    want_out, _ = _jax_forward(q, k, v)

    def one_product(acc, a, b):
        return acc + split_tf32(a)[0] @ split_tf32(b)[0]

    out, _ = emulate_forward(q, k, v, products=one_product)
    assert np.abs(to_np(out) - want_out).max() > 2e-5 * np.abs(want_out).max()
