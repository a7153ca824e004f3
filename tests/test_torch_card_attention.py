"""FA, FA-dKV and FA-dQ on the card against their plain versions, at the
slow decoder's head layout, a TP = 2 rank's, ragged lengths and head sizes,
float32 and bf16 (`card`: see tests/card.py)."""

from __future__ import annotations

import pytest
import torch

from dmel_codec_tpu_torch.models.lm import SlowFastLMConfig
from dmel_codec_tpu_torch.ops import flash_attention as fa_ops
from tests.card import FA_KERNELS, TOL, check_close, fa_launches, fa_rel, on_card, reset_launches

pytestmark = pytest.mark.card

F32, BF16 = torch.float32, torch.bfloat16
SLOW = SlowFastLMConfig().slow  # the flagship slow decoder: 14 query heads over 2 KV heads of 64
HEADS, KV_HEADS, HD = SLOW.num_heads, SLOW.num_kv_heads, SLOW.head_dim

FWD_CASES = [(2, 512, 14, 2, 64), (2, 2048, 14, 2, 64), (1, 4096, 14, 2, 64), (3, 513, 14, 2, 64),
             (1, 1500, 14, 2, 64), (2, 1, 14, 2, 64), (2, 700, 10, 2, 48), (1, 100, 4, 2, 16),
             (1, 77, 4, 2, 80), (1, 300, 4, 2, 128)]
# the LM forward's 2 x 2048 and the trainer's 2 x 1024, one rank's heads under 2-way tensor parallelism
# (7 -> 1), ragged lengths, head sizes 16 to 128, a group of one
BWD_CASES = [(2, 2048, HEADS, KV_HEADS, HD), (2, 1024, HEADS, KV_HEADS, HD), (2, 1024, HEADS // 2, KV_HEADS // 2, HD),
             (2, 1, HEADS, KV_HEADS, HD), (3, 37, HEADS, KV_HEADS, HD), (2, 700, HEADS, KV_HEADS, HD),
             (1, 1000, HEADS, KV_HEADS, HD), (2, 700, 10, 2, 48), (1, 300, 4, 2, 128), (1, 130, 4, 4, 16)]


def _qkv(dev, b, s, h, kh, d, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((b, s, n, d), device=dev, generator=gen) for n in (h, kh, kh, h)]


@pytest.mark.parametrize("b,s,h,kh,d", FWD_CASES)
@pytest.mark.parametrize("dt", [F32, BF16])
def test_fa_matches_plain(b, s, h, kh, d, dt):
    dev = on_card()
    q, k, v, _ = (t.to(dt) for t in _qkv(dev, b, s, h, kh, d, seed=s))
    want = fa_ops.flash_attention_reference(q, k, v)
    check_close(f"FA {[b, s, h, d]} kv heads {kh}", fa_ops.flash_attention(q, k, v), want, fa_rel(dt, v, want))


@pytest.mark.parametrize("b,s,h,kh,d", BWD_CASES)
@pytest.mark.parametrize("dt", [F32, BF16])
def test_fa_backward_matches_plain(b, s, h, kh, d, dt):
    """FA, FA-dKV and FA-dQ (one launch each a backward) against their
    plain versions, which take the plain forward's out and L, so nothing of
    the kernels enters the numbers they are held against (float32: FA-dQ
    split-TF32 on the tensor cores, FA-dKV on the CUDA cores; bf16: tensor
    cores); two runs give the same bits; the forward's L store changes no
    bit of its output, and its L is the plain scores' log-sum-exp."""
    dev = on_card()
    q, k, v, g = (t.to(dt).requires_grad_() for t in _qkv(dev, b, s, h, kh, d, seed=s + 1))
    reset_launches(*FA_KERNELS.values())
    out = fa_ops.flash_attention(q, k, v)  # under autograd: the forward stores L
    got = torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
    again = torch.autograd.grad(out, (q, k, v), g)
    assert fa_launches() == {"FA": 1, "FA-dKV": 2, "FA-dQ": 2}, fa_launches()
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again)), "two runs of the backward kernels differ"
    q, k, v, g = (t.detach() for t in (q, k, v, g))
    out_k, lse = fa_ops._launch(q, k, v, with_lse=True)
    out_p, lse_p = fa_ops.flash_attention_forward_reference(q, k, v)
    assert torch.equal(out_k, out.detach())
    check_close("out (with the L store)", out_k, out_p, fa_rel(dt, v, out_p))
    check_close("L", lse, lse_p, TOL[("FA", F32)])
    dk_p, dv_p = fa_ops.flash_attention_dkv_reference(q, k, v, out_p, lse_p, g)
    dq_p = fa_ops.flash_attention_dq_reference(q, k, v, out_p, lse_p, g)
    for name, a, w in zip(("dq", "dk", "dv"), got, (dq_p, dk_p, dv_p)):
        check_close(name, a, w, TOL[("FA-bwd", dt)])


@pytest.mark.parametrize("b,s", [(2, 1024), (2, 700)])
def test_fa_backward_matches_autograd_of_plain(b, s):
    """An independent derivation: autograd through the plain forward
    (softmax backward), at the trainer's shape and a ragged one, float32."""
    dev = on_card()
    q, k, v, g = _qkv(dev, b, s, HEADS, KV_HEADS, HD, seed=9)
    ins = [t.requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fa_ops.flash_attention(*ins), ins, g)
    want = torch.autograd.grad(fa_ops.flash_attention_reference(*ins), ins, g)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        check_close(name, a, w, TOL[("FA-bwd", F32)])
