"""The flash-attention backward of the port (FA-dKV / FA-dQ): its plain
version against the JAX package's real Pallas backward kernels run in
interpret mode, against autograd of the plain forward, and the dispatch
(CPU tensors -> plain versions; any other tensor -> the kernels or an error).

float32 on the CPU, inputs from a numpy seed, torch pinned to one thread.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dmel_codec_tpu.models import transformer as jax_tf
from dmel_codec_tpu_torch.ops import flash_attention as fa
from dmel_codec_tpu_torch.ops import library
from tests.test_torch_support import strict_f32, to_np  # noqa: F401  (strict_f32 is a fixture)

pytestmark = pytest.mark.usefixtures("strict_f32")


def _qkv_grad(shape, seed, dtype=torch.float32):
    b, s, h, kh, hd = shape
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, n, hd)).astype(np.float32) for n in (h, kh, kh))
    grad = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    return [torch.from_numpy(a).to(dtype) for a in (q, k, v, grad)]


def _plain_backward(q, k, v, grad):
    out, lse = fa.flash_attention_forward_reference(q, k, v)
    return fa.flash_attention_backward_reference(q, k, v, out, lse, grad)


def _autograd_backward(q, k, v, grad):
    ins = [t.detach().float().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(fa.flash_attention_reference(*ins), ins, grad.float())


@pytest.mark.parametrize("s", [128, 160])
def test_plain_backward_vs_jax_pallas_backward_kernels(s):
    """`jax.grad` through `_flash_causal_attention` under
    `force_tpu_interpret_mode` launches jax's `_flash_attention_bwd_dkv` and
    `_flash_attention_bwd_dq` (GQA 4 over 2 through the wrapper's repeat;
    S = 160 through its padding to 256). float32 both sides, sums in another
    order: 2e-5 x max|grad| per tensor."""
    q, k, v, grad = _qkv_grad((1, s, 4, 2, 64), seed=s)
    cfg = jax_tf.TransformerConfig(
        vocab_size=8, hidden_size=256, intermediate_size=8, num_layers=1, num_heads=4, num_kv_heads=2
    )

    def loss(q_, k_, v_):
        return jnp.sum(jax_tf._flash_causal_attention(q_, k_, v_, cfg) * jnp.asarray(to_np(grad)))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(to_np(t)) for t in (q, k, v)))
    got = _plain_backward(q, k, v, grad)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(to_np(g), w, rtol=0, atol=2e-5 * np.abs(w).max(), err_msg=name)


def _bf16_ulp(x: float) -> float:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


@pytest.mark.parametrize("s", [128, 200])
def test_plain_bf16_vs_jax_pallas_kernels(s):
    """bf16, GQA 4 over 2, hd 64: the port's plain forward and backward
    against jax's Pallas forward, dK/dV and dQ kernels (interpret mode).
    Both sides compute in float32 from the same bf16 inputs and round each
    result once; jax's kernels also round P (before P V and P^T dO) and dS
    (before dS^T Q and dS K) to bf16, as the port's CUDA kernels do, and the
    plain versions do not. The final rounding may flip one ulp; the product
    operands' rounding (2^-9 relative per term, of random sign) moves a sum
    by far less than one ulp of the largest value. Two bf16 ulps of max |x|
    per tensor; measured one (~40 % of the outputs differ, by one ulp)."""
    q, k, v, grad = _qkv_grad((1, s, 4, 2, 64), seed=s)
    cfg = jax_tf.TransformerConfig(
        vocab_size=8, hidden_size=256, intermediate_size=8, num_layers=1, num_heads=4, num_kv_heads=2
    )

    def bf16(t):
        return jnp.asarray(to_np(t)).astype(jnp.bfloat16)

    def loss(q_, k_, v_):
        return jnp.sum((jax_tf._flash_causal_attention(q_, k_, v_, cfg) * bf16(grad)).astype(jnp.float32))

    with pltpu.force_tpu_interpret_mode():
        out_j = jax_tf._flash_causal_attention(bf16(q), bf16(k), bf16(v), cfg)
        grads_j = jax.grad(loss, argnums=(0, 1, 2))(bf16(q), bf16(k), bf16(v))
    q, k, v, grad = (t.bfloat16() for t in (q, k, v, grad))
    out, lse = fa.flash_attention_forward_reference(q, k, v)
    got = (out, *fa.flash_attention_backward_reference(q, k, v, out, lse, grad))
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, (out_j, *grads_j)):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16 and g.shape == w.shape, name
        g, w = to_np(g.float()), np.asarray(w.astype(jnp.float32))
        assert np.abs(g - w).max() <= 2 * _bf16_ulp(np.abs(w).max()), (name, s)


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("s", [1, 37, 64, 65, 200])
def test_plain_backward_vs_autograd_of_the_plain_forward(s, hd):
    """Two derivations of one gradient (the recomputation from L and D
    against autograd's softmax backward), float32: 2e-5 x max(1, max|grad|)."""
    q, k, v, grad = _qkv_grad((2, s, 6, 2, hd), seed=s + hd)
    for name, g, w in zip(("dq", "dk", "dv"), _plain_backward(q, k, v, grad), _autograd_backward(q, k, v, grad)):
        tol = 2e-5 * max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= tol, (name, s, hd)


def test_plain_backward_bf16_inputs():
    """bf16 inputs, float32 arithmetic, results rounded once: within 2 bf16
    ulps (2^-7 relative each) of max|grad| of the float32 gradient of the
    same rounded inputs."""
    q, k, v, grad = _qkv_grad((2, 70, 4, 2, 64), seed=3, dtype=torch.bfloat16)
    got = _plain_backward(q, k, v, grad)
    for g, w in zip(got, _autograd_backward(q, k, v, grad)):
        assert g.dtype == torch.bfloat16
        assert (g.float() - w).abs().max().item() <= 2 * 2.0**-7 * w.abs().max().item()


def test_forward_reference_returns_the_log_sum_exp():
    q, k, v, _ = _qkv_grad((2, 33, 4, 2, 16), seed=4)
    out, lse = fa.flash_attention_forward_reference(q, k, v)
    torch.testing.assert_close(out, fa.flash_attention_reference(q, k, v), rtol=0, atol=0)
    scores = torch.einsum("bshd,bthd->bhst", q, k.repeat_interleave(2, dim=2)) / 4.0
    scores = scores.masked_fill(~torch.ones(33, 33, dtype=torch.bool).tril(), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1), rtol=1e-6, atol=1e-6)


def _no_library():
    raise AssertionError("a CPU tensor must not reach the kernel library")


def test_cpu_tensors_route_forward_and_backward_through_the_plain_versions(monkeypatch):
    monkeypatch.setattr(library, "load", _no_library)
    calls = []
    plain_bwd = fa.flash_attention_backward_reference
    monkeypatch.setattr(
        fa, "flash_attention_backward_reference", lambda *a: calls.append("bwd") or plain_bwd(*a)
    )
    q, k, v, grad = _qkv_grad((1, 40, 4, 2, 16), seed=5)
    ins = [t.requires_grad_() for t in (q, k, v)]
    counts = (fa.flash_attention.launches, fa.flash_attention_dkv.launches, fa.flash_attention_dq.launches)
    out = fa.flash_attention(*ins)
    torch.testing.assert_close(out, fa.flash_attention_reference(q, k, v), rtol=0, atol=0)
    out.backward(grad)
    assert calls == ["bwd"]
    for t, w in zip(ins, _autograd_backward(q, k, v, grad)):
        assert (t.grad - w).abs().max().item() <= 2e-5 * max(1.0, w.abs().max().item())
    # a CPU tensor never counts as a kernel launch
    assert counts == (fa.flash_attention.launches, fa.flash_attention_dkv.launches, fa.flash_attention_dq.launches)


# (kernel, dtype) -> (threads, shared bytes) of the launch at hd 64: the
# float32 FA and FA-dQ on the split-TF32 kernels (`fa.tf32_smem_bytes`), the
# bf16 ones on the mma.sync kernels (Q, dO and two buffers each of K and V
# as bf16 rows of hd + 8; FA-dKV also L and D)
LAUNCHES = {("FA-dQ", torch.float32): (fa.TF32_THREADS, fa.tf32_smem_bytes("FA-dQ", 64)),
            ("FA-dQ", torch.bfloat16): (128, 2 * 6 * 64 * 72), ("FA-dKV", torch.bfloat16): (128, 2 * 6 * 64 * 72 + 1024),
            ("FA", torch.bfloat16): (128, 2 * 5 * 64 * 72),
            ("FA", torch.float32): (fa.TF32_THREADS, fa.tf32_smem_bytes("FA", 64))}


@pytest.mark.parametrize("kernel,dtype", list(LAUNCHES))
def test_launch_config_reports_the_library(monkeypatch, kernel, dtype):
    """`launch_config` asks the library for the launch this kernel makes at
    q's shape and dtype (FA-dQ: which = 1, the bf16 flag picking the
    tensor-core kernel of that dtype) and returns its grid, threads and
    shared bytes; the library itself answers only on the card
    (chip_smoke.py phase 19 holds its float32 answers to
    `fa.tf32_smem_bytes`)."""
    seen = []
    threads, smem = LAUNCHES[kernel, dtype]

    class Lib:
        def _answer(self, *args):
            seen.append(args[:-1])
            args[-1][:] = [7, 14, 2, threads, smem]
            return 0

        dmel_flash_attention_config = dmel_flash_attention_bwd_config = _answer

    monkeypatch.setattr(library, "load", lambda: Lib())
    q = torch.zeros((2, 448, 14, 64), dtype=dtype)
    cfg = fa.launch_config(kernel, q)
    assert cfg == {"grid": (7, 14, 2), "threads": threads, "smem_bytes": smem}
    bf = int(dtype == torch.bfloat16)
    want = (2, 448, 14, 64, bf) if kernel == "FA" else ({"FA-dKV": 0, "FA-dQ": 1}[kernel], 2, 448, 14, 64, bf)
    assert seen == [want]


@pytest.mark.parametrize("kernel", ["FA", "FA-dQ"])
def test_float32_launches_fit_shared_memory(kernel):
    """The split-TF32 kernels' shared memory fits a block's 227 KB at every
    head size the wrapper admits, and leaves two blocks an SM (228 KB, 1 KB
    of it reserved per block) at the trainer's hd 64."""
    for hd in range(16, 129, 16):
        assert fa.tf32_smem_bytes(kernel, hd) <= 232448, hd
    assert 2 * (fa.tf32_smem_bytes(kernel, 64) + 1024) <= 233472
    assert fa.tf32_smem_bytes(kernel, 64) == {"FA": 87040, "FA-dQ": 104448}[kernel]


def test_non_cpu_tensors_never_reach_the_plain_versions(monkeypatch, tmp_path):
    """With no nvcc (and no built library) a tensor that is not on the CPU
    raises in the forward, with and without autograd, and in the backward;
    the plain versions are never called."""

    def forbidden(*_):
        raise AssertionError("the plain version ran for a tensor that is not on the CPU")

    for name in ("flash_attention_reference", "flash_attention_forward_reference", "flash_attention_backward_reference",
                 "flash_attention_dkv_reference", "flash_attention_dq_reference"):
        monkeypatch.setattr(fa, name, forbidden)
    monkeypatch.setattr(library, "find_nvcc", lambda: None)
    monkeypatch.setattr(library, "BUILD_DIR", tmp_path)
    library.load.cache_clear()
    q, k, v = (torch.empty((1, 8, n, 16), device="meta") for n in (4, 2, 2))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa.flash_attention(q.requires_grad_(), k, v)
    out, grad = torch.empty_like(q), torch.empty_like(q)
    lse = torch.empty((1, 4, 8), device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        fa._FlashAttention.backward(_SavedContext(q, k, v, out, lse), grad)
    library.load.cache_clear()


class _SavedContext:
    """What `_FlashAttention.backward` reads of its autograd context."""

    def __init__(self, *tensors):
        self.saved_tensors = tensors
