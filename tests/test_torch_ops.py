"""The port's kernel modules on the CPU: plain versions against the JAX
oracles, and the dispatch rule (plain version only for CPU tensors; any
other tensor goes to the CUDA kernel or raises).

The CUDA kernels themselves run only on the card; chip_smoke.py holds each
against these plain versions there.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_codec_tpu.ops.anti_alias import (
    anti_alias_activation_reference as jax_aa_reference,
    fused_anti_alias_activation,
)
from dmel_codec_tpu.ops.stage_fused import StageSpec as JaxStageSpec
from dmel_codec_tpu.ops.stage_fused import pack_stage as jax_pack_stage
from dmel_codec_tpu.ops.stage_fused import stage_reference as jax_stage_reference
from dmel_codec_tpu_torch.ops import anti_alias, library, stage_fused
from dmel_codec_tpu_torch.ops.anti_alias import anti_alias_activation, anti_alias_activation_reference
from dmel_codec_tpu_torch.ops.stage_fused import StageSpec, amp_stage, pack_stage, stage_reference
from tests.test_torch_support import VOCODER_KW, build_vocoder, strict_f32, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("strict_f32")


def _act_inputs(seed: int, b: int, t: int, c: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    alpha = (0.3 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.3 * rng.standard_normal(c)).astype(np.float32)
    return x, alpha, beta


def _port_act(x, alpha, beta, logscale):
    xt = torch.from_numpy(x).transpose(1, 2).contiguous()
    bt = None if beta is None else torch.from_numpy(beta)
    return anti_alias_activation(xt, torch.from_numpy(alpha), bt, logscale).transpose(1, 2)


@pytest.mark.parametrize("t", [64, 101, 17, 1])  # even, odd, below the TPU kernel's 32, one sample
@pytest.mark.parametrize("act", ["snake", "snakebeta"])
@pytest.mark.parametrize("logscale", [True, False])
def test_act_plain_matches_jax_oracle(t, act, logscale):
    """1e-5 abs: the same FIR taps and sin, summed in another order."""
    x, alpha, beta = _act_inputs(t, 2, t, 8)
    if not logscale:
        alpha, beta = alpha + 1.0, beta + 1.0  # plain scale stays away from 0
    beta = beta if act == "snakebeta" else None
    want = jax_aa_reference(
        jnp.asarray(x), jnp.asarray(alpha), None if beta is None else jnp.asarray(beta), logscale
    )
    got = _port_act(x, alpha, beta, logscale)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)


def test_act_plain_matches_jax_interpret_kernel():
    """Against the Pallas kernel run in interpret mode (its polynomial sin
    is within 1.5e-6 of sin): 1e-5 abs, as tests/test_anti_alias_op.py."""
    x, alpha, beta = _act_inputs(7, 2, 100, 24)
    want = fused_anti_alias_activation(
        jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta), True, True
    )
    got = _port_act(x, alpha, beta, True)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)


def test_act_backward_differentiates_plain_version(monkeypatch):
    """The kernel's autograd.Function: its backward differentiates the
    plain version (run here with the plain version standing in for the
    launch, which needs the card)."""
    monkeypatch.setattr(
        anti_alias, "_launch",
        lambda x, a, b, ls: anti_alias_activation_reference(x, a, b, ls),
    )
    x, alpha, beta = _act_inputs(8, 1, 40, 6)
    ins_k = [torch.from_numpy(a).requires_grad_() for a in (x.transpose(0, 2, 1).copy(), alpha, beta)]
    ins_r = [t.detach().clone().requires_grad_() for t in ins_k]
    anti_alias._AntiAlias.apply(*ins_k, True).square().sum().backward()
    anti_alias_activation_reference(*ins_r, True).square().sum().backward()
    for a, b in zip(ins_k, ins_r):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


@pytest.fixture(scope="module")
def stage():
    """Stage 1 of the small vocoder (C = 8): JAX packing and the port's."""
    _, params, port = build_vocoder()
    i, c = 1, VOCODER_KW["upsample_initial_channel"] // 4
    spec = StageSpec(channels=c)
    jax_packed = jax_pack_stage([params[f"resblock_{3 * i + j}"] for j in range(3)], JaxStageSpec(channels=c))
    return spec, jax_packed, pack_stage(port.stage_blocks(i), spec)


def test_pack_stage_matches_jax(stage):
    """Weight norm in float32 on both sides: 1e-6 relative."""
    _, want, got = stage
    assert len(got["w"]) == len(want["w"]) == 18
    for g, w in zip(got["w"], want["w"]):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-6, atol=1e-7)
    for key in ("b", "a", "ib"):
        np.testing.assert_allclose(to_np(got[key]), np.asarray(want[key]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("t", [300, 301, 40])
def test_stage_plain_matches_jax_oracle(stage, t):
    """stage_reference on the JAX pack_stage output: 2e-5 abs / 1e-4 rel,
    as tests/test_stage_fused.py:74 (36 chained ops, summation order)."""
    spec, jax_packed, _ = stage
    x = np.random.default_rng(t).standard_normal((2, t, spec.channels)).astype(np.float32)
    want = jax_stage_reference(jnp.asarray(x), jax_packed, JaxStageSpec(channels=spec.channels))
    packed = {
        "w": [torch.from_numpy(np.array(w)) for w in jax_packed["w"]],
        **{k: torch.from_numpy(np.array(jax_packed[k])) for k in ("b", "a", "ib")},
    }
    got = amp_stage(torch.from_numpy(x).transpose(1, 2).contiguous(), packed, spec)
    np.testing.assert_allclose(to_np(got.transpose(1, 2)), np.asarray(want), atol=2e-5, rtol=1e-4)


# ---- dispatch ---------------------------------------------------------------


def _no_library():
    raise AssertionError("a CPU tensor must not reach the kernel library")


def test_cpu_tensors_take_the_plain_versions(monkeypatch, stage):
    spec, _, packed = stage
    monkeypatch.setattr(library, "load", _no_library)
    x = torch.randn(2, spec.channels, 50)
    a, b = torch.randn(spec.channels), torch.randn(spec.channels)
    n1, n2 = anti_alias_activation.launches, amp_stage.launches
    torch.testing.assert_close(
        anti_alias_activation(x, a, b, True), anti_alias_activation_reference(x, a, b, True), rtol=0, atol=0
    )
    torch.testing.assert_close(amp_stage(x, packed, spec), stage_reference(x, packed, spec), rtol=0, atol=0)
    assert (anti_alias_activation.launches, amp_stage.launches) == (n1, n2)


def test_non_cpu_tensors_never_fall_back(monkeypatch, tmp_path, stage):
    """With no nvcc (and no built library) a tensor that is not on the CPU
    raises instead of taking the plain version."""
    spec, _, packed = stage
    monkeypatch.setattr(library, "find_nvcc", lambda: None)
    monkeypatch.setattr(library, "BUILD_DIR", tmp_path)
    library.load.cache_clear()
    x = torch.empty(2, spec.channels, 50, device="meta")
    a = torch.empty(spec.channels, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        anti_alias_activation(x, a, a, True)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        stage_fused.amp_stage(x, packed, spec)
    library.load.cache_clear()
