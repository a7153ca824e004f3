"""The port's bf16 parameter handling against the JAX package: the fused
stage's packing (`pack_stage`), the weight norm of every weight-normed conv,
and the coefficients K1 takes (alpha and 1 / (beta + eps)).

The JAX package computes all three in the parameters' dtype: the weight
norm op by op (`nn/weight_norm.weight_norm_kernel`), alpha and beta exp'd
and 1 / (beta + eps) taken in bf16 (`ops/stage_fused.pack_stage`,
`ops/anti_alias.py:607-612`), and only then casts the packed columns to
float32. The port does the same, so on bf16 parameters the packed arrays
are the JAX package's to the bit; the float32 path is unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmel_codec_tpu.ops.anti_alias as jax_anti_alias
from dmel_codec_tpu.nn.weight_norm import weight_norm_kernel
from dmel_codec_tpu.ops.stage_fused import StageSpec as JaxStageSpec
from dmel_codec_tpu.ops.stage_fused import pack_stage as jax_pack_stage
from dmel_codec_tpu_torch.convert import bigvgan_state_dict_from_jax
from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from dmel_codec_tpu_torch.nn.snake import snake_coefficients
from dmel_codec_tpu_torch.nn.weight_norm import WNConv1d, WNConvTranspose1d
from dmel_codec_tpu_torch.ops import anti_alias, library
from dmel_codec_tpu_torch.ops.anti_alias import anti_alias_activation_reference
from dmel_codec_tpu_torch.ops.stage_fused import StageSpec, pack_stage
from tests.test_torch_support import JaxBigVGAN, JaxBigVGANConfig, init_params, strict_f32  # noqa: F401

pytestmark = pytest.mark.usefixtures("strict_f32")

# a one-stage vocoder whose stage (C = 64) K2 fuses
ONE_STAGE = dict(num_mels=20, upsample_initial_channel=128, upsample_rates=(2,), upsample_kernel_sizes=(4,))


def _bf16_stage(activation: str, logscale: bool):
    """The stage's three flax AMPBlock1 parameter trees and the port's
    modules carrying the same values, all in bf16."""
    kw = dict(ONE_STAGE, activation=activation, snake_logscale=logscale)
    jparams = init_params(JaxBigVGAN(config=JaxBigVGANConfig(**kw)), 11, jnp.zeros((1, 8, kw["num_mels"])))
    if not logscale:  # plain-scale alpha / beta near 1, away from 0
        jparams = jax.tree_util.tree_map_with_path(
            lambda path, a: a + 1.0 if path[-1].key in ("alpha", "beta") else a, jparams)
    cfg = BigVGANConfig(**kw)
    port = BigVGAN(cfg)
    port.load_state_dict(bigvgan_state_dict_from_jax(jparams, cfg))
    jb = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), jparams)
    spec = dict(channels=64, activation=activation, logscale=logscale)
    return ([jb[f"resblock_{j}"] for j in range(3)], JaxStageSpec(**spec),
            port.to(torch.bfloat16).stage_blocks(0), StageSpec(**spec))


def _np(x) -> np.ndarray:
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


def _ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in bf16 ulps of want (8 significant bits)."""
    exponent = np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126)))
    return np.abs(got - want) / 2.0 ** (exponent - 7)


@pytest.mark.parametrize("activation,logscale", [("snakebeta", True), ("snake", True), ("snakebeta", False)])
def test_pack_stage_bf16_matches_jax_bit_for_bit(activation, logscale):
    """The JAX `pack_stage` op by op on the same bf16 parameters: w, b, a
    and ib are the same bits (before the repair every alpha and 1/beta
    differed, by up to 3.3e-3 and 5.0e-3 relative, and 37 % of the weights
    by one bf16 ulp)."""
    jblocks, jspec, blocks, spec = _bf16_stage(activation, logscale)
    want = jax_pack_stage(jblocks, jspec)
    got = pack_stage(blocks, spec)
    assert len(got["w"]) == len(want["w"]) == 18
    for g, w in zip(got["w"], want["w"]):
        assert g.dtype == torch.float32 and w.dtype == jnp.bfloat16
        np.testing.assert_array_equal(_np(g), _np(w))
    for key in ("b", "a", "ib"):
        assert got[key].dtype == torch.float32 and want[key].dtype == jnp.float32
        np.testing.assert_array_equal(_np(got[key]), _np(want[key]))


def test_pack_stage_bf16_against_jitted_jax():
    """Under `jax.jit` XLA fuses the weight norm and skips some of its bf16
    roundings (the squares and the product g v before the division), which
    the port's op-by-op arithmetic cannot follow: a, ib and b are still the
    same bits; the weights are within two bf16 ulps and mostly equal
    (measured: 98.3 % of them, 94.0 % of the worst conv's, at most 1.8 ulps)."""
    jblocks, jspec, blocks, spec = _bf16_stage("snakebeta", True)
    want = jax.jit(lambda b: jax_pack_stage(b, jspec))(jblocks)
    got = pack_stage(blocks, spec)
    for key in ("b", "a", "ib"):
        np.testing.assert_array_equal(_np(got[key]), _np(want[key]))
    g = np.concatenate([_np(x).ravel() for x in got["w"]])
    w = np.concatenate([_np(x).ravel() for x in want["w"]])
    assert _ulps(g, w).max() <= 2.0
    assert (g == w).mean() >= 0.95


@pytest.mark.parametrize("conv", ["conv", "transposed"])
def test_weight_norm_bf16_matches_jax(conv):
    """`WNConv1d.weight()` (the per-block path, conv_pre, conv_post) and
    `WNConvTranspose1d.weight()` (the upsamplers) on bf16 parameters: the
    JAX `weight_norm_kernel` op by op, to the bit. Both norms run over
    every axis but the torch layout's dim 0."""
    rng = np.random.default_rng(4)
    module = WNConv1d(48, 32, 7) if conv == "conv" else WNConvTranspose1d(48, 32, 8, 4)
    with torch.no_grad():
        module.weight_v.copy_(torch.from_numpy(rng.standard_normal(module.weight_v.shape).astype(np.float32) / 18))
        module.weight_g.mul_(torch.from_numpy(1 + 0.05 * rng.standard_normal(module.weight_g.shape).astype(np.float32)))
    module = module.to(torch.bfloat16)
    v = jnp.asarray(module.weight_v.detach().float().numpy()).astype(jnp.bfloat16)
    g = jnp.asarray(module.weight_g.detach().float().numpy().reshape(-1)).astype(jnp.bfloat16)
    got = module.weight().detach()
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(weight_norm_kernel(v, g, axis=0)))


def _k1_inputs(c: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 64, c)).astype(np.float32)
    alpha, beta = ((0.3 * rng.standard_normal(c)).astype(np.float32) for _ in range(2))
    return x, alpha, beta


@pytest.mark.parametrize("with_beta", [True, False])
@pytest.mark.parametrize("logscale", [True, False])
def test_k1_coefficients_bf16_match_jax(monkeypatch, with_beta, logscale):
    """K1's coefficients on bf16 parameters, as its plain version computes
    them (`snake_coefficients`), against what the JAX op hands its Pallas
    kernel (`_fused_forward`'s a_l and invb_l): the same bits. The kernel
    computes the same in-kernel from the parameters' values (it rounds each
    step to bf16 when told they are bf16; tests/test_torch_card_vocoder.py
    holds it to the plain version there): its wrapper hands it the bf16 values as float32 and
    the flag, recorded here with the launch stood in for."""
    c = 24
    x, alpha, beta = _k1_inputs(c, 9)
    if not logscale:
        alpha, beta = alpha + 1.0, beta + 1.0
    seen_jax = []

    def record_jax(xk, a_l, invb_l, interpret):
        seen_jax.append((a_l, invb_l))
        return jnp.zeros_like(xk)

    monkeypatch.setattr(jax_anti_alias, "_fused_forward", record_jax)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    jax_anti_alias.fused_anti_alias_activation(bf(x), bf(alpha), bf(beta) if with_beta else None, logscale, True)
    (a_l, invb_l), = seen_jax

    at = torch.from_numpy(alpha).bfloat16()
    bt = torch.from_numpy(beta).bfloat16() if with_beta else None
    a_port, inv_port = snake_coefficients(at, bt, logscale)
    assert a_port.dtype == inv_port.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(a_port), _np(a_l)[0, :c])
    np.testing.assert_array_equal(_np(inv_port), _np(invb_l)[0, :c])

    calls = []
    monkeypatch.setattr(library, "load", lambda: type("Lib", (), {"dmel_anti_alias": lambda *a: calls.append(a) or 0})())
    monkeypatch.setattr(library, "check_plane", lambda x, name="x": None)
    monkeypatch.setattr(library, "stream", lambda x: 0)
    anti_alias._launch(torch.from_numpy(x).bfloat16().transpose(1, 2).contiguous(), at, bt, logscale)
    (args,) = calls
    assert args[5:8] == (int(logscale), 1, 1)  # logscale, param_bf16, B (args[0] is the stand-in library)


def test_k1_plain_bf16_against_jax_kernel():
    """K1's plain version against the JAX op's Pallas kernel (interpret
    mode) on bf16 input and parameters. Both take the same bf16
    coefficients, round the 12 taps to bf16 (the JAX kernel's FIRs are bf16
    banded matmuls) and round the snake's output v to bf16 before the down
    FIR; what is left is the order of float32 sums, the kernel's polynomial
    sin and the JAX op's float32-tap oracle on the last rows of a ragged
    tail, so a rare result next to a rounding boundary rounds apart: at
    least 99 % of the outputs the same bits and within half a bf16 ulp of
    max |y| (measured at C = 24 / 64: every output the same bits; with
    float32 taps and v, 0.564 / 0.558 and 4.1e-3 / 3.8e-3 of max |y|)."""
    for c, seed in ((24, 3), (64, 5)):
        x, alpha, beta = _k1_inputs(c, seed)
        x = np.concatenate([x, -x], axis=1)  # T = 128: the kernel path (T >= 32)
        bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
        want = _np(jax_anti_alias.fused_anti_alias_activation(bf(x), bf(alpha), bf(beta), True, True))
        to_port = lambda a: torch.from_numpy(_np(bf(a)).copy()).bfloat16()  # noqa: E731
        got = anti_alias_activation_reference(to_port(x).transpose(1, 2).contiguous(), to_port(alpha),
                                              to_port(beta), True)
        got = _np(got.transpose(1, 2))
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 2.0**-8 * np.abs(want).max()
        assert (got == want).mean() >= 0.99
