"""The public `nn/` modules of the port against the JAX package (CPU,
float32): `snake` / `Snake`, `UpSample1d` / `DownSample1d`, and the WaveNet's
diffusion-step pathway (`diffusion_embedding`, `WaveNet(is_diffusion=True)`).

The JAX modules run channels-last [B, T, C], the port channels-first
[B, C, T]; the same seeded numpy inputs go through both. Tolerances are
`tests/test_torch_modules.py`'s TOL (1e-5 abs / 1e-4 rel) unless a test says
otherwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_codec_tpu.nn import resample as jax_resample
from dmel_codec_tpu.nn.snake import Snake as JaxSnake
from dmel_codec_tpu.nn.snake import snake as jax_snake
from dmel_codec_tpu.nn import wavenet as jax_wavenet
from dmel_codec_tpu_torch import convert
from dmel_codec_tpu_torch.nn import DownSample1d, Snake, UpSample1d, WaveNet, snake
from dmel_codec_tpu_torch.nn import wavenet as port_wavenet
from tests.test_torch_support import init_params, strict_f32, to_np  # noqa: F401  (strict_f32 is a fixture)

pytestmark = pytest.mark.usefixtures("strict_f32")
TOL = dict(atol=1e-5, rtol=1e-4)
B, C, T = 2, 6, 37


def _cf(a: np.ndarray) -> torch.Tensor:
    """[B, T, C] numpy -> channels-first torch."""
    return torch.from_numpy(np.ascontiguousarray(a)).transpose(1, 2)


def _x(seed: int, channels: int = C, t: int = T) -> np.ndarray:
    return (1.5 * np.random.default_rng(seed).standard_normal((B, t, channels))).astype(np.float32)


# ---- snake ------------------------------------------------------------------------


@pytest.mark.parametrize("logscale", [False, True])
def test_snake_function(logscale):
    x = _x(0)
    alpha = (0.2 * np.random.default_rng(1).standard_normal(C) + (0.0 if logscale else 1.0)).astype(np.float32)
    want = jax_snake(jnp.asarray(x), jnp.asarray(alpha), logscale)
    got = snake(_cf(x), torch.from_numpy(alpha), logscale).transpose(1, 2)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("logscale", [False, True])
def test_snake_module(logscale):
    x = _x(2)
    jmod = JaxSnake(features=C, alpha_logscale=logscale)
    init = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    module = Snake(C, alpha_logscale=logscale)
    assert [n for n, _ in module.named_parameters()] == list(init)
    np.testing.assert_array_equal(module.alpha.detach().numpy(), np.asarray(init["alpha"]))
    alpha = np.asarray(init["alpha"]) + 0.1 * np.random.default_rng(3).standard_normal(C).astype(np.float32)
    with torch.no_grad():
        module.alpha.copy_(torch.from_numpy(alpha))
        got = module(_cf(x)).transpose(1, 2)
    want = jmod.apply({"params": {"alpha": jnp.asarray(alpha)}}, jnp.asarray(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


# ---- resamplers -------------------------------------------------------------------


@pytest.mark.parametrize("ratio", [2, 3])
@pytest.mark.parametrize("kind", ["UpSample1d", "DownSample1d"])
def test_resampler_modules(kind, ratio):
    jmod = getattr(jax_resample, kind)(ratio)
    module = {"UpSample1d": UpSample1d, "DownSample1d": DownSample1d}[kind](ratio)
    assert (module.ratio, module.kernel_size) == (jmod.ratio, jmod.kernel_size)
    np.testing.assert_array_equal(module.filter.numpy(), np.asarray(jmod.filter))
    assert "filter" not in module.state_dict()
    x = _x(4 + ratio, t=6 * ratio * 4)
    want = jmod(jnp.asarray(x))
    got = module(_cf(x)).transpose(1, 2)
    assert got.shape == want.shape
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_resampler_explicit_kernel_size():
    assert UpSample1d(2, kernel_size=8).kernel_size == jax_resample.UpSample1d(2, kernel_size=8).kernel_size == 8
    assert DownSample1d(2).filter.shape == (12,)


# ---- the WaveNet diffusion-step pathway -------------------------------------------

RES, LAYERS, IN_CH, COND = 8, 3, 5, 4


def test_diffusion_embedding():
    """sin / cos of t * exp(-ln(1e4) / (half - 1) * k) for t up to 1000."""
    t = np.random.default_rng(5).uniform(0, 1000, size=7).astype(np.float32)
    want = jax_wavenet.diffusion_embedding(jnp.asarray(t), 16)
    got = port_wavenet.diffusion_embedding(torch.from_numpy(t), 16)
    assert got.shape == want.shape == (7, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _diffusion_pair(with_condition: bool, seed: int):
    kw = dict(input_channels=IN_CH, output_channels=IN_CH, residual_channels=RES, residual_layers=LAYERS,
              condition_channels=COND if with_condition else None)
    jnet = jax_wavenet.WaveNet(**kw, is_diffusion=True)
    args = [jnp.zeros((B, T, IN_CH)), jnp.zeros((B, T, COND)) if with_condition else None, jnp.zeros((B,))]
    params = init_params(jnet, seed, *args)
    sd = {}
    convert._wavenet(sd, "net", params)
    net = WaveNet(**kw, is_diffusion=True).eval()
    net.load_state_dict({k[len("net."):]: v for k, v in sd.items()})
    return jnet, params, net


@pytest.mark.parametrize("with_condition", [False, True], ids=["plain", "condition"])
def test_wavenet_diffusion_matches_jax(with_condition):
    jnet, params, net = _diffusion_pair(with_condition, seed=6)
    assert {"mlp_0", "mlp_1"} <= set(params) and "diffusion_projection" in params["layer_0"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, T, IN_CH)).astype(np.float32)
    cond = rng.standard_normal((B, T, COND)).astype(np.float32) if with_condition else None
    t = rng.uniform(0, 1000, size=B).astype(np.float32)
    want = jnet.apply({"params": params}, jnp.asarray(x), None if cond is None else jnp.asarray(cond),
                      jnp.asarray(t))
    with torch.no_grad():
        got = net(_cf(x), None if cond is None else _cf(cond), torch.from_numpy(t)).transpose(1, 2)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    with torch.no_grad():  # the step moves the output: the pathway is live
        assert not torch.allclose(net(_cf(x), None if cond is None else _cf(cond)).transpose(1, 2), got)


def test_wavenet_step_without_is_diffusion_raises():
    x = np.zeros((B, T, IN_CH), np.float32)
    t = np.full((B,), 3.0, np.float32)
    kw = dict(input_channels=IN_CH, residual_channels=RES, residual_layers=2)
    jnet = jax_wavenet.WaveNet(**kw)
    with pytest.raises(AssertionError, match="is_diffusion"):
        jnet.init(jax.random.PRNGKey(0), jnp.asarray(x), None, jnp.asarray(t))
    net = WaveNet(**kw)
    assert not any("mlp" in n or "diffusion" in n for n in net.state_dict())
    with pytest.raises(ValueError, match="is_diffusion"):
        net(_cf(x), None, torch.from_numpy(t))
