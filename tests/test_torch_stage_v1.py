"""The whole-stage kernel K2-v1's CPU side and the rest of the BigVGAN
serving surface: `stage_reference_v1` against the JAX `fused_amp_stage`
(its Pallas kernel in interpret mode) and the JAX oracle, the dispatch and
width rules of `amp_stage_v1`, the routes of `FusedBigVGAN`, `AMPBlock2`
and `resblock="2"` against JAX, the reference-checkpoint loaders, and the
K1 ablation probe's plain versions.

The CUDA kernels run only on the card; chip_smoke.py holds K2-v1 and the
probe against these plain versions there.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_codec_tpu.models.bigvgan import AMPBlock2 as JaxAMPBlock2
from dmel_codec_tpu.ops.stage_fused import StageSpec as JaxStageSpec
from dmel_codec_tpu.ops.stage_fused import fused_amp_stage as jax_fused_amp_stage
from dmel_codec_tpu.ops.stage_fused import stage_reference as jax_stage_reference
from dmel_codec_tpu_torch.convert import _act, _wn, bigvgan_state_dict_from_jax
from dmel_codec_tpu_torch.models import bigvgan
from dmel_codec_tpu_torch.models.bigvgan import AMPBlock2, BigVGAN, BigVGANConfig, FusedBigVGAN
from dmel_codec_tpu_torch.nn.snake import snake_beta
from dmel_codec_tpu_torch.ops import library, stage_fused
from dmel_codec_tpu_torch.ops.anti_alias import FILT, FILT_BF16, anti_alias_activation_reference
from dmel_codec_tpu_torch.ops.stage_fused import (
    V1_MAX_CHANNELS,
    StageSpec,
    amp_stage_v1,
    stage_reference,
    stage_reference_v1,
)
from dmel_codec_tpu_torch.probes import act_variants
from tests.test_torch_support import (  # noqa: F401  (strict_f32 is a fixture)
    JaxBigVGAN,
    JaxBigVGANConfig,
    VOCODER_KW,
    init_params,
    strict_f32,
    to_np,
)

pytestmark = pytest.mark.usefixtures("strict_f32")


def _packed(c: int, seed: int):
    """`pack_stage`-shaped arrays from a numpy seed, for JAX and the port."""
    rng = np.random.default_rng(seed)
    arrays = {
        "w": [(rng.standard_normal((k, c, c)) / np.sqrt(k * c)).astype(np.float32)
              for k in (3, 7, 11) for _ in range(6)],
        "b": (0.05 * rng.standard_normal((c, 18))).astype(np.float32),
        "a": np.exp(0.05 * rng.standard_normal((c, 18))).astype(np.float32),
        "ib": (1.0 / (np.exp(0.05 * rng.standard_normal((c, 18))) + 1e-9)).astype(np.float32),
    }
    as_jax = {"w": [jnp.asarray(w) for w in arrays["w"]], **{k: jnp.asarray(arrays[k]) for k in ("b", "a", "ib")}}
    as_torch = {"w": [torch.from_numpy(w) for w in arrays["w"]],
                **{k: torch.from_numpy(arrays[k]) for k in ("b", "a", "ib")}}
    return as_jax, as_torch


def _port_v1(x: np.ndarray, packed: dict, c: int, dtype=torch.float32) -> np.ndarray:
    xt = torch.from_numpy(x).to(dtype).transpose(1, 2).contiguous()
    return to_np(amp_stage_v1(xt, packed, StageSpec(channels=c)).float().transpose(1, 2))


# (C, T, dtype): the sizes of tests/test_stage_fused.py's v1 cases, where
# `fused_amp_stage` takes its Pallas kernel (T >= tile + 128).
@pytest.mark.parametrize("c,t,dtype", [(24, 2000, "f32"), (96, 2048, "f32"), (24, 2000, "bf16")])
def test_plain_v1_matches_jax_interpret_kernel(c, t, dtype):
    """float32: 1e-5 abs at outputs up to ~10 (36 chained float32 ops in
    another order; the kernel's polynomial sin is within 1.5e-6 of sin).
    bfloat16: both sides round the conv operands to bf16 and the result
    once; a value next to a rounding boundary may round the other way: one
    bf16 ulp of the largest output, 2^-7 max |out|."""
    jp, tp = _packed(c, seed=c)
    x = np.random.default_rng(t).standard_normal((2, t, c)).astype(np.float32)
    spec = JaxStageSpec(channels=c)
    if dtype == "f32":
        want = np.asarray(jax_fused_amp_stage(jnp.asarray(x), jp, spec, interpret=True, tile_w=512))
        np.testing.assert_allclose(_port_v1(x, tp, c), want, atol=1e-5)
        oracle = np.asarray(jax_stage_reference(jnp.asarray(x), jp, spec))
        np.testing.assert_allclose(_port_v1(x, tp, c), oracle, atol=1e-5)
    else:
        want = jax_fused_amp_stage(jnp.asarray(x).astype(jnp.bfloat16), jp, spec, interpret=True, tile_w=512)
        want = np.asarray(want.astype(jnp.float32))
        got = _port_v1(x, tp, c, torch.bfloat16)
        assert np.abs(got - want).max() <= 2.0**-7 * np.abs(want).max()


def test_plain_v1_rounds_only_the_conv_operands():
    """float32: both plain versions are the same function. bfloat16: v1
    keeps the planes float32, so it lies closer to the float32 result than
    K2's contract does."""
    _, tp = _packed(8, seed=1)
    spec = StageSpec(channels=8)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 8, 300)).astype(np.float32))
    exact = stage_reference_v1(x, tp, spec)
    torch.testing.assert_close(exact, stage_reference(x, tp, spec), rtol=0, atol=0)
    err_v1 = (stage_reference_v1(x.bfloat16(), tp, spec).float() - exact).abs().mean()
    err_v2 = (stage_reference(x.bfloat16(), tp, spec).float() - exact).abs().mean()
    assert 0 < err_v1 < err_v2


def test_stage_spec_reach():
    spec = StageSpec(channels=24)
    assert spec.receptive == JaxStageSpec(channels=24).receptive == 96
    assert spec.conv_reach == 25
    assert StageSpec(8, (3,), ((1, 2),)).receptive == (6 + 1 + 6 + 1) + (6 + 2 + 6 + 1)


def test_v1_tile_fills_shared_memory():
    """The float32 block's planes, conv input and weight slots at the
    chosen tile fit 227 KB, and one more group of 256 columns would not
    (or its warpgroups could not hold the tiles' sums); C = 96 does not
    fit at all."""
    smem = 227 * 1024  # what the library reports on sm_90
    for c, want in ((48, (48, 48, 256, 2)), (24, (24, 24, 512, 4)), (5, (24, 8, 1024, 4))):
        spec = StageSpec(channels=c)
        n, kp, w, slots = stage_fused.v1_tf32_plan(c, spec, smem)
        assert (n, kp, w, slots) == want
        assert stage_fused.v1_tf32_bytes(c, kp, n, w, slots) <= smem
        assert w == 1024 or w // 256 == stage_fused._V1_TF32_TILES[n] or \
            stage_fused.v1_tf32_bytes(c, kp, n, w + 256, 2) > smem
    assert stage_fused.v1_tf32_plan(96, StageSpec(channels=96), smem)[2] == 0  # does not fit


def test_v1_dispatch(monkeypatch, tmp_path):
    """A CPU tensor takes the plain version without touching the library;
    any other tensor goes to the kernel or raises: too wide a stage by its
    width, a narrow one (no nvcc here) by the missing build."""
    assert V1_MAX_CHANNELS == 48
    _, tp = _packed(8, seed=3)
    spec = StageSpec(channels=8)
    x = torch.randn(2, 8, 50)
    with monkeypatch.context() as m:
        m.setattr(library, "load", lambda: pytest.fail("a CPU tensor must not reach the kernel library"))
        n = amp_stage_v1.launches
        torch.testing.assert_close(amp_stage_v1(x, tp, spec), stage_reference_v1(x, tp, spec), rtol=0, atol=0)
        assert amp_stage_v1.launches == n
    monkeypatch.setattr(library, "find_nvcc", lambda: None)
    monkeypatch.setattr(library, "BUILD_DIR", tmp_path)
    library.load.cache_clear()
    with pytest.raises(ValueError, match="at most 48 channels, got 96"):
        amp_stage_v1(torch.empty(1, 96, 50, device="meta"), tp, StageSpec(channels=96))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        amp_stage_v1(torch.empty(2, 8, 50, device="meta"), tp, spec)
    library.load.cache_clear()


def test_fused_routes_are_fixed_at_construction():
    """The flagship widths 768 .. 24, built without storage: with
    `use_v2=False` every fused stage runs the v1 contract, K2-v1 the stages
    it can hold and K2 in v1 mode ("K2/v1") the wider ones; a resblock "2"
    model fuses nothing."""
    with torch.device("meta"):
        model = BigVGAN(BigVGANConfig())
        model2 = BigVGAN(BigVGANConfig(resblock="2"))
    assert FusedBigVGAN(model).routes == ["block", "block", "K2", "K2", "K2", "K2"]
    assert FusedBigVGAN(model, use_v2=False).routes == ["block", "block", "K2/v1", "K2/v1", "K2-v1", "K2-v1"]
    assert FusedBigVGAN(model, fuse_max_channels=24, use_v2=False).routes == ["block"] * 5 + ["K2-v1"]
    assert FusedBigVGAN(model2, use_v2=False).routes == ["block"] * 6


def test_fused_v1_bf16_matches_jax_v1_at_a_wide_stage(monkeypatch):
    """`FusedBigVGAN(use_v2=False)` in bf16 against `bigvgan_apply_fused(...,
    use_v2=False, interpret=True)` on a one-stage vocoder whose fused stage
    (C = 64) is wider than K2-v1 takes: the port's route is K2 in v1 mode,
    the JAX package's the v1 Pallas kernel. The stage is held against the
    JAX stage on the JAX stage's own input and packed weights (recorded by a
    wrapper around `fused_amp_stage`): the whole bf16 waveform differs
    between the packages by ~4e-2 of max |out| already with no stage fused
    (XLA's bf16 convs round elsewhere), and the JAX `pack_stage` exps alpha
    and beta in bf16 where the port's does in float32, either of which
    would hide the contract.

    Both sides round the same conv operands and the result from float32
    values that differ only in summation order: one bf16 ulp of the largest
    output at most (2^-7 max |out|), and most outputs the same bits
    (measured ~0.74). K2's v2 contract rounds 36 planes more: 0.31 of the
    outputs equal the JAX bits, so the test tells the contracts apart; it
    fails on a tree that routes this stage to the v2 contract."""
    import dmel_codec_tpu.ops.stage_fused as jax_stage_fused
    from dmel_codec_tpu.models.bigvgan import bigvgan_apply_fused

    kw = dict(num_mels=20, upsample_initial_channel=128, upsample_rates=(2,), upsample_kernel_sizes=(4,))
    jparams = init_params(JaxBigVGAN(config=JaxBigVGANConfig(**kw)), 11, jnp.zeros((1, 8, kw["num_mels"])))
    cfg = BigVGANConfig(**kw)
    port = BigVGAN(cfg)
    port.load_state_dict(bigvgan_state_dict_from_jax(jparams, cfg))
    fused = FusedBigVGAN(port.eval().to(torch.bfloat16), use_v2=False)
    assert fused.routes == ["K2/v1"]

    seen = []
    real = jax_stage_fused.fused_amp_stage

    def recording(x, packed, *args, **kwargs):
        y = real(x, packed, *args, **kwargs)
        seen.append((x, packed, y))
        return y

    monkeypatch.setattr(jax_stage_fused, "fused_amp_stage", recording)
    mel = (0.3 * np.random.default_rng(5).standard_normal((1, 256, kw["num_mels"]))).astype(np.float32)
    bigvgan_apply_fused(jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jparams),
                        jnp.asarray(mel).astype(jnp.bfloat16), JaxBigVGANConfig(**kw),
                        use_v2=False, interpret=True, tile_w=128)
    (x, packed, want), = seen
    spec, _ = fused.stages[0]
    fused.stages[0] = (spec, {"w": [torch.from_numpy(np.array(w.astype(jnp.float32))).bfloat16() for w in packed["w"]],
                              **{k: torch.from_numpy(np.array(packed[k])) for k in ("b", "a", "ib")}})
    x = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16().transpose(1, 2).contiguous()
    got = to_np(fused.resblocks(0, x).float().transpose(1, 2))
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape == (1, 512, 64)
    assert np.abs(got - want).max() <= 2.0**-7 * np.abs(want).max()
    assert (got == want).mean() >= 0.5


def test_fused_v1_bf16_own_packing_matches_jax_v1(monkeypatch):
    """The test above with the port's own packing: `FusedBigVGAN(use_v2=
    False)` on the bf16 model packs its stage itself, and that packing is
    the JAX `pack_stage`'s to the bit (w, b, a, ib), so the stage holds
    against the JAX v1 stage on the JAX stage's input under the same bound:
    one bf16 ulp of the largest output, at least half the outputs the same
    bits."""
    import dmel_codec_tpu.ops.stage_fused as jax_stage_fused
    from dmel_codec_tpu.models.bigvgan import bigvgan_apply_fused

    kw = dict(num_mels=20, upsample_initial_channel=128, upsample_rates=(2,), upsample_kernel_sizes=(4,))
    jparams = init_params(JaxBigVGAN(config=JaxBigVGANConfig(**kw)), 11, jnp.zeros((1, 8, kw["num_mels"])))
    cfg = BigVGANConfig(**kw)
    port = BigVGAN(cfg)
    port.load_state_dict(bigvgan_state_dict_from_jax(jparams, cfg))
    fused = FusedBigVGAN(port.eval().to(torch.bfloat16), use_v2=False)
    assert fused.routes == ["K2/v1"]

    seen = []
    real = jax_stage_fused.fused_amp_stage

    def recording(x, packed, *args, **kwargs):
        y = real(x, packed, *args, **kwargs)
        seen.append((x, packed, y))
        return y

    monkeypatch.setattr(jax_stage_fused, "fused_amp_stage", recording)
    mel = (0.3 * np.random.default_rng(5).standard_normal((1, 256, kw["num_mels"]))).astype(np.float32)
    bigvgan_apply_fused(jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jparams),
                        jnp.asarray(mel).astype(jnp.bfloat16), JaxBigVGANConfig(**kw),
                        use_v2=False, interpret=True, tile_w=128)
    (x, packed, want), = seen
    _, own = fused.stages[0]
    for got_w, want_w in zip(own["w"], packed["w"], strict=True):
        assert got_w.dtype == torch.bfloat16
        np.testing.assert_array_equal(to_np(got_w.float()), np.asarray(want_w.astype(jnp.float32)))
    for key in ("b", "a", "ib"):
        np.testing.assert_array_equal(to_np(own[key]), np.asarray(packed[key]))
    x = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16().transpose(1, 2).contiguous()
    got = to_np(fused.resblocks(0, x).float().transpose(1, 2))
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape == (1, 512, 64)
    assert np.abs(got - want).max() <= 2.0**-7 * np.abs(want).max()
    assert (got == want).mean() >= 0.5


@pytest.mark.parametrize("dtype,v1", [(torch.bfloat16, True), (torch.bfloat16, False), (torch.float32, True)])
def test_k2_v1_mode_dispatch(monkeypatch, dtype, v1):
    """K2's 18 launches with a recording library: on bf16 every launch
    takes the tensor-core kernel, whose operands are bf16 either way; v1
    mode keeps the planes, the taps and v float32 (plane_bf16 = 0) and t1
    (the output of each pair's first launch, the input of its second)
    float32; v2 rounds the planes, takes bf16 taps and keeps t1 in bf16;
    float32 takes the split-TF32 kernel, which rounds nothing."""
    calls = []

    class Lib:
        def dmel_act_conv_tf32(self, *args):
            calls.append(("act_conv_tf32_kernel", args))
            return 0

        def dmel_act_conv_tc(self, *args):
            calls.append(("act_conv_tc_kernel", args))
            return 0

    monkeypatch.setattr(library, "load", lambda: Lib())
    monkeypatch.setattr(library, "check_plane", lambda x, name="x": None)
    monkeypatch.setattr(library, "stream", lambda x: 0)
    _, tp = _packed(8, seed=4)
    n = stage_fused.amp_stage.launches
    stage_fused._run_kernel(torch.zeros((1, 8, 50), dtype=dtype), tp, StageSpec(channels=8), v1=v1)
    assert stage_fused.amp_stage.launches == n + 18 and len(calls) == 18
    if dtype == torch.float32:
        assert {kernel for kernel, _ in calls} == {"act_conv_tf32_kernel"}
        return
    # positions in dmel_act_conv_tc's argument list
    src_bf16, out_bf16, plane_bf16, taps = 1, 15, 17, 23
    t1_bf16 = int(not v1)
    for i, (kernel, args) in enumerate(calls):
        assert kernel == "act_conv_tc_kernel" and args[plane_bf16] == (0 if v1 else 1)
        assert list(args[taps]) == (FILT if v1 else FILT_BF16).tolist()
        if i % 2 == 0:  # t1 = conv(act(xb))
            assert args[out_bf16] == t1_bf16
        else:  # reads t1
            assert args[src_bf16] == t1_bf16


# ---- AMPBlock2 ----------------------------------------------------------------


def test_amp_block2_matches_jax():
    """One resblock: 3 activations + 3 dilated convs, 1e-5 abs."""
    c, k, dil = 6, 7, (1, 3, 5)
    jblock = JaxAMPBlock2(channels=c, kernel_size=k, dilation=dil, activation="snakebeta", logscale=True)
    params = init_params(jblock, 4, jnp.zeros((1, 16, c)))
    x = np.random.default_rng(5).standard_normal((2, 90, c)).astype(np.float32)
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    block = AMPBlock2(c, k, dil, "snakebeta", True)
    state = {}
    for j in range(3):
        _wn(state, f"convs.{j}", params[f"conv_{j}"], transposed=False)
        _act(state, f"activations.{j}", params[f"act_{j}"])
    block.load_state_dict(state)
    with torch.no_grad():
        got = block(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(to_np(got), want, atol=1e-5)


def test_bigvgan_resblock2_matches_jax():
    """The whole resblock "2" vocoder through `convert.py`, module and
    serving form (which fuses nothing of it): 1e-4 abs, as the resblock "1"
    slice test."""
    kw = dict(VOCODER_KW, resblock="2")
    jmodel = JaxBigVGAN(config=JaxBigVGANConfig(**kw))
    params = init_params(jmodel, 6, jnp.zeros((1, 8, kw["num_mels"])))
    cfg = BigVGANConfig(**kw)
    port = BigVGAN(cfg)
    port.load_state_dict(bigvgan_state_dict_from_jax(params, cfg))
    port.eval()
    mel = np.random.default_rng(7).standard_normal((2, 32, kw["num_mels"])).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(mel)))
    with torch.no_grad():
        got = port(torch.from_numpy(mel))
    assert 0.01 < np.abs(want).mean()
    np.testing.assert_allclose(to_np(got), want, atol=1e-4)
    fused = FusedBigVGAN(port, use_v2=False)
    assert fused.routes == ["block", "block"]
    np.testing.assert_allclose(to_np(fused(torch.from_numpy(mel))), want, atol=1e-4)


# ---- the reference's checkpoint format ------------------------------------------


def _reference_state_dict(model: BigVGAN, parametrized: bool, wrap: bool) -> dict:
    """`model`'s weights as the reference generator saves them: either
    weight-norm key form, and the activations' persistent filter buffers."""
    sd = {}
    for key, value in model.state_dict().items():
        if parametrized:
            key = key.replace(".weight_g", ".parametrizations.weight.original0")
            key = key.replace(".weight_v", ".parametrizations.weight.original1")
        sd[key] = value.clone()
    for key in list(sd):
        if key.endswith(".act.alpha"):
            prefix = key[: -len(".act.alpha")]
            sd[f"{prefix}.upsample.filter"] = torch.ones(1, 1, 12)
            sd[f"{prefix}.downsample.lowpass.filter"] = torch.ones(1, 1, 12)
    return {"generator": sd} if wrap else sd


@pytest.mark.parametrize("parametrized,wrap", [(False, True), (True, False), (True, True)])
@pytest.mark.parametrize("resblock", ["1", "2"])
def test_load_torch_checkpoint_and_from_pretrained(tmp_path, resblock, parametrized, wrap):
    torch.manual_seed(0)
    cfg = BigVGANConfig(**dict(VOCODER_KW, resblock=resblock), use_tanh_at_final=True)
    src = BigVGAN(cfg).eval()
    torch.save(_reference_state_dict(src, parametrized, wrap), tmp_path / "bigvgan_generator.pt")
    (tmp_path / "config.json").write_text(json.dumps({
        "num_mels": cfg.num_mels, "upsample_rates": list(cfg.upsample_rates),
        "upsample_kernel_sizes": list(cfg.upsample_kernel_sizes),
        "upsample_initial_channel": cfg.upsample_initial_channel, "resblock": resblock,
        "resblock_kernel_sizes": list(cfg.resblock_kernel_sizes),
        "resblock_dilation_sizes": [list(d) for d in cfg.resblock_dilation_sizes],
        "activation": cfg.activation, "snake_logscale": cfg.snake_logscale,
        "use_bias_at_final": False, "sampling_rate": 24000,
    }))
    mel = torch.randn(1, 16, cfg.num_mels)
    with torch.no_grad():
        want = src(mel)
        for loaded in (bigvgan.load_torch_checkpoint(str(tmp_path / "bigvgan_generator.pt"), cfg),
                       bigvgan.from_pretrained(str(tmp_path))):
            assert loaded.config == cfg and not loaded.training  # use_tanh_at_final defaults to True
            torch.testing.assert_close(loaded(mel), want, rtol=0, atol=0)


def test_loaders_are_strict_and_local(tmp_path):
    cfg = BigVGANConfig(**VOCODER_KW)
    sd = _reference_state_dict(BigVGAN(cfg), parametrized=False, wrap=False)
    torch.save({**sd, "conv_pre.extra": torch.zeros(1)}, tmp_path / "extra.pt")
    with pytest.raises(RuntimeError, match="conv_pre.extra"):
        bigvgan.load_torch_checkpoint(str(tmp_path / "extra.pt"), cfg)
    del sd["conv_post.weight_g"]
    torch.save(sd, tmp_path / "missing.pt")
    with pytest.raises(RuntimeError, match="conv_post.weight_g"):
        bigvgan.load_torch_checkpoint(str(tmp_path / "missing.pt"), cfg)
    # a hub id missing from the cache raises under local_files_only: nothing is downloaded
    with pytest.raises(FileNotFoundError):
        bigvgan.from_pretrained(
            "nvidia/bigvgan_v2_24khz_100band_256x", cache_dir=str(tmp_path / "hub"), local_files_only=True
        )


# ---- the K1 ablation probe's plain versions ----------------------------------------


@pytest.mark.parametrize("with_beta", [True, False])
def test_probe_variant_identities(monkeypatch, with_beta):
    monkeypatch.setattr(library, "load", lambda: pytest.fail("a CPU tensor must not reach the kernel library"))
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 6, 75)).astype(np.float32))
    alpha = torch.from_numpy((0.3 * rng.standard_normal(6)).astype(np.float32))
    beta = torch.from_numpy((0.3 * rng.standard_normal(6)).astype(np.float32)) if with_beta else None
    out = {v: act_variants.run_variant(x, alpha, beta, v) for v in act_variants.VARIANTS}
    torch.testing.assert_close(out["full"], anti_alias_activation_reference(x, alpha, beta, True), rtol=0, atol=0)
    torch.testing.assert_close(out["no_fir"], snake_beta(x, alpha, beta, True), rtol=0, atol=0)
    torch.testing.assert_close(out["copy"], x, rtol=0, atol=0)
    # up then down through the half-band filter pair: a lowpass that keeps a constant
    const = torch.full((1, 6, 40), 0.7)
    torch.testing.assert_close(act_variants.run_variant(const, alpha, beta, "no_snake"), const, rtol=0, atol=1e-6)
    assert out["no_snake"].shape == x.shape and (out["no_snake"] - x).abs().max() < x.abs().max()
    assert act_variants.run_variant(x.bfloat16(), alpha, beta, "full").dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown variant"):
        act_variants.run_variant(x, alpha, beta, "dma-only")
