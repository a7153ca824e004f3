"""The port's slow-fast LM modules against the JAX package at a small size.

Same pattern as tests/test_torch_support.py: parameter shapes from
`jax.eval_shape` of the flax `init`, values from a numpy seed, carried over
with `dmel_codec_tpu_torch.convert`; inputs from numpy with a seed; float32
on the CPU, TF32 off, torch pinned to one thread. Sizes are the JAX tests'
TINY_LM (2 + 2 layers, hidden 32 / 24, the real vocabularies).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_codec_tpu.cli.common import build_lm_config as jax_build_lm_config
from dmel_codec_tpu.lm import inputs as jax_inputs
from dmel_codec_tpu.lm import sampling as jax_sampling
from dmel_codec_tpu.lm.generate import InferenceConfig as JaxInferenceConfig
from dmel_codec_tpu.lm.tokenizer import ByteTokenizer as JaxByteTokenizer
from dmel_codec_tpu.models import lm as jax_lm
from dmel_codec_tpu.models import transformer as jax_tf
from dmel_codec_tpu.utils import config as jax_config
from dmel_codec_tpu_torch.cli.common import build_lm_config
from dmel_codec_tpu_torch.convert import decoder_state_dict_from_jax, lm_state_dict_from_jax
from dmel_codec_tpu_torch.lm import inputs as port_inputs
from dmel_codec_tpu_torch.lm import sampling as port_sampling
from dmel_codec_tpu_torch.lm.generate import InferenceConfig
from dmel_codec_tpu_torch.lm.tokenizer import ByteTokenizer
from dmel_codec_tpu_torch.models import lm as port_lm
from dmel_codec_tpu_torch.models import transformer as port_tf
from dmel_codec_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference
from dmel_codec_tpu_torch.utils import config as port_config
from tests.test_torch_support import strict_f32, to_np  # noqa: F401  (strict_f32 is a fixture)

pytestmark = pytest.mark.usefixtures("strict_f32")

SLOW_KW = dict(vocab_size=151936, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4, num_kv_heads=2)
FAST_KW = dict(vocab_size=1800, hidden_size=24, intermediate_size=48, num_layers=2, num_heads=4, num_kv_heads=2)
JAX_TINY = jax_lm.SlowFastLMConfig(
    slow=jax_tf.TransformerConfig(**SLOW_KW), fast=jax_tf.TransformerConfig(**FAST_KW), text_weight=0.01
)
PORT_TINY = port_lm.SlowFastLMConfig(
    slow=port_tf.TransformerConfig(**SLOW_KW), fast=port_tf.TransformerConfig(**FAST_KW), text_weight=0.01
)
# float32 on both sides, sums in another order: a few ulps per op over 2-4 layers
TOL = dict(atol=2e-5, rtol=1e-4)


def fill_tree(shapes, seed: int):
    """A parameter tree of the given shapes from a numpy seed: kernels
    lecun-normal, embedding tables N(0, 1), norm scales 1 + 0.05 N(0, 1),
    biases 0.05 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        shape, name = leaf.shape, path[-1].key
        if name == "embedding":
            return rng.standard_normal(shape).astype(np.float32)
        if len(shape) >= 2:
            return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        base = 1.0 if name == "weight" else 0.0
        return (base + 0.05 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def module_params(module, seed: int, *args, **kwargs):
    return fill_tree(jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))["params"], seed)


def lm_params(seed: int = 0):
    """The full ChatMusicLM tree (the training forward and `embed_inputs`
    together touch every parameter)."""
    model = jax_lm.ChatMusicLM(config=JAX_TINY)
    c, hs = JAX_TINY.audio_codebook_count, JAX_TINY.slow.hidden_size

    def init():
        key = jax.random.PRNGKey(0)
        main = model.init(key, jnp.zeros((1, 4, hs)), jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 4, c), jnp.int32))
        emb = model.init(
            key, jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 4, c), jnp.int32),
            method=jax_lm.ChatMusicLM.embed_inputs,
        )
        return emb["params"] | main["params"]

    return fill_tree(jax.eval_shape(init), seed)


def build_lm(seed: int = 0, params=None):
    """(jax model, jax params, port model) on the same weights."""
    params = lm_params(seed) if params is None else params
    port = port_lm.ChatMusicLM(PORT_TINY)
    port.load_state_dict(lm_state_dict_from_jax(params, PORT_TINY))
    return jax_lm.ChatMusicLM(config=JAX_TINY), params, port.eval()


def build_decoder(seed: int = 0, **cfg_kw):
    jcfg = jax_tf.TransformerConfig(**SLOW_KW)
    params = module_params(jax_tf.Decoder(jcfg), seed, jnp.zeros((1, 4, jcfg.hidden_size)))
    port = port_tf.Decoder(port_tf.TransformerConfig(**SLOW_KW, **cfg_kw))
    port.load_state_dict(decoder_state_dict_from_jax(params, jcfg.num_layers))
    return jax_tf.Decoder(jcfg), params, port.eval()


@pytest.fixture(scope="module")
def lm():
    return build_lm()


@pytest.fixture(scope="module")
def decoder():
    return build_decoder()


def _embeds(b, s, h, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, h)).astype(np.float32)


def _apply(model, params, *args, method=None):
    return jax.jit(lambda p, *a: model.apply({"params": p}, *a, method=method))(params, *args)


# ---- configs ---------------------------------------------------------------


# The port's decoder kind beyond the JAX package's one
# (models/deepseek_v3.py): fields the JAX TransformerConfig has not, whose
# defaults leave the qwen2 kind.
PORT_ONLY = {"kind": "qwen2", "kv_lora_rank": 0, "qk_nope_head_dim": 0, "qk_rope_head_dim": 0, "v_head_dim": 0,
             "n_routed_experts": 0, "num_experts_per_tok": 0, "moe_intermediate_size": 0, "n_shared_experts": 0,
             "first_k_dense_replace": 0, "routed_scaling_factor": 1.0, "experts_held": 0, "expert_offset": 0,
             "kda_layers": (), "kda_num_heads": 0, "kda_head_dim": 0, "kda_conv_size": 0, "layer_pattern": "",
             "mamba_num_heads": 0, "mamba_head_dim": 0, "ssm_state_size": 0, "mamba_n_groups": 0,
             "mamba_conv_kernel": 0, "attention_head_dim": 0, "mlp_hidden_act": "silu",
             "shared_expert_intermediate_size": 0}


def test_configs_mirror_the_jax_defaults():
    """Every field of the port's configs has the JAX default, but the
    DeepSeek-V3, Kimi Linear and Nemotron-H kinds' fields and the expert share's, which
    the JAX package has not (PORT_ONLY, at the defaults that make the qwen2
    kind); the JAX TransformerConfig's one
    extra field (`scan_layers`) is an XLA device."""
    jt = dataclasses.asdict(jax_tf.SLOW_LM_CONFIG)
    for port_cfg, jax_cfg in ((port_tf.SLOW_LM_CONFIG, jt), (port_tf.FAST_LM_CONFIG, dataclasses.asdict(jax_tf.FAST_LM_CONFIG))):
        pt = dataclasses.asdict(port_cfg)
        assert {k: pt[k] for k in PORT_ONLY} == PORT_ONLY and not set(PORT_ONLY) & set(jax_cfg)
        assert {k: jax_cfg[k] for k in pt if k not in PORT_ONLY} == {k: v for k, v in pt.items() if k not in PORT_ONLY}
    assert set(jt) - set(dataclasses.asdict(port_tf.SLOW_LM_CONFIG)) == {"scan_layers"}
    jl, pl_ = dataclasses.asdict(jax_lm.SlowFastLMConfig()), dataclasses.asdict(port_lm.SlowFastLMConfig())
    for k, v in pl_.items():
        if k not in ("slow", "fast"):
            assert jl[k] == v, k
    assert set(jl) == set(pl_)
    assert dataclasses.asdict(InferenceConfig()) == dataclasses.asdict(JaxInferenceConfig())
    np.testing.assert_array_equal(
        port_lm.SlowFastLMConfig().codebook_shift, np.asarray(jax_lm.SlowFastLMConfig().codebook_shift)
    )


def test_yaml_config_copy(tmp_path):
    """The copied config loader reads the repo's LM inference YAML, a
    `defaults:` merge and an interpolation as the JAX package's does."""
    path = str(Path(__file__).resolve().parents[1] / "configs" / "lm_infer.yaml")
    cfg = port_config.load_yaml(path)
    assert cfg == jax_config.load_yaml(path)
    assert dataclasses.asdict(port_config.dataclass_from_dict(InferenceConfig, cfg["inference"])) == dataclasses.asdict(
        jax_config.dataclass_from_dict(JaxInferenceConfig, cfg["inference"])
    )
    (tmp_path / "base.yaml").write_text("a: {x: 1, y: [1, 2]}\nname: base\n")
    (tmp_path / "top.yaml").write_text("defaults: [base.yaml, _self_]\na: {x: 2}\nalias: ${name}\n")
    got = port_config.load_yaml(str(tmp_path / "top.yaml"))
    assert got == jax_config.load_yaml(str(tmp_path / "top.yaml")) == {"a": {"x": 2, "y": [1, 2]}, "name": "base", "alias": "base"}
    with pytest.raises(KeyError):
        port_config.dataclass_from_dict(InferenceConfig, {"no_such_key": 1})
    over = {"slow_lm": {"hidden_size": 32, "num_layers": 2}, "fast_lm": {"num_heads": 4}, "text_weight": 0.5}
    assert dataclasses.asdict(build_lm_config(over)).items() >= {
        k: v for k, v in dataclasses.asdict(jax_build_lm_config(over)).items() if k not in ("slow", "fast")
    }.items()
    assert build_lm_config(over).slow.hidden_size == 32 and build_lm_config(over).fast.num_heads == 4


# ---- transformer pieces ------------------------------------------------------


def test_rmsnorm():
    """float32 both sides: 1e-6."""
    x = _embeds(2, 5, 32, seed=1) * 3.0
    jm = jax_tf.RMSNorm(1e-6)
    params = module_params(jm, 2, jnp.zeros((1, 1, 32)))
    want = jm.apply({"params": params}, jnp.asarray(x))
    pm = port_tf.RMSNorm(32, 1e-6)
    pm.load_state_dict({"weight": torch.from_numpy(np.asarray(params["weight"]))})
    np.testing.assert_allclose(to_np(pm(torch.from_numpy(x))), np.asarray(want), atol=1e-6, rtol=1e-6)
    got16 = pm(torch.from_numpy(x).bfloat16())
    assert got16.dtype == torch.bfloat16  # float32 inside, input dtype out


@pytest.mark.parametrize("head_dim", [8, 64, 48])
def test_rope(head_dim):
    """cos/sin to 1e-6 abs at positions up to 4095 (float32 angles, two
    libms); the rotation to 1e-6 on the same cos/sin."""
    pos = np.stack([np.arange(7), np.array([0, 5, 100, 1000, 2047, 4000, 4095])])
    jc, js = jax_tf.rope_cos_sin(jnp.asarray(pos), head_dim, 1e6)
    pc, ps = port_tf.rope_cos_sin(torch.from_numpy(pos), head_dim, 1e6)
    assert pc.shape == (2, 7, head_dim)
    np.testing.assert_allclose(to_np(pc), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(to_np(ps), np.asarray(js), atol=1e-6)
    x = np.random.default_rng(3).standard_normal((2, 7, 3, head_dim)).astype(np.float32)
    want = jax_tf.apply_rope(jnp.asarray(x), jc, js)
    got = port_tf.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(jc)), torch.from_numpy(np.array(js)))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-6)


def _attention_pair(seed=4, **cfg_kw):
    jcfg = jax_tf.TransformerConfig(**SLOW_KW)
    jm = jax_tf.Attention(jcfg)
    hd = jcfg.head_dim
    params = module_params(
        jm, seed, jnp.zeros((1, 2, 32)), jnp.zeros((1, 2, hd)), jnp.zeros((1, 2, hd)), jnp.ones((1, 2, 2), bool)
    )
    pm = port_tf.Attention(port_tf.TransformerConfig(**SLOW_KW, **cfg_kw))
    sd = {}
    for name, p in params.items():
        sd[f"{name}.weight"] = torch.from_numpy(np.asarray(p["kernel"]).T.copy())
        if "bias" in p:
            sd[f"{name}.bias"] = torch.from_numpy(np.asarray(p["bias"]))
    pm.load_state_dict(sd)
    return jm, params, pm.eval()


def _attention_inputs(b, s, seed=5):
    x = _embeds(b, s, 32, seed)
    pos = np.broadcast_to(np.arange(s), (b, s))
    cos, sin = jax_tf.rope_cos_sin(jnp.asarray(pos), 8, 1e6)
    return x, np.array(cos), np.array(sin)


def test_attention_with_a_callers_mask():
    """GQA einsum path under a non-causal mask (position 0 always visible)."""
    jm, params, pm = _attention_pair()
    b, s = 2, 9
    x, cos, sin = _attention_inputs(b, s)
    mask = np.random.default_rng(6).random((b, s, s)) < 0.5
    mask[:, :, 0] = True
    want, _ = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(mask))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin), torch.from_numpy(mask))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("s,min_seq", [(512, 512), (137, 16)])
def test_flash_plain_version_vs_jax_attention(s, min_seq):
    """The flash kernel's plain version (what `flash_attention` runs on a
    CPU tensor) inside the port's Attention against the JAX Attention's
    einsum path, at the dispatch threshold and at a ragged length. jax's
    TPU flash kernel cannot run on a CPU, so the einsum path is its
    reference on the JAX side too."""
    jm, params, pm = _attention_pair(flash_attention=True, flash_min_seq=min_seq)
    x, cos, sin = _attention_inputs(2, s)
    causal = np.broadcast_to(np.tril(np.ones((s, s), bool)), (2, s, s))
    want, _ = _apply(jm, params, jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(causal))
    before = flash_attention.launches
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin), None, mask_is_causal=True)
    assert flash_attention.launches == before  # a CPU tensor never counts as a kernel launch
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [(2, 70, 14, 2, 64), (1, 33, 10, 2, 48), (1, 1, 4, 4, 16)])
def test_flash_plain_version_is_causal_gqa_softmax(shape):
    """Against a loop over heads written from the definition, float64."""
    b, s, h, kh, hd = shape
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((b, s, n, hd)).astype(np.float32) for n in (h, kh, kh))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert got.shape == (b, s, h, hd) and got.dtype == torch.float32
    want = np.zeros((b, s, h, hd))
    for head in range(h):
        kk, vv = k[:, :, head // (h // kh)].astype(np.float64), v[:, :, head // (h // kh)].astype(np.float64)
        sc = np.einsum("bsd,btd->bst", q[:, :, head].astype(np.float64), kk) / np.sqrt(hd)
        sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
        p = np.exp(sc - sc.max(-1, keepdims=True))
        want[:, :, head] = np.einsum("bst,btd->bsd", p / p.sum(-1, keepdims=True), vv)
    np.testing.assert_allclose(to_np(got), want, atol=2e-6)
    got16 = flash_attention_reference(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got16.dtype == torch.bfloat16


def test_flash_backward_differentiates_the_plain_version():
    """On the CPU the gradient comes from the backward kernels' plain version
    (`flash_attention_backward_reference`; tests/test_torch_train_fa.py holds
    it against autograd and against the JAX package's backward kernels)."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 6, n, 16)).astype(np.float32)).requires_grad_() for n in (4, 2, 2))
    flash_attention(q, k, v).square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() and t.grad.abs().sum() > 0 for t in (q, k, v))


def test_decoder_cacheless(decoder):
    jm, params, pm = decoder
    x = _embeds(2, 12, 32, seed=9)
    want, _ = _apply(jm, params, jnp.asarray(x))
    with torch.no_grad():
        got, cache = pm(torch.from_numpy(x))
    assert cache is None
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_decoder_flash_on_equals_off(decoder):
    """Same weights, `flash_attention=True` (plain version on the CPU)
    against the einsum path, and against JAX."""
    jm, params, off = decoder
    _, _, on = build_decoder(flash_attention=True, flash_min_seq=16)
    x = _embeds(2, 40, 32, seed=10)
    with torch.no_grad():
        got_on, got_off = on(torch.from_numpy(x))[0], off(torch.from_numpy(x))[0]
    np.testing.assert_allclose(to_np(got_on), to_np(got_off), **TOL)
    np.testing.assert_allclose(to_np(got_on), np.asarray(_apply(jm, params, jnp.asarray(x))[0]), **TOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decoder_cached_matches_jax_and_full_forward(decoder, cache_dtype):
    """Prefill s - 3 then token by token: every step equals the JAX cached
    call (same cache dtype), and in float32 the full forward too. Both keep
    the index on the device and attend over all max_len masked positions;
    past the cache's end both clamp the rows' start as
    `dynamic_update_slice` does, and only S > max_len is refused."""
    jm, params, pm = decoder
    b, s, max_len = 2, 10, 16
    x = _embeds(b, s, 32, seed=11)
    jcfg = jax_tf.TransformerConfig(**SLOW_KW)
    jcache = jax_tf.init_kv_cache(jcfg, b, max_len, dtype=jnp.dtype(cache_dtype))
    pcache = port_tf.init_kv_cache(pm.config, b, max_len, dtype=getattr(torch, cache_dtype))
    step = jax.jit(lambda e, c: jm.apply({"params": params}, e, cache=c))
    outs = []
    for lo, hi in [(0, s - 3)] + [(t, t + 1) for t in range(s - 3, s)]:
        want, jcache = step(jnp.asarray(x[:, lo:hi]), jcache)
        with torch.no_grad():
            got, pcache = pm(torch.from_numpy(x[:, lo:hi]), cache=pcache)
        assert pcache["index"] == int(jcache["index"]) == hi
        tol = TOL if cache_dtype == "float32" else dict(atol=2e-4, rtol=1e-3)  # bf16 keys: rounding flips
        np.testing.assert_allclose(to_np(got), np.asarray(want), **tol)
        outs.append(got)
    # the caches hold the same keys: float32 to summation order, bf16 to one rounding flip (2^-6 at |k| < 4)
    np.testing.assert_allclose(to_np(pcache["k"].float()), np.asarray(jcache["k"].astype(jnp.float32)),
                               atol=1e-5 if cache_dtype == "float32" else 2.0**-6)
    if cache_dtype == "float32":
        with torch.no_grad():
            full, _ = pm(torch.from_numpy(x))
        np.testing.assert_allclose(to_np(torch.cat(outs, 1)), to_np(full), **TOL)
    # 10 + 10 > 16: the rows written are the cache's last 10, on both sides
    want, jcache = step(jnp.asarray(x), jcache)
    with torch.no_grad():
        got, pcache = pm(torch.from_numpy(x), cache=pcache)
    assert pcache["index"] == int(jcache["index"]) == 2 * s
    np.testing.assert_allclose(to_np(got), np.asarray(want), **tol)
    np.testing.assert_allclose(to_np(pcache["k"].float()), np.asarray(jcache["k"].astype(jnp.float32)),
                               atol=1e-5 if cache_dtype == "float32" else 2.0**-6)
    with pytest.raises(ValueError):
        pm(torch.from_numpy(_embeds(b, max_len + 1, 32, seed=12)), cache=pcache)  # 17 > 16 positions


def test_qwen2_state_dict_loads_directly():
    """A random state_dict with HF Qwen2Model's names: through
    `decoder_params_from_torch` on the JAX side, `load_state_dict` here."""
    pm = port_tf.Decoder(port_tf.TransformerConfig(**SLOW_KW))
    rng = np.random.default_rng(12)
    sd = {k: (rng.standard_normal(v.shape) / np.sqrt(v.shape[-1])).astype(np.float32) for k, v in pm.state_dict().items()}
    assert "layers.1.self_attn.q_proj.bias" in sd and "layers.0.mlp.gate_proj.weight" in sd and "norm.weight" in sd
    jcfg = jax_tf.TransformerConfig(**SLOW_KW)
    params = jax_tf.decoder_params_from_torch(sd, jcfg)
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    x = _embeds(2, 8, 32, seed=13)
    want, _ = _apply(jax_tf.Decoder(jcfg), params, jnp.asarray(x))
    with torch.no_grad():
        got, _ = pm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    back = decoder_state_dict_from_jax(params, jcfg.num_layers)  # the bridge is the converter's inverse
    assert set(back) == set(sd) and all(np.array_equal(back[k].numpy(), sd[k]) for k in sd)


# ---- ChatMusicLM -------------------------------------------------------------


def _batch(b=2, seed=14):
    rng = np.random.default_rng(seed)
    gridder = port_inputs.TokenGridBuilder(config=PORT_TINY)
    grids = [
        gridder.build_train_grid(rng.integers(0, 1000, size=4 + i), rng.integers(0, 175, size=(6, 10)))
        for i in range(b)
    ]
    return port_inputs.pad_grids_to_batch(grids, PORT_TINY)


def test_cross_entropy_ignore():
    rng = np.random.default_rng(15)
    logits = rng.standard_normal((4, 6, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(4, 6))
    labels[0, :3] = -100
    want = float(jax_lm.cross_entropy_ignore(jnp.asarray(logits), jnp.asarray(labels)))
    got = port_lm.cross_entropy_ignore(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    none = port_lm.cross_entropy_ignore(torch.from_numpy(logits), torch.full((4, 6), -100))
    assert float(none) == 0.0 == float(jax_lm.cross_entropy_ignore(jnp.asarray(logits), jnp.full((4, 6), -100)))
    half = port_lm.cross_entropy_ignore(torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels))
    assert half.dtype == torch.float32


def test_embed_inputs_and_zero_pads(lm):
    jm, params, pm = lm
    batch = _batch()
    want = _apply(jm, params, jnp.asarray(batch["text_tokens"]), jnp.asarray(batch["audio_tokens"]),
                  method=jax_lm.ChatMusicLM.embed_inputs)
    with torch.no_grad():
        got = pm.embed_inputs(torch.from_numpy(batch["text_tokens"]), torch.from_numpy(batch["audio_tokens"]))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    text = torch.tensor([[PORT_TINY.text_pad_id, 5]])
    audio = torch.tensor([[[PORT_TINY.slow_audio_pad_id] * 10, list(range(10))]])
    with torch.no_grad():
        emb = pm.embed_inputs(text, audio)
    assert (emb[0, 0] == 0).all() and emb[0, 1].abs().sum() > 0  # an all-pad position is exactly zero


def test_training_forward(lm):
    """Both logits and all three losses of the cache-less teacher-forced
    forward; embeds masked by `valid` as the trainer does."""
    jm, params, pm = lm
    batch = _batch()
    emb = _apply(jm, params, jnp.asarray(batch["text_tokens"]), jnp.asarray(batch["audio_tokens"]),
                 method=jax_lm.ChatMusicLM.embed_inputs) * batch["valid"][..., None]
    want = _apply(jm, params, emb, jnp.asarray(batch["text_labels"]), jnp.asarray(batch["audio_labels"]))
    with torch.no_grad():
        got = pm(torch.from_numpy(np.array(emb)), torch.from_numpy(batch["text_labels"]),
                 torch.from_numpy(batch["audio_labels"]))
    assert set(got) == set(want)
    for k in ("text_logits", "audio_logits"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]), **TOL)
    for k in ("loss", "text_loss", "audio_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    assert float(got["loss"]) > 0


def test_non_finite_losses_are_zeroed(lm):
    _, _, pm = lm
    batch = _batch()
    emb = torch.full((2, batch["text_tokens"].shape[1], 32), float("nan"))
    with torch.no_grad():
        out = pm(emb, torch.from_numpy(batch["text_labels"]), torch.from_numpy(batch["audio_labels"]))
    assert float(out["loss"]) == float(out["text_loss"]) == float(out["audio_loss"]) == 0.0


def test_generation_forwards(lm):
    """forward_generate_text (prefill + one step), the growing, fixed and
    cached depth decodes, fast_depth_pos0 and fast_embed_tokens."""
    jm, params, pm = lm
    M = jax_lm.ChatMusicLM
    b, s = 2, 7
    x = _embeds(b, s, 32, seed=16)
    jcache = jm.init_slow_cache(b, 16)
    pcache = pm.init_slow_cache(b, 16)
    for lo, hi in ((0, s - 1), (s - 1, s)):
        jl, jh, jcache = _apply(jm, params, jnp.asarray(x[:, lo:hi]), jcache, method=M.forward_generate_text)
        with torch.no_grad():
            pl_, ph, pcache = pm.forward_generate_text(torch.from_numpy(x[:, lo:hi]), pcache)
        np.testing.assert_allclose(to_np(pl_), np.asarray(jl), **TOL)
        np.testing.assert_allclose(to_np(ph), np.asarray(jh), **TOL)
    hidden = np.array(jh)  # [B, 1, H]
    ids = np.random.default_rng(17).integers(0, 1800, size=(b, 10))
    th, tids = torch.from_numpy(hidden), torch.from_numpy(ids)
    with torch.no_grad():
        np.testing.assert_allclose(
            to_np(pm.forward_generate_audio(th)), np.asarray(_apply(jm, params, jnp.asarray(hidden), method=M.forward_generate_audio)), **TOL)
        np.testing.assert_allclose(
            to_np(pm.forward_generate_audio(th, tids[:, :4])),
            np.asarray(_apply(jm, params, jnp.asarray(hidden), jnp.asarray(ids[:, :4]), method=M.forward_generate_audio)), **TOL)
        fixed = pm.forward_generate_audio_fixed(th, tids)
        np.testing.assert_allclose(
            to_np(fixed),
            np.asarray(_apply(jm, params, jnp.asarray(hidden), jnp.asarray(ids), method=M.forward_generate_audio_fixed)), **TOL)
        pos0 = pm.fast_depth_pos0(th)
        np.testing.assert_allclose(to_np(pos0), np.asarray(_apply(jm, params, jnp.asarray(hidden), method=M.fast_depth_pos0)), **TOL)
        np.testing.assert_allclose(
            to_np(pm.fast_embed_tokens(tids)), np.asarray(_apply(jm, params, jnp.asarray(ids), method=M.fast_embed_tokens)), atol=0)
        # the cached decode, position by position, equals the fixed one and JAX's
        jfc, pfc, xj, xp = jm.init_fast_cache(b), pm.init_fast_cache(b), jnp.asarray(to_np(pos0), jnp.float32), pos0
        assert pfc["k"].shape == (2, b, 10, 2, 6)
        for i in range(10):
            jlog, jfc = _apply(jm, params, xj, jfc, method=M.forward_generate_audio_cached)
            plog, pfc = pm.forward_generate_audio_cached(xp, pfc)
            np.testing.assert_allclose(to_np(plog), np.asarray(jlog), **TOL)
            np.testing.assert_allclose(to_np(plog), to_np(fixed[:, i]), **TOL)
            xp = pm.fast_embed_tokens(tids[:, i : i + 1])
            xj = jnp.asarray(to_np(xp), jnp.float32)


@pytest.mark.parametrize("tied", [True, False])
def test_load_qwen2_foundation(lm, tied):
    """A random state_dict with HF Qwen2ForCausalLM's names ('model.*'):
    tied (no `lm_head.weight`, the LM's vocabulary) and untied (fewer
    embedding rows than the LM's table): same slow hidden states and text
    logits, pad row zero."""
    jm, params, _ = lm
    pm = port_lm.ChatMusicLM(PORT_TINY)
    pm.load_state_dict(lm_state_dict_from_jax(params, PORT_TINY))
    rng = np.random.default_rng(18)
    rows = 151936 if tied else 151700  # > text_pad_id
    sd = {f"model.{k}": (rng.standard_normal(v.shape) / np.sqrt(v.shape[-1])).astype(np.float32)
          for k, v in pm.slow_decoder.state_dict().items()}
    sd["model.embed_tokens.weight"] = rng.standard_normal((rows, 32)).astype(np.float32)
    if not tied:
        sd["lm_head.weight"] = (rng.standard_normal((151936, 32)) / np.sqrt(32)).astype(np.float32)
    jparams = jax_lm.load_qwen2_foundation(params, sd, JAX_TINY)
    port_lm.load_qwen2_foundation(pm, {k: torch.from_numpy(v) for k, v in sd.items()})
    assert (pm.text_embed.weight[PORT_TINY.text_pad_id] == 0).all()
    np.testing.assert_array_equal(pm.text_embed.weight.detach().numpy(), np.asarray(jparams["text_embed"]["embedding"]))
    if tied:
        np.testing.assert_array_equal(pm.text_head.weight.detach().numpy(), sd["model.embed_tokens.weight"])
    text = np.array([[5, 151649, PORT_TINY.text_pad_id, 77]])
    audio = np.random.default_rng(19).integers(0, 1800, size=(1, 4, 10))
    emb = _apply(jm, jparams, jnp.asarray(text), jnp.asarray(audio), method=jax_lm.ChatMusicLM.embed_inputs)
    jl, jh, _ = _apply(jm, jparams, emb, jm.init_slow_cache(1, 8), method=jax_lm.ChatMusicLM.forward_generate_text)
    with torch.no_grad():
        pe = pm.eval().embed_inputs(torch.from_numpy(text), torch.from_numpy(audio))
        pl_, ph, _ = pm.forward_generate_text(pe, pm.init_slow_cache(1, 8))
    np.testing.assert_allclose(to_np(pe), np.asarray(emb), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(to_np(ph), np.asarray(jh), **TOL)
    assert pl_.shape == jl.shape
    np.testing.assert_allclose(to_np(pl_), np.asarray(jl), **TOL)


# ---- token grids and tokenizer ------------------------------------------------


def _grid_case(kind):
    rng = np.random.default_rng(20)
    text = rng.integers(0, 151643, size=5) if kind in ("text", "mixed") else None
    audio = rng.integers(0, 175, size=(4, 10)) if kind in ("audio", "mixed") else None
    return text, audio


@pytest.mark.parametrize("kind", ["text", "audio", "mixed"])
def test_infer_grid_copy(kind):
    text, audio = _grid_case(kind)
    want = jax_inputs.TokenGridBuilder().build_infer_grid(text_ids=text, audio_ids=audio)
    got = port_inputs.TokenGridBuilder().build_infer_grid(text_ids=text, audio_ids=audio)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_train_grid_and_batch_copy():
    rng = np.random.default_rng(21)
    pairs = [(rng.integers(0, 151643, size=7 - i), rng.integers(0, 175, size=(12 - 3 * i, 10))) for i in range(3)]
    want = [jax_inputs.TokenGridBuilder().build_train_grid(t, a) for t, a in pairs]
    got = [port_inputs.TokenGridBuilder().build_train_grid(t, a) for t, a in pairs]
    for g, w in zip(got, want):
        for ga, wa in zip(g, w):
            np.testing.assert_array_equal(ga, wa)
    for pad_to in (None, 40, 20):
        wb = jax_inputs.pad_grids_to_batch(want, pad_to=pad_to)
        gb = port_inputs.pad_grids_to_batch(got, pad_to=pad_to)
        assert set(gb) == set(wb)
        for k in wb:
            np.testing.assert_array_equal(gb[k], wb[k])


def test_byte_tokenizer_copy():
    for text in ("who are you?", "héllo wörld ✓", ""):
        ids = ByteTokenizer().encode(text)
        np.testing.assert_array_equal(ids, JaxByteTokenizer().encode(text))
        assert ByteTokenizer().decode(ids) == JaxByteTokenizer().decode(ids) == text


# ---- sampling ------------------------------------------------------------------


def _logits(v=200, seed=22, batch=()):
    return (3.0 * np.random.default_rng(seed).standard_normal((*batch, v))).astype(np.float32)


SAMPLING_CASES = {
    "defaults": dict(temperature=0.7, top_k=50, top_p=0.8),
    "no nucleus": dict(temperature=1.0, top_k=20, top_p=1.0),
    "tight nucleus": dict(temperature=0.5, top_k=50, top_p=0.3),
    "greedy": dict(temperature=0.7, top_k=1, top_p=0.8),
    "dense nucleus": dict(temperature=0.9, top_k=0, top_p=0.6),
    "dense plain": dict(temperature=1.3, top_k=0, top_p=1.0),
    "k covers the vocabulary": dict(temperature=0.7, top_k=500, top_p=0.9),
}


@pytest.mark.parametrize("case", list(SAMPLING_CASES))
def test_logits_to_probs_and_returned_probs(case):
    """`logits_to_probs` and the `probs` that `sample_token` returns, with
    a penalty window that holds a token in both a valid and an invalid
    slot: 1e-6 abs on probabilities."""
    kw = SAMPLING_CASES[case]
    logits = _logits()
    prev = np.array([3, 17, 17, 150, 3, 9], np.int64)
    valid = np.array([True, True, False, False, False, True])
    want = jax_sampling.logits_to_probs(jnp.asarray(logits), jnp.asarray(prev), jnp.asarray(valid),
                                        repetition_penalty=1.2, **kw)
    got = port_sampling.logits_to_probs(torch.from_numpy(logits), torch.from_numpy(prev), torch.from_numpy(valid),
                                        repetition_penalty=1.2, **kw)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-6)
    _, jprobs = jax_sampling.sample_token(jax.random.PRNGKey(0), jnp.asarray(logits), jnp.asarray(prev),
                                          jnp.asarray(valid), repetition_penalty=1.2, **kw)
    tok, pprobs = port_sampling.sample_token(torch.Generator().manual_seed(0), torch.from_numpy(logits),
                                             torch.from_numpy(prev), torch.from_numpy(valid),
                                             repetition_penalty=1.2, **kw)
    np.testing.assert_allclose(to_np(pprobs), np.asarray(jprobs), atol=1e-6)
    assert pprobs[tok] > 0 and tok.dtype == torch.int64
    # the batch written out equals row by row
    rows = _logits(batch=(3,), seed=23)
    pb = port_sampling.logits_to_probs(torch.from_numpy(rows), torch.from_numpy(np.stack([prev] * 3)),
                                       torch.from_numpy(np.stack([valid] * 3)), repetition_penalty=1.2, **kw)
    for r in range(3):
        wr = jax_sampling.logits_to_probs(jnp.asarray(rows[r]), jnp.asarray(prev), jnp.asarray(valid),
                                          repetition_penalty=1.2, **kw)
        np.testing.assert_allclose(to_np(pb[r]), np.asarray(wr), atol=1e-6)


def test_repetition_penalty_duplicate_slots():
    logits = _logits(v=30)
    prev = np.array([4, 4, 7, 7], np.int64)
    valid = np.array([False, True, False, False])
    want = jax_sampling.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(prev), jnp.asarray(valid), 1.5)
    got = port_sampling.apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(prev), torch.from_numpy(valid), 1.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[4] != logits[4] and got[7] == logits[7]


def _tied_logits():
    """k-th ties: the k = 4 cutoff value 1.0 appears 3 times, one of them
    outside the top-k whichever way the sort breaks the tie."""
    logits = np.full(40, -5.0, np.float32)
    logits[[2, 11, 30]] = [3.0, 2.5, 2.0]
    logits[[5, 19, 33]] = 1.0
    return logits


def test_probs_keep_kth_ties():
    logits = _tied_logits()
    kw = dict(temperature=0.7, top_k=4, top_p=1.0)
    want = jax_sampling.logits_to_probs(jnp.asarray(logits), **kw)
    got = port_sampling.logits_to_probs(torch.from_numpy(logits), **kw)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-7)
    assert (to_np(got) > 0).sum() == 6
    _, jp = jax_sampling.sample_token(jax.random.PRNGKey(0), jnp.asarray(logits), repetition_penalty=1.0, **kw)
    _, pp = port_sampling.sample_token(torch.Generator().manual_seed(0), torch.from_numpy(logits), repetition_penalty=1.0, **kw)
    np.testing.assert_allclose(to_np(pp), np.asarray(jp), atol=1e-7)


@pytest.mark.parametrize("which", ["defaults", "ties beyond the top-k", "dense"])
def test_draw_distribution_matches_probs(which):
    """20000 seeded draws in one batched call against the returned probs:
    every class within 5 sigma of its binomial expectation, nothing drawn
    outside the support."""
    if which == "ties beyond the top-k":
        logits, kw = _tied_logits(), dict(temperature=0.7, top_k=4, top_p=1.0)
    elif which == "dense":
        logits, kw = _logits(v=60), dict(temperature=1.0, top_k=0, top_p=0.9)
    else:
        logits, kw = _logits(v=200), dict(temperature=0.7, top_k=50, top_p=0.8)
    n = 20000
    rows = torch.from_numpy(logits).expand(n, -1)
    tokens, probs = port_sampling.sample_token(torch.Generator().manual_seed(1), rows, repetition_penalty=1.0, **kw)
    p = to_np(probs[0])
    np.testing.assert_allclose(p, np.asarray(jax_sampling.logits_to_probs(jnp.asarray(logits), **kw)), atol=1e-6)
    counts = np.bincount(tokens.numpy(), minlength=len(p))
    assert counts[p == 0].sum() == 0
    sigma = np.sqrt(n * p * (1 - p))
    assert (np.abs(counts - n * p) <= 5 * sigma + 1).all(), np.abs(counts - n * p).max()
    if which == "ties beyond the top-k":
        assert (counts[[5, 19, 33]] > 0).all()  # the tied class outside the top-k is reachable
