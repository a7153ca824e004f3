"""The port's LM trainer against the JAX package's at a small size: the
schedule, the decay mask, top-k accuracy, `remat`, the training trajectory
(the slice as a whole; flash attention off and on, the non-finite guard)
and LoRA.

Sizes: 2 + 2 layers, hidden 64 / 48, a 512-entry text vocabulary with the
special ids moved into it, S <= 176. float32 on the CPU, inputs from a numpy
seed, the same arrays through both sides, torch pinned to one thread. Where
the JAX side reaches jax's Pallas flash attention (forward and backward) it
runs under `force_tpu_interpret_mode`.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dmel_codec_tpu.lm.inputs import TokenGridBuilder as JaxTokenGridBuilder
from dmel_codec_tpu.lm.inputs import pad_grids_to_batch as jax_pad_grids_to_batch
from dmel_codec_tpu.models import lm as jax_lm
from dmel_codec_tpu.models import transformer as jax_tf
from dmel_codec_tpu.train import lm_trainer as jax_trainer
from dmel_codec_tpu.train import lora as jax_lora
from dmel_codec_tpu.train.schedule import cosine_schedule_with_warmup as jax_schedule
from dmel_codec_tpu_torch.convert import decoder_state_dict_from_jax, lm_state_dict_from_jax, lora_from_jax
from dmel_codec_tpu_torch.models import lm as port_lm
from dmel_codec_tpu_torch.models import transformer as port_tf
from dmel_codec_tpu_torch.train import lm_trainer as port_trainer
from dmel_codec_tpu_torch.train import lora as port_lora
from dmel_codec_tpu_torch.train.schedule import cosine_schedule_with_warmup, lambda_lr
from tests.test_torch_support import strict_f32, to_np  # noqa: F401  (strict_f32 is a fixture)

pytestmark = pytest.mark.usefixtures("strict_f32")

SPECIALS = dict(
    bos_token_id=500, eos_token_id=500, start_of_human_id=501, end_of_human_id=502, start_of_robot_id=503,
    end_of_robot_id=504, start_of_music_id=505, end_of_music_id=506, text_pad_id=507,
)
SLOW_KW = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2)
FAST_KW = dict(vocab_size=1800, hidden_size=48, intermediate_size=96, num_layers=2, num_heads=4, num_kv_heads=2)
TRAIN_KW = dict(accumulate_grad=2, num_warmup_steps=2, learning_rate=1e-3, num_training_steps=10)


def configs(**slow_extra):
    jcfg = jax_lm.SlowFastLMConfig(
        slow=jax_tf.TransformerConfig(**SLOW_KW, **slow_extra), fast=jax_tf.TransformerConfig(**FAST_KW),
        text_weight=0.01, **SPECIALS,
    )
    pcfg = port_lm.SlowFastLMConfig(
        slow=port_tf.TransformerConfig(**SLOW_KW, **slow_extra), fast=port_tf.TransformerConfig(**FAST_KW),
        text_weight=0.01, **SPECIALS,
    )
    return jcfg, pcfg


def host_batches(jcfg, audio_frames: int, n: int = 2, seed: int = 0):
    rng = np.random.default_rng(seed)
    gridder = JaxTokenGridBuilder(config=jcfg)
    out = []
    for _ in range(n):
        grids = [
            gridder.build_train_grid(rng.integers(0, 500, size=5), rng.integers(0, 175, size=(audio_frames - 7 * i, 10)))
            for i in range(2)
        ]
        out.append(jax_pad_grids_to_batch(grids, jcfg))
    return out


def trainer_pair(train_kw=TRAIN_KW, **slow_extra):
    """(jax trainer, jax state, port trainer, port state) on the JAX
    trainer's initial parameters."""
    jcfg, pcfg = configs(**slow_extra)
    jt = jax_trainer.LMTrainer(jcfg, jax_trainer.LMTrainConfig(**train_kw))
    pt = port_trainer.LMTrainer(pcfg, port_trainer.LMTrainConfig(**train_kw), device="cpu")
    js = jt.init_state(jax.random.PRNGKey(0))
    ps = pt.init_state(0)
    pt.model.load_state_dict(lm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, js.params), pcfg))
    return jt, js, pt, ps


def jnp_batch(hb):
    return {k: jnp.asarray(v) for k, v in hb.items()}


def assert_metrics_close(got: dict, want: dict, rel: float = 1e-4):
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = float(got[k]), float(w)
        assert abs(g - w) <= rel * max(abs(w), 1e-7), (k, g, w)


def assert_params_close(port_params: dict, jax_params, pcfg):
    """1e-5 + 1e-4 |p|: float32 on both sides after a few Adam updates of
    lr 1e-3 on gradients that agree to ~1e-6 relative."""
    want = lm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), pcfg)
    assert set(want) == set(port_params)
    for name, w in want.items():
        np.testing.assert_allclose(to_np(port_params[name]), to_np(w), atol=1e-5, rtol=1e-4, err_msg=name)


# ---- pieces ------------------------------------------------------------------


@pytest.mark.parametrize("warmup,total,ratio", [(1000, 60_000, 0.2), (0.1, 50, 0.0), (0, 20, 0.5)])
def test_cosine_schedule_with_warmup(warmup, total, ratio):
    """At 0, warmup - 1, warmup, mid, end and beyond; float32 on the JAX
    side: 1e-6 relative. The LambdaLR form gives the same values."""
    want = jax_schedule(1e-4, warmup, total, final_lr_ratio=ratio)
    got = cosine_schedule_with_warmup(1e-4, warmup, total, final_lr_ratio=ratio)
    w = int(warmup * total) if 0 < warmup < 1 else int(warmup)
    steps = [0, max(w - 1, 0), w, (w + total) // 2, total, total + 17]
    for step in steps:
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=1e-12), step
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=1e-4)
    sched = lambda_lr(opt, got, 1e-4)
    for step in range(max(steps) + 1):
        if step in steps:
            assert sched.get_last_lr()[0] == pytest.approx(got(step), rel=1e-12, abs=1e-18)
        opt.step()
        sched.step()


def _jax_names(mask) -> dict:
    """JAX tree of booleans -> {port parameter name: bool}."""
    flat = jax.tree_util.tree_flatten_with_path(mask)[0]
    out = {}
    for path, value in flat:
        parts = [p.key.replace("layers_", "layers.") for p in path]
        parts[-1] = {"kernel": "weight", "embedding": "weight"}.get(parts[-1], parts[-1])
        out[".".join(parts)] = bool(value)
    return out


def test_decay_mask_matches_jax():
    _, js, pt, ps = trainer_pair()
    want = _jax_names(jax_trainer._decay_mask(js.params))
    got = port_trainer._decay_mask(ps.params)
    assert got == want
    assert got["text_embed.weight"] and got["slow_decoder.layers.0.self_attn.q_proj.weight"]
    assert not got["slow_decoder.layers.0.self_attn.q_proj.bias"] and not got["fast_pre_norm.weight"]
    assert not got["slow_decoder.norm.weight"] and not got["fast_decoder.layers.1.input_layernorm.weight"]
    # the optimizer's parameter groups say the same
    groups = ps.opt_state.adamw.param_groups
    decayed = {id(p) for g in groups if g["weight_decay"] > 0 for p in g["params"]}
    assert {n for n, p in ps.params.items() if id(p) in decayed} == {n for n, d in want.items() if d}


def test_topk_accuracy_matches_jax():
    """Random logits quantised to a few levels (many ties, broken towards
    the lower index on both sides), ignored and out-of-range labels."""
    rng = np.random.default_rng(0)
    logits = rng.integers(0, 4, size=(3, 9, 40)).astype(np.float32)
    labels = rng.integers(0, 40, size=(3, 9))
    labels[0, 3] = -100
    labels[1, 5] = 7  # an ignore id below
    labels[2, 2] = 39
    for s in (0, 4):  # two certain top-1 hits: position s predicts label s + 1
        logits[2, s, labels[2, s + 1]] = 10.0
    ks = (1, 2, 5, 10, 20, 50)
    want = jax_trainer.topk_accuracy(jnp.asarray(logits), jnp.asarray(labels), ks[:-1], ignore_ids=(-100, 7))
    got = port_trainer.topk_accuracy(torch.from_numpy(logits), torch.from_numpy(labels), ks[:-1], ignore_ids=(-100, 7))
    for k in ks[:-1]:
        assert float(got[k]) == pytest.approx(float(want[k]), abs=1e-7), k
    assert 0 < float(got[1]) <= float(got[5]) < float(got[10]) < float(got[20]) <= 1.0
    # k beyond the vocabulary counts every valid label, as a top-k of everything would
    assert float(port_trainer.topk_accuracy(torch.from_numpy(logits), torch.from_numpy(labels), (50,))[50]) == 1.0
    all_ignored = port_trainer.topk_accuracy(torch.from_numpy(logits), torch.full((3, 9), -100), (1,))
    assert float(all_ignored[1]) == 0.0


def test_decoder_remat_equals_no_remat_and_jax():
    """`remat=True`: outputs and parameter gradients equal `remat=False`
    (1e-6) and the JAX Decoder's gradients from the same weights (1e-5 abs
    + 1e-4 rel)."""
    jcfg = jax_tf.TransformerConfig(**SLOW_KW, remat=True)
    jm = jax_tf.Decoder(jcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    # a linear loss: the sum of squares of a normed output hardly depends on the layers below
    r = rng.standard_normal((2, 24, 64)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    sd = decoder_state_dict_from_jax(params, jcfg.num_layers)
    grads = {}
    for remat in (False, True):
        pm = port_tf.Decoder(port_tf.TransformerConfig(**SLOW_KW, remat=remat)).train()
        pm.load_state_dict(sd)
        out, _ = pm(torch.from_numpy(x))
        (out * torch.from_numpy(r)).sum().backward()
        grads[remat] = (out.detach(), {n: p.grad for n, p in pm.named_parameters()})
    torch.testing.assert_close(grads[True][0], grads[False][0], rtol=1e-6, atol=1e-6)
    for name, g in grads[False][1].items():
        torch.testing.assert_close(grads[True][1][name], g, rtol=1e-6, atol=1e-6)
    jgrads = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x))[0] * jnp.asarray(r)))(params)
    want = decoder_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), jcfg.num_layers)
    for name, w in want.items():
        np.testing.assert_allclose(to_np(grads[True][1][name]), to_np(w), atol=1e-5, rtol=1e-4, err_msg=name)


def test_remat_runs_the_flash_forward_twice(monkeypatch):
    """Under `remat` a block's forward runs again in the backward pass: two
    forward calls and one backward call of the attention op per layer."""
    from dmel_codec_tpu_torch.ops import flash_attention as fa

    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_attention_forward_reference, fa.flash_attention_backward_reference
    monkeypatch.setattr(fa, "flash_attention_forward_reference", lambda *a: calls.__setitem__("fwd", calls["fwd"] + 1) or fwd(*a))
    monkeypatch.setattr(fa, "flash_attention_backward_reference", lambda *a: calls.__setitem__("bwd", calls["bwd"] + 1) or bwd(*a))
    for remat, want in ((False, {"fwd": 2, "bwd": 2}), (True, {"fwd": 4, "bwd": 2})):
        calls.update(fwd=0, bwd=0)
        pm = port_tf.Decoder(port_tf.TransformerConfig(**SLOW_KW, remat=remat, flash_attention=True, flash_min_seq=16))
        pm(torch.randn(1, 20, 64))[0].sum().backward()
        assert calls == want, (remat, calls)


# ---- the slice as a whole: the training trajectory ------------------------------


def _run_trajectory(jt, js, pt, ps, batches, steps, ctx=contextlib.nullcontext()):
    with ctx:
        step = jax.jit(jt.train_step)
        for i in range(steps):
            hb = batches[i % len(batches)]
            js, jm = step(js, jnp_batch(hb))
            ps, pm = pt.train_step(ps, pt.device_batch(hb))
            assert ps.step == int(js.step) == i + 1
            assert_metrics_close(pm, jm)
    return js, ps


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
def test_training_trajectory_matches_jax(flash):
    """6 micro-steps with accumulate_grad = 2 (3 updates), warmup 2, lr 1e-3
    on 2 fixed batches: every metric per step within 1e-4 relative, the
    parameters after step 6 within 1e-5 + 1e-4 |p|. With flash on, the slow
    decoder (S = 169 >= flash_min_seq = 128) goes through the plain versions
    of FA / FA-dKV / FA-dQ here and through jax's Pallas kernels in
    interpret mode there."""
    extra = dict(flash_attention=True, flash_min_seq=128) if flash else {}
    jt, js, pt, ps = trainer_pair(**extra)
    batches = host_batches(jt.lm_config, audio_frames=150 if flash else 20)
    if flash:
        assert batches[0]["text_tokens"].shape[1] >= 128
    before = {n: p.detach().clone() for n, p in ps.params.items()}
    ctx = pltpu.force_tpu_interpret_mode() if flash else contextlib.nullcontext()
    js, ps = _run_trajectory(jt, js, pt, ps, batches, 6, ctx)
    assert_params_close(ps.params, js.params, pt.lm_config)
    assert any(not torch.equal(before[n], p) for n, p in ps.params.items())
    assert ps.opt_state.gradient_step == 3 and ps.opt_state.mini_step == 0


def test_parameters_change_only_on_update_steps():
    _, _, pt, ps = trainer_pair(dict(TRAIN_KW, num_warmup_steps=0))
    batch = pt.device_batch(host_batches(pt.lm_config, 12)[0])
    snap = lambda: {n: p.detach().clone() for n, p in ps.params.items()}  # noqa: E731
    p0 = snap()
    pt.train_step(ps, batch)
    assert all(torch.equal(p0[n], p) for n, p in ps.params.items())
    pt.train_step(ps, batch)
    assert any(not torch.equal(p0[n], p) for n, p in ps.params.items())


def _bad_batch(hb):
    """A copy of `hb` whose loss gradient is NaN (a NaN `valid` weight)."""
    bad = {k: v.copy() for k, v in hb.items()}
    bad["valid"][0, 3] = np.nan
    return bad


@pytest.mark.parametrize("bad_at", [1, 0, 2], ids=["emitting", "first", "after-an-update"])
def test_training_trajectory_skips_a_non_finite_micro_step(bad_at):
    """`skip_nonfinite_updates = 2`: a batch whose loss gradient is NaN is
    dropped on both sides (no parameter, moment or accumulator change)
    whether it comes where an update would be emitted or where the
    accumulation only begins, and the trajectory stays together after it."""
    kw = dict(TRAIN_KW, skip_nonfinite_updates=2)
    jt, js, pt, ps = trainer_pair(kw)
    good = host_batches(jt.lm_config, 20)
    bad = _bad_batch(good[0])
    order = [good[0], good[1], good[0], good[1]]
    order.insert(bad_at, bad)
    step = jax.jit(jt.train_step)
    for i, hb in enumerate(order):
        js, jm = step(js, jnp_batch(hb))
        ps, pm = pt.train_step(ps, pt.device_batch(hb))
        if hb is bad:
            assert not np.isfinite(float(jm["train/grad_norm"])) and not np.isfinite(float(pm["train/grad_norm"]))
        else:
            assert_metrics_close(pm, jm)
        assert ps.opt_state.mini_step == int(js.opt_state.inner_state.mini_step)
    assert ps.opt_state.total_notfinite == 1 == int(js.opt_state.total_notfinite)
    assert ps.opt_state.notfinite_count == 0
    # 4 finite micro-steps = 2 updates; the dropped one did not advance the accumulation
    assert ps.opt_state.gradient_step == 2 == int(js.opt_state.inner_state.gradient_step)
    assert all(torch.isfinite(p).all() for p in ps.params.values())
    assert_params_close(ps.params, js.params, pt.lm_config)


def test_non_finite_guard_gives_up_after_the_limit():
    """`skip_nonfinite_updates = 2` and three NaN batches in a row: the
    first two are dropped, the third is applied on both sides. It falls on
    an emitting micro-step here, so the update runs with it and every
    parameter turns NaN, in the port as in JAX; the counters agree."""
    kw = dict(TRAIN_KW, skip_nonfinite_updates=2)
    jt, js, pt, ps = trainer_pair(kw)
    good = host_batches(jt.lm_config, 20)
    bad = _bad_batch(good[1])
    step = jax.jit(jt.train_step)
    for i, hb in enumerate([good[0], bad, bad, bad]):
        js, _ = step(js, jnp_batch(hb))
        ps, _ = pt.train_step(ps, pt.device_batch(hb))
        assert ps.opt_state.notfinite_count == int(js.opt_state.notfinite_count) == i
        assert ps.opt_state.total_notfinite == int(js.opt_state.total_notfinite) == i
        assert ps.opt_state.gradient_step == int(js.opt_state.inner_state.gradient_step) == (i == 3)
        port_nan = [bool(torch.isnan(p).all()) for p in ps.params.values()]
        jax_nan = [bool(np.isnan(np.asarray(p)).all()) for p in jax.tree_util.tree_leaves(js.params)]
        if i < 3:  # dropped: nothing moved, nothing poisoned
            assert not any(port_nan) and not any(jax_nan)
            assert all(torch.isfinite(p).all() for p in ps.params.values())
        else:
            assert all(port_nan) and all(jax_nan)


# ---- LoRA -----------------------------------------------------------------------


def _lora_pair(train_kw):
    jt, js, pt, ps = trainer_pair(train_kw)
    jls = jt.init_lora_state(jax.random.PRNGKey(1), jax_lora.LoRAConfig(rank=4, alpha=8.0), base_params=js.params)
    pls = pt.init_lora_state(1, port_lora.LoRAConfig(rank=4, alpha=8.0), base_params=ps.params)
    carried = lora_from_jax(jax.tree_util.tree_map(np.asarray, jls.lora))
    assert set(carried) == set(pls.lora)
    with torch.no_grad():
        for name, ab in carried.items():
            for k in ("a", "b"):
                assert pls.lora[name][k].shape == ab[k].shape
                pls.lora[name][k].copy_(ab[k])
    return jt, jls, pt, pls


def test_lora_init_and_merge():
    """b = 0: the merged model IS the base model; q/k/v/o of every layer of
    both decoders are adapted; `lora_from_jax` keeps a [in, r] and b [r, out]
    under the port's names; a merged weight equals JAX's, transposed."""
    jt, jls, pt, pls = _lora_pair(TRAIN_KW)
    merged = pt.merged_lora_params(pls)
    assert all(torch.equal(merged[n], p) for n, p in pls.base_params.items())
    assert len(pls.lora) == 16 and all("self_attn" in n for n in pls.lora)
    assert port_lora.lora_param_count(pls.lora) == jax_lora.lora_param_count(jls.lora)
    assert port_lora.lora_param_count(pls.lora) < 0.05 * sum(p.numel() for p in pls.base_params.values())
    name = "slow_decoder.layers.1.self_attn.k_proj.weight"
    b = np.random.default_rng(2).standard_normal(tuple(pls.lora[name]["b"].shape)).astype(np.float32)
    with torch.no_grad():
        pls.lora[name]["b"].copy_(torch.from_numpy(b))
    jlora = dict(jls.lora)
    jname = "slow_decoder/layers_1/self_attn/k_proj/kernel"
    jlora[jname] = {"a": jls.lora[jname]["a"], "b": jnp.asarray(b)}
    want = jax_lora.merge_lora(jls.base_params, jlora, jt.lora_config)["slow_decoder"]["layers_1"]["self_attn"]["k_proj"]["kernel"]
    np.testing.assert_allclose(to_np(pt.merged_lora_params(pls)[name]), np.asarray(want).T, atol=1e-6)
    with pytest.raises(ValueError):
        port_lora.init_lora(pls.base_params, port_lora.LoRAConfig(targets="no_such_parameter"))
    with pytest.raises(RuntimeError):
        port_trainer.LMTrainer(pt.lm_config, pt.config, device="cpu").lora_train_step(pls, None)


def test_lora_train_steps_match_jax():
    """4 adapter-only steps (accumulate 1, lr 1e-2 from step 0): loss and
    gradient norm within 1e-4 relative, adapters within 1e-5 + 1e-4 |a|, the
    base bit-unchanged, and no optimizer state for the base."""
    kw = dict(accumulate_grad=1, num_warmup_steps=0, learning_rate=1e-2, num_training_steps=10)
    jt, jls, pt, pls = _lora_pair(kw)
    batches = host_batches(jt.lm_config, 20)
    base_before = {n: p.detach().clone() for n, p in pls.base_params.items()}
    step = jax.jit(jt.lora_train_step)
    for i in range(4):
        hb = batches[i % 2]
        jls, jm = step(jls, jnp_batch(hb))
        pls, pm = pt.lora_train_step(pls, pt.device_batch(hb))
        assert_metrics_close(pm, jm)
        assert float(pm["train/grad_norm"]) > 0
    want = lora_from_jax(jax.tree_util.tree_map(np.asarray, jls.lora))
    moved = 0
    for name, ab in want.items():
        for k in ("a", "b"):
            np.testing.assert_allclose(to_np(pls.lora[name][k]), to_np(ab[k]), atol=1e-5, rtol=1e-4, err_msg=name)
        moved += int(pls.lora[name]["b"].abs().sum() > 0)
    assert moved == len(want)
    assert all(torch.equal(base_before[n], p) for n, p in pls.base_params.items())
    assert all(p.grad is None for p in pls.base_params.values())
    adapted = {id(t) for t in port_lora.lora_leaves(pls.lora).values()}
    assert {id(p) for g in pls.opt_state.adamw.param_groups for p in g["params"]} == adapted
    assert all(g["weight_decay"] == 0.0 for g in pls.opt_state.adamw.param_groups)


def test_lora_with_remat_takes_the_merged_weights_in_the_backward_pass():
    """Under `remat` the blocks run again during the backward pass; the
    adapter gradients must equal the ones without it."""
    grads = {}
    for remat in (False, True):
        _, pcfg = configs(remat=remat)
        pcfg = dataclasses.replace(pcfg, fast=dataclasses.replace(pcfg.fast, remat=remat))
        pt = port_trainer.LMTrainer(pcfg, port_trainer.LMTrainConfig(**TRAIN_KW), device="cpu")
        pls = pt.init_lora_state(3, port_lora.LoRAConfig(rank=4))
        with torch.no_grad():
            for ab in pls.lora.values():
                ab["b"].normal_(0.0, 0.5, generator=torch.Generator().manual_seed(5))
        batch = pt.device_batch(host_batches(pcfg, 20)[0])
        _, g = port_lora.loss_and_grads_lora(pt.loss_fn, pls.base_params, pls.lora, pt.lora_config, batch)
        grads[remat] = port_lora.lora_leaves(g)
    for name, g in grads[False].items():
        assert g.abs().max() > 0
        torch.testing.assert_close(grads[True][name], g, rtol=1e-5, atol=1e-7)
