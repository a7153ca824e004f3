"""The port's codec GAN training against the JAX package's, on the CPU in
float32: the discriminator, each loss, the codec's training forward and the
gradient through the FSQ's straight-through rounding, then whole
trajectories of `CodecTrainer` from carried-over weights with the same
batches and the same decoder noise, `eval_step`, and `CodecFitLoop` /
`cli.train_codec` end to end into `load_codec_adapter`. Inputs, weights and
noise come from a numpy seed (or from the JAX trainer's own init).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from dmel_codec_tpu.models.codec import DMelCodecConfig as JaxDMelCodecConfig
from dmel_codec_tpu.models.discriminator import MelDiscriminator as JaxMelDiscriminator
from dmel_codec_tpu.nn.weight_norm import WNConv as JaxWNConv
from dmel_codec_tpu.train import codec_trainer as jax_trainer
from dmel_codec_tpu.train import losses as jax_losses
from dmel_codec_tpu.utils.masks import avg_with_mask as jax_avg_with_mask
from dmel_codec_tpu_torch.cli import train_codec
from dmel_codec_tpu_torch.cli.common import load_codec_adapter
from dmel_codec_tpu_torch.convert import (
    codec_state_dict_from_jax,
    codec_train_state_from_jax,
    discriminator_state_dict_from_jax,
)
from dmel_codec_tpu_torch.models.codec import DMelCodecConfig
from dmel_codec_tpu_torch.models.discriminator import MelDiscriminator
from dmel_codec_tpu_torch.nn.weight_norm import WNConv2d
from dmel_codec_tpu_torch.train import codec_trainer as port_trainer
from dmel_codec_tpu_torch.train import losses as port_losses
from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
from dmel_codec_tpu_torch.train.loop import CodecFitLoop, FitConfig
from dmel_codec_tpu_torch.train.optim import AccumulatingAdamW
from dmel_codec_tpu_torch.utils.logging import plot_mel
from dmel_codec_tpu_torch.utils.masks import avg_with_mask
from tests.test_torch_support import FRAMES, build_codec, init_params, strict_f32, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("strict_f32")

TOL = dict(rtol=1e-5, atol=1e-5)
# tests/test_trainer.py's SMALL codec (flagship mel layout, narrow and shallow)
SMALL_KW = dict(encoder_residual_channels=12, encoder_layers=2, decoder_layers=2)
HOP = 256
TRAIN_FRAMES = 16


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- modules and losses -----------------------------------------------------------


def test_avg_with_mask_broadcasts_like_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 5)).astype(np.float32)
    mask = (rng.random((3, 7, 1)) > 0.4).astype(np.float32)
    np.testing.assert_allclose(
        to_np(avg_with_mask(_t(x), _t(mask))), np.asarray(jax_avg_with_mask(jnp.asarray(x), jnp.asarray(mask))), **TOL
    )


def test_wnconv2d_matches_jax():
    """Stride over the second spatial axis only, asymmetric kernel, per-output g."""
    jconv = JaxWNConv(5, kernel_size=(3, 9), strides=(1, 2), padding=(1, 4))
    x = np.random.default_rng(1).standard_normal((2, 10, 13, 3)).astype(np.float32)  # NHWC
    params = init_params(jconv, 1, jnp.asarray(x))
    want = np.asarray(jconv.apply({"params": params}, jnp.asarray(x)))
    conv = WNConv2d(3, 5, (3, 9), (1, 2), (1, 4))
    conv.load_state_dict({
        "weight_v": _t(np.transpose(params["v"], (3, 2, 0, 1))),
        "weight_g": _t(np.asarray(params["g"]).reshape(-1, 1, 1, 1)),
        "bias": _t(params["bias"]),
    })
    got = conv(_t(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(to_np(got).transpose(0, 2, 3, 1), want, **TOL)


@pytest.fixture(scope="module")
def discriminators():
    jdisc = JaxMelDiscriminator()
    params = init_params(jdisc, 2, jnp.zeros((1, 16, 20)))
    port = MelDiscriminator()
    port.load_state_dict(discriminator_state_dict_from_jax(params))
    return jdisc, params, port


@pytest.mark.parametrize("frames,mels", [(16, 20), (37, 12)])
def test_mel_discriminator_matches_jax(discriminators, frames, mels):
    """The full pyramid (1 -> 64 -> .. -> 1024 -> 1) on a small mel image;
    odd lengths go through three stride-2 layers."""
    jdisc, params, port = discriminators
    mel = np.random.default_rng(3).standard_normal((2, frames, mels)).astype(np.float32)
    want = np.asarray(jdisc.apply({"params": params}, jnp.asarray(mel)))
    with torch.no_grad():
        got = port(_t(mel))
    assert got.shape == want.shape and want.shape[1] == mels
    np.testing.assert_allclose(to_np(got), want, **TOL)


@pytest.mark.parametrize("t,target", [(16, 2), (37, 5), (100, 13), (13, 100), (7, 7)])
def test_resample_mask_nearest_matches_jax(t, target):
    rng = np.random.default_rng(t)
    lengths = rng.integers(1, t + 1, size=4)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)[..., None]
    want = np.asarray(jax_losses.resample_mask_nearest(jnp.asarray(mask), target))
    got = port_losses.resample_mask_nearest(_t(mask), target)
    assert got.shape == (4, 1, target)
    np.testing.assert_array_equal(to_np(got), want)


@pytest.mark.parametrize("name", ["discriminator_loss", "adversarial_loss", "weighted_mel_loss"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(4)
    if name == "weighted_mel_loss":
        gen, gt = (rng.standard_normal((3, 11, 100)).astype(np.float32) for _ in range(2))
        mask = (np.arange(11)[None, :] < np.array([11, 5, 8])[:, None]).astype(np.float32)[..., None]
        args = (gen, gt, mask)
    else:
        logits = [rng.standard_normal((3, 20, 5)).astype(np.float32) for _ in range(2)]
        mask = (np.arange(5)[None, :] < np.array([5, 2, 3])[:, None]).astype(np.float32)[:, None, :]
        args = (*logits, mask) if name == "discriminator_loss" else (logits[0], mask)
    want = getattr(jax_losses, name)(*map(jnp.asarray, args))
    got = getattr(port_losses, name)(*map(_t, args))
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)


def _forward_inputs(cfg, frames: int, seed: int):
    rng = np.random.default_rng(seed)
    mels = rng.standard_normal((2, frames, cfg.n_mels)).astype(np.float32)
    lengths = np.array([frames, frames - 9])
    masks = (np.arange(frames)[None, :] < lengths[:, None]).astype(np.float32)[..., None]
    quality = rng.standard_normal((2, 1)).astype(np.float32)
    noise = rng.standard_normal((2, frames, cfg.concat_dim)).astype(np.float32)
    return mels, masks, quality, noise


@pytest.mark.parametrize("frames", [FRAMES, FRAMES + 3])
def test_codec_training_forward_matches_jax(frames):
    """`DMelCodec.forward` with given noise: gen_mel, and the FSQ result's
    z (padded back to T where T is no multiple of 4), codes and latents."""
    jmodel, params, port = build_codec()
    mels, masks, quality, noise = _forward_inputs(jmodel.config, frames, 5)
    want_mel, want_vq = jmodel.apply({"params": params}, *map(jnp.asarray, (mels, masks, quality, noise)))
    with torch.no_grad():
        got_mel, got_vq = port(*map(_t, (mels, masks, quality, noise)))
    np.testing.assert_allclose(to_np(got_mel), np.asarray(want_mel), **TOL)
    np.testing.assert_allclose(to_np(got_vq.z.transpose(1, 2)), np.asarray(want_vq.z), **TOL)
    np.testing.assert_allclose(to_np(got_vq.latents), np.asarray(want_vq.latents), **TOL)
    np.testing.assert_array_equal(got_vq.codes.numpy(), np.asarray(want_vq.codes))


def test_codec_forward_draws_noise_from_the_generator():
    _, _, port = build_codec()
    mels, masks, quality, _ = map(_t, _forward_inputs(port.config, FRAMES, 6))
    with torch.no_grad():
        a, _ = port(mels, masks, quality, generator=torch.Generator().manual_seed(3))
        b, _ = port(mels, masks, quality, generator=torch.Generator().manual_seed(3))
        c, _ = port(mels, masks, quality, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_encoder_gradient_through_fsq_matches_jax_grad():
    """The gradient that reaches the encoder (and the quantizer's own
    projections) passes the rounding straight through and skips the
    detached codes of the residual loop: held against `jax.grad`."""
    jmodel, params, port = build_codec()
    mels, masks, quality, noise = _forward_inputs(jmodel.config, FRAMES, 7)
    target = np.random.default_rng(8).standard_normal((2, FRAMES, jmodel.config.n_mels)).astype(np.float32)

    def jloss(p):
        gen_mel, _ = jmodel.apply({"params": p}, *map(jnp.asarray, (mels, masks, quality, noise)))
        return jnp.mean((gen_mel - target) ** 2)

    want = codec_state_dict_from_jax(_np_tree(jax.grad(jloss)(params)))
    port.zero_grad()
    gen_mel, _ = port(*map(_t, (mels, masks, quality, noise)))
    ((gen_mel - _t(target)) ** 2).mean().backward()
    seen = 0
    for name, p in port.named_parameters():
        w = want[name].numpy()
        scale = max(np.abs(w).max(), 1e-8)
        np.testing.assert_allclose(p.grad.numpy() / scale, w / scale, rtol=1e-4, atol=1e-5, err_msg=name)
        seen += name.startswith(("encoder.", "quantizer.residual_fsq")) and np.abs(w).max() > 0
    assert seen > 10  # the encoder and both FSQ projections do receive a gradient


# ---- trajectories -------------------------------------------------------------------


def _train_batches(n: int, seed: int = 0):
    """tests/test_trainer.py's batch (two clips, the second of half length),
    a new draw per step, each with its decoder noise."""
    rng = np.random.default_rng(seed)
    samples = HOP * TRAIN_FRAMES
    out = []
    for _ in range(n):
        out.append({
            "audios": rng.standard_normal((2, samples)).astype(np.float32) * 0.1,
            "audio_lengths": np.array([samples, samples // 2], dtype=np.int32),
            "noise": rng.standard_normal((2, TRAIN_FRAMES, 120)).astype(np.float32),
        })
    return out


def _trainers(**train_kw):
    """(jax trainer, its initial state, port trainer, port state on the same weights)."""
    kw = dict(learning_rate=1e-3, num_warmup_steps=2, **train_kw)
    jt = jax_trainer.CodecTrainer(JaxDMelCodecConfig(**SMALL_KW), jax_trainer.CodecTrainConfig(**kw))
    jstate = jt.init_state(jax.random.PRNGKey(0), max_frames=TRAIN_FRAMES)
    pt = port_trainer.CodecTrainer(DMelCodecConfig(**SMALL_KW), port_trainer.CodecTrainConfig(**kw), device="cpu")
    pstate = codec_train_state_from_jax(pt, _np_tree(jstate.gen_params), _np_tree(jstate.disc_params))
    return jt, jstate, pt, pstate


# Per step: the losses and lr within rtol 2e-4, the gradient norms 1e-3
# (float32 sums of ~10^7 squares in another order; measured: losses 4e-6,
# the discriminator's norm 8e-5). After 5 steps at lr up to 1e-3 AdamW has
# moved each parameter by up to ~4e-3, and the two packages' parameters
# then differ by at most 8e-7 (measured, all three settings): atol 2e-5.
PARAM_ATOL = 2e-5


@pytest.mark.parametrize(
    "train_kw",
    [dict(), dict(accumulate_grad=2), dict(freeze_encoder=True)],
    ids=["plain", "accumulate_2", "freeze_encoder"],
)
def test_trajectory_matches_jax(train_kw):
    """Five steps of both trainers from the JAX trainer's initial weights,
    on the same batches and decoder noise: all nine metrics per step, and
    every parameter after the last step."""
    jt, jstate, pt, pstate = _trainers(**train_kw)
    start = {k: v.detach().clone() for k, v in {**pstate.gen_params, **pstate.disc_params}.items()}
    step_fn = jax.jit(jt.train_step)
    for i, batch in enumerate(_train_batches(5)):
        jstate, want = step_fn(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(i))
        pstate, got = pt.train_step(pstate, pt.device_batch(batch))
        assert set(got) == set(want) and len(got) == 9
        for name in want:
            rtol = 1e-3 if "grad_norm" in name else 2e-4
            np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=rtol, atol=1e-7, err_msg=f"step {i} {name}")
    assert pstate.step == int(jstate.step) == 5
    want_gen = codec_state_dict_from_jax(_np_tree(jstate.gen_params))
    want_disc = discriminator_state_dict_from_jax(_np_tree(jstate.disc_params))
    frozen = ("encoder.", "quantizer.") if train_kw.get("freeze_encoder") else ()
    for got_tree, want_tree in ((pstate.gen_params, want_gen), (pstate.disc_params, want_disc)):
        assert set(got_tree) == set(want_tree)
        for name, p in got_tree.items():
            np.testing.assert_allclose(p.detach().numpy(), want_tree[name].numpy(), rtol=0, atol=PARAM_ATOL, err_msg=name)
            if frozen and got_tree is pstate.gen_params and name.startswith(frozen):
                assert torch.equal(p.detach(), start[name]), name  # bit-unchanged, and JAX's too
                np.testing.assert_array_equal(p.detach().numpy(), want_tree[name].numpy())
            else:  # the learning rate is high enough that every trained tensor moved
                assert not torch.equal(p.detach(), start[name]), name
    # no gradient was left on either module
    assert all(p.grad is None for p in (*pt.codec.parameters(), *pt.discriminator.parameters()))


def test_first_update_has_lr_zero_and_state_is_in_place():
    """LambdaLR semantics: lr is 0 at the first update, so nothing moves
    until the second; the state returned is the one given."""
    _, _, pt, pstate = _trainers()
    before = {k: v.detach().clone() for k, v in {**pstate.gen_params, **pstate.disc_params}.items()}
    batches = [pt.device_batch(b) for b in _train_batches(2)]
    out, metrics = pt.train_step(pstate, batches[0])
    assert out is pstate and metrics["train/lr"] == 0.0
    assert all(torch.equal(v, before[k]) for k, v in {**pstate.gen_params, **pstate.disc_params}.items())
    _, metrics = pt.train_step(pstate, batches[1])
    assert metrics["train/lr"] == pytest.approx(5e-4)
    assert not torch.equal(pstate.gen_params["decoder.output_projection.conv.weight"],
                           before["decoder.output_projection.conv.weight"])
    assert not torch.equal(pstate.disc_params["blocks.0.weight_v"], before["blocks.0.weight_v"])
    assert pstate.gen_params["encoder.input_projection.conv.weight"] is pt.codec.encoder.input_projection.conv.weight


def test_train_step_draws_noise_from_the_generator():
    _, _, pt, pstate = _trainers()
    batch = pt.device_batch({k: v for k, v in _train_batches(1)[0].items() if k != "noise"})
    losses = []
    for seed in (1, 1, 2):
        _, m = pt.train_step(pstate, batch, torch.Generator().manual_seed(seed))  # lr 0 until step 2: no update
        losses.append(float(m["train/generator/loss_mel"]))
        pstate.step = 0
        pstate.gen_opt_state.gradient_step = pstate.disc_opt_state.gradient_step = 0
    assert losses[0] == losses[1] != losses[2]


def test_guard_watches_the_frozen_gradients_too():
    """`optax.apply_if_finite` wraps the whole generator transform, so a
    non-finite gradient in a frozen subtree drops the micro-step as well."""
    cfg = port_trainer.CodecTrainConfig(learning_rate=1.0, num_warmup_steps=0, skip_nonfinite_updates=2)
    p = {"w": torch.ones(3)}
    opt = AccumulatingAdamW(p, {"w": True}, cfg, lambda step: 0.1)
    opt.update([torch.ones(3)], watch=[torch.tensor([float("nan")])])
    assert torch.equal(p["w"], torch.ones(3)) and opt.gradient_step == 0 and opt.total_notfinite == 1
    opt.update([torch.ones(3)], watch=[torch.zeros(1)])
    assert opt.gradient_step == 1 and not torch.equal(p["w"], torch.ones(3))


def test_eval_step_matches_codec_apply():
    jt, jstate, pt, pstate = _trainers()
    batch = _train_batches(1, seed=9)[0]
    want_in = jt._prepare(jnp.asarray(batch["audios"]), jnp.asarray(batch["audio_lengths"]))
    encode_mels, gt_mels, mel_masks, _ = want_in
    gen_mel, _ = jt.codec.apply({"params": jstate.gen_params}, encode_mels, mel_masks,
                                jnp.full((2, 1), 2.0), jnp.asarray(batch["noise"]))
    want = jax_avg_with_mask(jnp.abs(gen_mel - gt_mels), mel_masks)
    got = pt.eval_step(pstate, pt.device_batch(batch))
    np.testing.assert_allclose(float(got["val_loss"]), float(want), rtol=1e-5)
    # the preamble itself: mels, masked gt mels, masks, quality of the unmasked mels
    for g, w in zip(pt._prepare(_t(batch["audios"]), torch.as_tensor(batch["audio_lengths"]).long()), jt._prepare(
            jnp.asarray(batch["audios"]), jnp.asarray(batch["audio_lengths"]))):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_steps_refuse_another_trainers_state():
    """The steps run the trainer's own modules: a state whose parameters are
    not those modules' would be ignored, so it is refused."""
    _, _, pt, pstate = _trainers()
    _, _, other, _ = _trainers()
    batch = other.device_batch(_train_batches(1)[0])
    for step in (other.eval_step, other.train_step):
        with pytest.raises(ValueError, match="not this trainer's"):
            step(pstate, batch)
    assert pstate.step == 0 and float(pt.eval_step(pstate, batch)["val_loss"]) > 0


def test_state_round_trips_through_a_checkpoint(tmp_path):
    _, _, pt, pstate = _trainers(accumulate_grad=2)
    batches = [pt.device_batch(b) for b in _train_batches(4)]
    for b in batches[:3]:  # ends inside an accumulation cycle
        pt.train_step(pstate, b)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, pstate)
    fields = mgr.restore_latest_fields(None, ("step", "gen_params", "disc_params", "gen_opt_state", "disc_opt_state"))
    assert fields["step"] == 3 and fields["gen_opt_state"]["mini_step"] == 1
    assert set(fields["gen_params"]) == set(pt.codec.state_dict())
    pt.train_step(pstate, batches[3])
    want = {k: v.detach().clone() for k, v in {**pstate.gen_params, **pstate.disc_params}.items()}
    other = port_trainer.CodecTrainer(DMelCodecConfig(**SMALL_KW), pt.config, device="cpu")
    ostate = other.init_state(5)
    assert mgr.restore_latest(ostate) is ostate and ostate.step == 3
    other.train_step(ostate, batches[3])
    for k, v in {**ostate.gen_params, **ostate.disc_params}.items():
        assert torch.equal(v, want[k]), k


# ---- the loop and the entry point -----------------------------------------------------

TINY_MODEL = dict(encoder_residual_channels=4, encoder_layers=1, decoder_layers=1)


def _write_corpus(tmp_path, n: int = 4):
    rng = np.random.default_rng(10)
    path = tmp_path / "train.jsonl"
    with open(path, "w") as f:
        for i in range(n):
            dur = 0.2 + 0.05 * i
            t = np.arange(int(24000 * dur)) / 24000
            wave = 0.3 * np.sin(2 * np.pi * (200 + 60 * i) * t) + 0.02 * rng.standard_normal(len(t))
            wavfile.write(tmp_path / f"clip{i}.wav", 24000, wave.astype(np.float32))
            f.write(json.dumps({"id": f"c{i}", "audio_path": str(tmp_path / f"clip{i}.wav"), "duration": dur,
                                "text": ""}) + "\n")
    return path


def _yaml(tmp_path, manifest, max_steps: int, extra: str = "") -> str:
    path = tmp_path / f"codec_{max_steps}.yaml"
    path.write_text(
        f"model: {json.dumps(TINY_MODEL)}\n"
        "train: {learning_rate: 1.0e-3, num_warmup_steps: 1, accumulate_grad: 1}\n"
        f"fit: {{max_steps: {max_steps}, val_interval: 2, log_every: 1, ckpt_dir: {tmp_path / 'ckpt'}, "
        f"log_dir: {tmp_path / 'logs'}, seed: 1, use_mesh: false}}\n"
        f"data: {{train_manifest: {manifest}, val_manifest: {manifest}, max_duration: 0.6, val_max_duration: 0.6}}\n"
        + extra
    )
    return str(path)


def test_train_codec_main_checkpoints_resumes_and_serves(tmp_path):
    manifest = _write_corpus(tmp_path)
    train_codec.main(["--config", _yaml(tmp_path, manifest, 4), "--device", "cpu"])
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.all_steps() == [2, 4]
    names = ("step", "gen_params", "disc_params", "gen_opt_state", "disc_opt_state")
    first = mgr.restore_latest_fields(None, names)
    assert first["step"] == 4 and first["gen_opt_state"]["gradient_step"] == 4
    assert mgr._meta(4)["metrics"]["val_loss"] > 0
    train_codec.main(["--config", _yaml(tmp_path, manifest, 6), "--device", "cpu"])
    second = mgr.restore_latest_fields(None, names)
    assert mgr.all_steps() == [4, 6] and second["step"] == 6 and second["disc_opt_state"]["gradient_step"] == 6
    assert any(not torch.equal(first["gen_params"][k], v) for k, v in second["gen_params"].items())
    records = [json.loads(line) for line in open(tmp_path / "logs" / "metrics.jsonl")]
    assert [r["step"] for r in records if "train/lr" in r] == [1, 2, 3, 4, 5, 6]
    assert [r["step"] for r in records if "val_loss" in r] == [2, 4, 6]
    # serving reads the generator it wrote
    adapter = load_codec_adapter(str(tmp_path / "ckpt"), DMelCodecConfig(**TINY_MODEL), device="cpu")
    for k, v in adapter.codec.state_dict().items():
        assert torch.equal(v, second["gen_params"][k]), k
    mels = torch.randn(1, 16, 100, generator=torch.Generator().manual_seed(0))
    idx, ilen = adapter.codec.encode(mels, torch.tensor([16]))
    assert adapter.codec.decode(idx, ilen, generator=torch.Generator().manual_seed(0)).shape == (1, 16, 100)


@pytest.mark.parametrize("how", ["flag", "section"])
def test_train_codec_refuses_distributed(tmp_path, how, monkeypatch):
    """`--distributed` (or an enabled `distributed:` section) trains
    data-parallel (tests/test_torch_data_parallel.py); without a rendezvous
    (no config fields, no torchrun environment) it is refused before any
    model is built."""
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    manifest = _write_corpus(tmp_path, 1)
    extra = "distributed: {enabled: true}\n" if how == "section" else ""
    argv = ["--config", _yaml(tmp_path, manifest, 2, extra), "--device", "cpu"]
    with pytest.raises(ValueError, match="distributed training needs this process's rank"):
        train_codec.main(argv + (["--distributed"] if how == "flag" else []))
    assert not (tmp_path / "ckpt").exists()


def test_fit_loop_validates_and_logs_media(tmp_path):
    """`CodecFitLoop` with a vocoder for the media: validation every
    `val_interval`, the last save, and a resumed step draws the noise an
    uninterrupted run would."""
    trainer = port_trainer.CodecTrainer(
        DMelCodecConfig(**TINY_MODEL), port_trainer.CodecTrainConfig(learning_rate=1e-3, num_warmup_steps=1), device="cpu")
    batches = [{k: v for k, v in _train_batches(1, seed=11)[0].items() if k != "noise"}] * 3  # one batch: a resumed epoch restarts
    vocoded = []

    def vocoder_apply(mel):
        vocoded.append(tuple(mel.shape))
        return torch.zeros(mel.shape[0], mel.shape[1] * HOP)

    def loop(max_steps, sub):
        cfg = FitConfig(max_steps=max_steps, val_interval=2, log_every=1, ckpt_dir=str(tmp_path / sub / "ckpt"),
                        log_dir=str(tmp_path / sub / "logs"), seed=3)
        return CodecFitLoop(trainer, lambda epoch: iter(batches), lambda: iter(batches[:1]), cfg, vocoder_apply)

    loop(3, "a").run()
    assert CheckpointManager(str(tmp_path / "a" / "ckpt")).all_steps() == [2, 3]
    assert vocoded == [(1, TRAIN_FRAMES, 100)]
    straight = {k: v.detach().clone() for k, v in trainer.codec.state_dict().items()}
    loop(2, "b").run()
    state = loop(3, "b").run()  # resumes at 2, takes the third step
    assert state.step == 3
    for k, v in trainer.codec.state_dict().items():
        assert torch.equal(v, straight[k]), k


def test_plot_mel_stacks_the_panels():
    fig = plot_mel([np.zeros((20, 7)), np.ones((20, 7))], ["a", "b"])
    assert len(fig.axes) == 2 and fig.axes[1].get_title() == "b"
    import matplotlib.pyplot as plt

    plt.close(fig)
