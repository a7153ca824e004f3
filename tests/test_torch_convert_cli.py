"""`dmel_codec_tpu_torch.cli.convert` on made-up reference checkpoints at
small widths (seeded weights; nothing is downloaded).

  * vqgan: a Lightning `.ckpt` -> a `CodecTrainState` at step 0 that
    `CodecFitLoop` resumes and `load_codec_adapter` serves; the generator
    equals what the JAX package's `load_vqgan_checkpoint` reads from the same
    file (carried over by `convert.codec_state_dict_from_jax`); a missing
    or an extra key is refused.
  * bigvgan: a release directory -> one whose generator gives the source
    module's output, in its dtype.
  * qwen2: a made-up safetensors file merged like the JAX
    `load_qwen2_foundation` merges it, into what `cli.infer_lm` and
    `cli.train_lm` read.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
import yaml

from dmel_codec_tpu.cli.common import build_lm_config as jax_build_lm_config
from dmel_codec_tpu.models import lm as jax_lm
from dmel_codec_tpu.models.codec import DMelCodecConfig as JaxDMelCodecConfig
from dmel_codec_tpu.models.codec_convert import load_vqgan_checkpoint
from dmel_codec_tpu.train import lm_trainer as jax_lm_trainer
from dmel_codec_tpu_torch.cli import common, convert
from dmel_codec_tpu_torch.convert import codec_state_dict_from_jax, discriminator_state_dict_from_jax, lm_state_dict_from_jax
from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, from_pretrained
from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
from dmel_codec_tpu_torch.models.discriminator import MelDiscriminator
from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
from dmel_codec_tpu_torch.train.codec_trainer import CodecTrainConfig, CodecTrainer
from dmel_codec_tpu_torch.train.lm_trainer import LMTrainConfig, LMTrainer
from dmel_codec_tpu_torch.train.loop import CodecFitLoop, FitConfig
from tests.test_torch_lm import FAST_KW
from tests.test_torch_support import CODEC_KW, VOCODER_KW, strict_f32  # noqa: F401  (strict_f32 is a fixture)

pytestmark = pytest.mark.usefixtures("strict_f32")


def _parametrized(sd: dict) -> dict:
    """Weight norm under torch's parametrization names, as newer releases
    save it."""
    return {k.replace(".weight_g", ".parametrizations.weight.original0").replace(
        ".weight_v", ".parametrizations.weight.original1"): v for k, v in sd.items()}


def _vqgan_file(tmp_path, with_disc: bool = True, edit=None):
    """A Lightning checkpoint of a small VQGAN: the generator, the
    discriminator (parametrized weight norm) and the mel transforms'
    buffers, which hold no weights. Returns (path, generator sd, disc sd)."""
    torch.manual_seed(3)
    gen, disc = DMelCodec(DMelCodecConfig(**CODEC_KW)).state_dict(), MelDiscriminator().state_dict()
    sd = dict(gen)
    if with_disc:
        sd |= {f"discriminator.{k}": v for k, v in _parametrized(disc).items()}
    sd |= {"encode_mel_transform.mel_basis": torch.ones(20, 513), "gt_mel_transform.window": torch.ones(1024)}
    if edit:
        edit(sd)
    path = tmp_path / "epoch=3.ckpt"
    torch.save({"state_dict": sd, "epoch": 3, "global_step": 1234}, path)
    (tmp_path / "codec.yaml").write_text(yaml.safe_dump({"model": CODEC_KW, "train": {"num_warmup_steps": 2}}))
    return path, gen, disc


def _convert_vqgan(tmp_path, path):
    convert.main(["vqgan", "--ckpt", str(path), "--out", str(tmp_path / "codec"),
                  "--config", str(tmp_path / "codec.yaml"), "--device", "cpu"])
    return tmp_path / "codec"


@pytest.mark.parametrize("with_disc", [True, False], ids=["with_discriminator", "without_discriminator"])
def test_vqgan_convert_resumes_and_serves(tmp_path, with_disc):
    path, gen, disc = _vqgan_file(tmp_path, with_disc)
    out = _convert_vqgan(tmp_path, path)
    mgr = CheckpointManager(str(out))
    assert mgr.all_steps() == [0]
    fields = mgr.restore_latest_fields(None, ("step", "gen_params", "disc_params", "gen_opt_state"))
    assert fields["step"] == 0 and fields["gen_opt_state"]["gradient_step"] == 0
    assert all(torch.equal(fields["gen_params"][k], v) for k, v in gen.items())
    trainer = CodecTrainer(DMelCodecConfig(**CODEC_KW), CodecTrainConfig(num_warmup_steps=2), device="cpu")
    fresh = {k: v.clone() for k, v in trainer.init_state(0).disc_params.items()}
    want_disc = disc if with_disc else fresh
    assert all(torch.equal(fields["disc_params"][k], v) for k, v in want_disc.items())

    # the JAX package reads the same generator and discriminator from the file
    jgen, jdisc = load_vqgan_checkpoint(str(path), JaxDMelCodecConfig(**CODEC_KW))
    for k, v in codec_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgen)).items():
        assert torch.equal(fields["gen_params"][k], v), k
    assert (jdisc is not None) == with_disc
    if with_disc:
        for k, v in discriminator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jdisc)).items():
            assert torch.equal(fields["disc_params"][k], v), k

    # CodecFitLoop resumes from it (the first update's lr is 0: nothing moves)
    audio = np.random.default_rng(0).standard_normal((1, 256 * 16)).astype(np.float32) * 0.1
    batches = lambda epoch: iter([{"audios": audio, "audio_lengths": np.array([audio.shape[1]])}])  # noqa: E731
    fit = FitConfig(max_steps=1, val_interval=100, log_every=1, ckpt_dir=str(out), log_dir=str(tmp_path / "logs"))
    state = CodecFitLoop(trainer, batches, fit_config=fit).run()
    assert state.step == 1 and mgr.all_steps() == [0, 1]
    assert all(torch.equal(state.gen_params[k], v) for k, v in gen.items())
    # and serving reads the generator
    adapter = common.load_codec_adapter(str(out), DMelCodecConfig(**CODEC_KW), device="cpu")
    assert all(torch.equal(adapter.codec.state_dict()[k], v) for k, v in gen.items())


def _drop(prefix):
    def edit(sd):
        del sd[next(k for k in sd if k.startswith(prefix))]
    return edit


@pytest.mark.parametrize("edit,match", [
    (_drop("decoder."), "generator: 1 missing keys"),
    (_drop("discriminator."), "discriminator: 1 missing keys"),
    (lambda sd: sd.update({"encoder.extra.weight": torch.zeros(1)}), "generator: 0 missing keys .* 1 unexpected"),
    (lambda sd: sd.update({"discriminator.blocks.12.bias": torch.zeros(1)}), "discriminator: 0 missing .* 1 unexpected"),
    (lambda sd: sd.update({"optimizer_state.step": torch.zeros(1)}), "outside the VQGAN's subtrees"),
], ids=["missing_generator_key", "missing_discriminator_key", "extra_generator_key", "extra_discriminator_key",
        "unknown_subtree"])
def test_vqgan_convert_checks_keys_strictly(tmp_path, edit, match):
    path, _, _ = _vqgan_file(tmp_path, edit=edit)
    with pytest.raises(ValueError, match=match):
        _convert_vqgan(tmp_path, path)
    assert not (tmp_path / "codec").exists() or CheckpointManager(str(tmp_path / "codec")).all_steps() == []


def _release_dir(path, dtype: torch.dtype):
    """A BigVGAN release directory at a small width: config.json with the
    release's keys and bigvgan_generator.pt under "generator"."""
    cfg = BigVGANConfig(**VOCODER_KW)
    torch.manual_seed(5)
    model = BigVGAN(cfg).to(dtype).eval()
    path.mkdir()
    h = {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(cfg).items()}
    (path / "config.json").write_text(json.dumps(h))
    torch.save({"generator": _parametrized(model.state_dict())}, path / "bigvgan_generator.pt")
    return model


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_bigvgan_convert_reads_back_the_same_module(tmp_path, dtype):
    model = _release_dir(tmp_path / "release", dtype)
    convert.main(["bigvgan", "--dir", str(tmp_path / "release"), "--out", str(tmp_path / "vocoder")])
    back = from_pretrained(str(tmp_path / "vocoder"))
    assert next(back.parameters()).dtype == dtype
    mel = torch.randn(1, 24, VOCODER_KW["num_mels"], generator=torch.Generator().manual_seed(0)).to(dtype)
    with torch.no_grad():
        assert torch.equal(back(mel), model(mel))
    # the same file is a `vocoder_ckpt` of infer_lm / evaluate
    from dmel_codec_tpu_torch.models.bigvgan import load_torch_checkpoint

    again = load_torch_checkpoint(str(tmp_path / "vocoder" / "bigvgan_generator.pt"), BigVGANConfig(**VOCODER_KW))
    assert all(torch.equal(again.state_dict()[k], v) for k, v in back.state_dict().items())


# The flagship's special ids (text_pad_id 151650) need the flagship text vocabulary.
QWEN_SLOW = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4, num_kv_heads=2)


def test_qwen2_convert_merges_like_jax(tmp_path):
    """A made-up Qwen2 safetensors file (decoder, norm, embeddings; the head
    tied): the converted `params` hold the JAX merge's slow decoder, text
    embedding (pad row zeroed) and head, and load as `cli.infer_lm` and
    `cli.train_lm` read them."""
    from safetensors.numpy import save_file

    cfg = {"slow_lm": QWEN_SLOW, "fast_lm": FAST_KW, "train": {"accumulate_grad": 1}}
    (tmp_path / "lm.yaml").write_text(yaml.safe_dump(cfg))
    pcfg = common.build_lm_config(cfg)
    rng = np.random.default_rng(9)
    torch.manual_seed(9)
    decoder = LMTrainer(pcfg, LMTrainConfig(accumulate_grad=1), device="cpu").model.slow_decoder
    sd = {f"model.{k}": (rng.standard_normal(tuple(v.shape)) * 0.02).astype(np.float32)
          for k, v in decoder.state_dict().items()}
    sd["model.embed_tokens.weight"] = (rng.standard_normal((pcfg.slow.vocab_size, 32)) * 0.02).astype(np.float32)
    save_file(sd, str(tmp_path / "model.safetensors"))

    convert.main(["qwen2", "--safetensors", str(tmp_path / "model.safetensors"), "--out", str(tmp_path / "lm"),
                  "--config", str(tmp_path / "lm.yaml"), "--device", "cpu"])
    params = common.load_lm_params(str(tmp_path / "lm"))

    jcfg = jax_build_lm_config(cfg)
    jt = jax_lm_trainer.LMTrainer(jcfg, jax_lm_trainer.LMTrainConfig(accumulate_grad=1))
    merged = jax_lm.load_qwen2_foundation(jax.jit(jt.init_state)(jax.random.PRNGKey(0)).params, sd, jcfg)
    want = lm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, merged), pcfg)
    loaded = [k for k in want if k.startswith("slow_decoder.") or k in ("text_embed.weight", "text_head.weight")]
    assert len(loaded) > 10
    for k in loaded:
        assert torch.equal(params[k], want[k]), k
    assert not params["text_embed.weight"][pcfg.text_pad_id].any()

    # train_lm resumes from it: the full train state restores into a fresh trainer's
    trainer = LMTrainer(pcfg, LMTrainConfig(accumulate_grad=1), device="cpu")
    state = CheckpointManager(str(tmp_path / "lm")).restore_latest(trainer.init_state(1))
    assert state.step == 0 and all(torch.equal(state.params[k], params[k]) for k in loaded)
