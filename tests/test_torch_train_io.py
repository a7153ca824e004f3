"""Around the port's LM trainer: the checkpoint manager (round trips,
retention, partial restore, resume), the copied data path pinned to its
originals, the metrics writer, and `cli.train_lm` end to end into
`cli.infer_lm`. Small sizes, float32 on the CPU, data from a numpy seed.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from dmel_codec_tpu.data import loader as jax_loader
from dmel_codec_tpu.data import manifest as jax_manifest
from dmel_codec_tpu.lm import data as jax_lm_data
from dmel_codec_tpu.lm.inputs import TokenGridBuilder as JaxTokenGridBuilder
from dmel_codec_tpu.lm.tokenizer import ByteTokenizer as JaxByteTokenizer
from dmel_codec_tpu.utils.logging import MetricsWriter as JaxMetricsWriter
from dmel_codec_tpu_torch.cli import infer_lm, train_lm
from dmel_codec_tpu_torch.data import loader as port_loader
from dmel_codec_tpu_torch.data import manifest as port_manifest
from dmel_codec_tpu_torch.lm import data as port_lm_data
from dmel_codec_tpu_torch.lm.inputs import TokenGridBuilder
from dmel_codec_tpu_torch.lm.tokenizer import ByteTokenizer
from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
from dmel_codec_tpu_torch.train import lm_trainer as port_trainer
from dmel_codec_tpu_torch.train import lora as port_lora
from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
from dmel_codec_tpu_torch.train.lm_loop import LMFitLoop
from dmel_codec_tpu_torch.train.loop import FitConfig
from dmel_codec_tpu_torch.utils.logging import MetricsWriter
from tests.test_torch_lm import FAST_KW, JAX_TINY, PORT_TINY, SLOW_KW
from tests.test_torch_support import CODEC_KW, VOCODER_KW, strict_f32  # noqa: F401  (strict_f32 is a fixture)
from tests.test_torch_train_lm import TRAIN_KW, configs, host_batches

pytestmark = pytest.mark.usefixtures("strict_f32")


def _trainer(seed: int, train_kw=TRAIN_KW):
    _, pcfg = configs()
    pt = port_trainer.LMTrainer(pcfg, port_trainer.LMTrainConfig(**train_kw), device="cpu")
    return pt, pt.init_state(seed)


def _flat(tree, prefix=""):
    """Every tensor / number of a nested state_dict, by path."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def assert_states_bit_equal(a, b):
    fa, fb = dict(_flat(a.state_dict())), dict(_flat(b.state_dict()))
    assert set(fa) == set(fb)
    for path, x in fa.items():
        y = fb[path]
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), path
        else:
            assert x == y, path


# ---- checkpoints ------------------------------------------------------------------


def test_checkpoint_round_trip_and_resume_is_bit_equal(tmp_path):
    """An `LMTrainState` with optimizer moments and a half-filled
    accumulation buffer round-trips bit for bit into a state initialised
    from another seed, and a run resumed after micro-step 3 ends bit-equal
    to the uninterrupted run."""
    pt, ps = _trainer(seed=0)
    batches = [pt.device_batch(hb) for hb in host_batches(pt.lm_config, 20)]
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is None and mgr.restore_latest(ps) is None
    for i in range(3):
        pt.train_step(ps, batches[i % 2])
    assert ps.opt_state.mini_step == 1 and ps.opt_state.gradient_step == 1
    mgr.save(3, ps)
    mgr.wait()
    assert mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path / "ckpt" / "step_3")) == ["meta.json", "opt_state.pt", "params.pt", "step.pt"]

    pt2, ps2 = _trainer(seed=7)
    assert not torch.equal(ps2.params["text_embed.weight"], ps.params["text_embed.weight"])
    restored = CheckpointManager(str(tmp_path / "ckpt")).restore_latest(ps2)
    assert restored is ps2 and ps2.step == 3
    assert_states_bit_equal(ps2, ps)
    assert any(t.abs().sum() > 0 for t in ps2.opt_state.acc_grads)
    assert ps2.params["text_embed.weight"] is pt2.model.text_embed.weight  # restored in place

    for i in range(3, 6):
        pt.train_step(ps, batches[i % 2])
        pt2.train_step(ps2, batches[i % 2])
    assert ps2.step == 6
    assert_states_bit_equal(ps2, ps)
    mgr.close()


def test_checkpoint_round_trip_lora_state(tmp_path):
    pt, _ = _trainer(seed=0, train_kw=dict(TRAIN_KW, num_warmup_steps=0))
    pls = pt.init_lora_state(1, port_lora.LoRAConfig(rank=4))
    batch = pt.device_batch(host_batches(pt.lm_config, 12)[0])
    for _ in range(3):
        pt.lora_train_step(pls, batch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(pls.step, pls)
    assert "lora.pt" in os.listdir(tmp_path / "ckpt" / "step_3")

    pt2, _ = _trainer(seed=5)
    template = pt2.init_lora_state(9, port_lora.LoRAConfig(rank=4))
    assert mgr.restore_latest(template) is template and template.step == 3
    assert_states_bit_equal(template, pls)
    # the `lora` field alone is a LoRA-only checkpoint
    only = mgr.restore_latest_fields(template, ("lora",))
    assert set(only) == {"lora"} and set(only["lora"]) == set(pls.lora)
    with pytest.raises(ValueError, match="differ"):
        mgr.restore_latest(pt2.init_lora_state(9, port_lora.LoRAConfig(rank=4, targets=r"q_proj\.weight$")))


def _tiny_state(step: int) -> dict:
    return {"w": torch.full((2,), float(step))}


@pytest.mark.parametrize("mode", ["min", "max"])
def test_checkpoint_best_metric_retention(tmp_path, mode):
    """Metric-ranked top-k keeps the BEST steps, not the newest; a save
    without metrics ranks worst (it is written, resumable, and the first to
    go)."""
    sign = 1.0 if mode == "min" else -1.0
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2, best_metric="val_loss", best_mode=mode)
    # good, best, terrible, mediocre: the top 2 are steps 1 and 2
    for step, loss in [(1, 0.5), (2, 0.2), (3, 9.0), (4, 1.0)]:
        mgr.save(step, _tiny_state(step), metrics={"val_loss": sign * loss, "other": 1.0})
    assert mgr.all_steps() == [1, 2]
    assert float(mgr.restore_latest_fields(None, ("w",))["w"][0]) == 2.0
    mgr.save(5, _tiny_state(5))  # no metrics: ranked worst, evicted at once by two ranked ones
    assert mgr.all_steps() == [1, 2]
    mgr.save(6, _tiny_state(6), metrics={"val_loss": sign * 0.1})
    assert mgr.all_steps() == [2, 6]

    fresh = CheckpointManager(str(tmp_path / "fresh"), max_to_keep=2, best_metric="val_loss", best_mode=mode)
    fresh.save(1, _tiny_state(1))
    assert fresh.latest_step() == 1  # alone, a metric-less save stays and resumes
    fresh.save(2, _tiny_state(2), metrics={"val_loss": sign * 3.0})
    fresh.save(3, _tiny_state(3), metrics={"val_loss": sign * 4.0})
    assert fresh.all_steps() == [2, 3]
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path / "bad"), best_mode="median")


def test_checkpoint_keep_newest_and_half_written_directories(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, _tiny_state(step), metrics={"val_loss": 1.0 / step})  # metrics ignored without best_metric
    assert mgr.all_steps() == [2, 3]
    # a writer that died: a temporary directory, and a step directory without meta.json
    os.makedirs(tmp_path / "ckpt" / "step_9.tmp-123")
    os.makedirs(tmp_path / "ckpt" / "step_8")
    torch.save(_tiny_state(8)["w"], tmp_path / "ckpt" / "step_8" / "w.pt")
    again = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert again.all_steps() == [2, 3] and again.latest_step() == 3
    assert float(again.restore_latest_fields(None, ("w",))["w"][0]) == 3.0
    again.save(3, _tiny_state(30))  # saving a step again replaces it
    assert float(again.restore_latest_fields(None, ("w",))["w"][0]) == 30.0


def test_restore_latest_fields(tmp_path):
    """Serving reads `params` and `step` only; the fields are checked
    against an abstract state when one is given."""
    pt, ps = _trainer(seed=0)
    pt.train_step(ps, pt.device_batch(host_batches(pt.lm_config, 12)[0]))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.restore_latest_fields(None, ("params",)) is None
    mgr.save(1, ps)
    got = mgr.restore_latest_fields(ps, ("params", "step"))
    assert set(got) == {"params", "step"} and got["step"] == 1
    assert all(torch.equal(got["params"][n], p) for n, p in ps.params.items())
    assert not any(t.requires_grad for t in got["params"].values())
    with pytest.raises(KeyError):
        mgr.restore_latest_fields(None, ("gen_params",))
    other = port_trainer.LMTrainer(PORT_TINY, device="cpu").init_state(0)
    with pytest.raises(ValueError, match="params"):
        mgr.restore_latest_fields(other, ("params",))


# ---- the copied data path, pinned to its originals ---------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """8 synthetic WAVs (0.3 .. 1.0 s; 24 kHz int16 and 16 kHz float32) and
    their manifests in the flat schema and in lhotse's, gzipped."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    flat, lhotse = [], []
    for i in range(8):
        sr = 24000 if i % 2 == 0 else 16000
        dur = 0.3 + 0.1 * i
        t = np.arange(int(sr * dur)) / sr
        wave = 0.4 * np.sin(2 * np.pi * (200 + 40 * i) * t) + 0.05 * rng.standard_normal(len(t))
        path = str(root / f"clip{i}.wav")
        wavfile.write(path, sr, (wave * 32767).astype(np.int16) if i % 2 == 0 else wave.astype(np.float32))
        flat.append({"id": f"c{i}", "audio_path": path, "duration": dur, "sampling_rate": sr, "text": f"clip {i}"})
        lhotse.append({
            "id": f"c{i}", "start": 0.0, "duration": dur,
            "recording": {"sources": [{"source": path}], "sampling_rate": sr, "duration": dur},
            "supervisions": [{"text": f"clip {i}"}],
        })
    with open(root / "flat.jsonl", "w") as f:
        f.writelines(json.dumps(d) + "\n" for d in flat)
    with gzip.open(root / "lhotse.jsonl.gz", "wt") as f:
        f.writelines(json.dumps(d) + "\n" for d in lhotse)
    return root


@pytest.mark.parametrize("name", ["flat.jsonl", "lhotse.jsonl.gz"])
def test_manifest_copy(dataset, tmp_path, name):
    want = jax_manifest.load_manifest(str(dataset / name))
    got = port_manifest.load_manifest(str(dataset / name))
    assert [c.to_dict() for c in got] == [c.to_dict() for c in want] and len(got) == 8
    port_manifest.save_manifest(got, str(tmp_path / "out" / "m.jsonl.gz"))
    assert [c.to_dict() for c in jax_manifest.load_manifest(str(tmp_path / "out" / "m.jsonl.gz"))] == [
        c.to_dict() for c in want
    ]


@pytest.mark.parametrize("kw", [dict(max_duration=2.0), dict(max_duration=1.5, max_batch_size=2, seed=3),
                                dict(max_duration=3.0, shuffle=False)])
def test_bucket_batcher_copy(dataset, kw):
    cuts = port_manifest.load_manifest(str(dataset / "flat.jsonl"))
    jcuts = jax_manifest.load_manifest(str(dataset / "flat.jsonl"))
    for epoch in (0, 1):
        want = [[c.id for c in b] for b in jax_loader.BucketBatcher(jcuts, **kw).batches(epoch)]
        got = [[c.id for c in b] for b in port_loader.BucketBatcher(cuts, **kw).batches(epoch)]
        assert got == want and len(got) >= 2


@pytest.mark.parametrize("workers", [1, 3])
def test_data_loader_copy(dataset, workers):
    """The same batches and the same arrays as the original's, both with
    their default decode backend ("auto": the native C++ kernels where they
    build, the same source on both sides), from one decode thread and from
    several."""
    cuts = port_manifest.load_manifest(str(dataset / "flat.jsonl"))
    kw = dict(max_duration=2.0, seed=1, num_workers=workers)
    want = list(jax_loader.DataLoader(cuts, **kw).epoch(1))
    got = list(port_loader.DataLoader(cuts, **kw).epoch(1))
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert g["texts"] == w["texts"]
        np.testing.assert_array_equal(g["audio_lengths"], w["audio_lengths"])
        np.testing.assert_array_equal(g["audios"], w["audios"])
        assert g["audios"].dtype == np.float32 and g["audios"].shape[1] % 1024 == 0


class _StubCodec:
    """Deterministic tokens from the waveform, for both packages' `lm_batch_from_audio`."""

    def encode(self, audios, lengths):
        n = np.asarray(lengths) // 1024
        idx = (np.abs(audios[:, : n.max() * 1024 : 1024, None]) * 1000).astype(np.int64) % 175
        return np.repeat(idx, 10, axis=2).transpose(0, 2, 1) + np.arange(10)[None, :, None] % 5, n


def test_lm_batch_from_audio_copy(dataset):
    cuts = port_manifest.load_manifest(str(dataset / "flat.jsonl"))
    batch = next(iter(port_loader.DataLoader(cuts, max_duration=2.5, shuffle=False, num_workers=1)))
    want = jax_lm_data.lm_batch_from_audio(_StubCodec(), JaxTokenGridBuilder(config=JAX_TINY), JaxByteTokenizer(), batch)
    got = port_lm_data.lm_batch_from_audio(_StubCodec(), TokenGridBuilder(config=PORT_TINY), ByteTokenizer(), batch)
    assert set(got) == set(want) == set(port_trainer.BATCH_KEYS)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["text_tokens"].shape[1] % 64 == 0
    padded = port_lm_data.lm_batch_from_audio(
        _StubCodec(), TokenGridBuilder(config=PORT_TINY), ByteTokenizer(), batch, pad_to=192
    )
    assert padded["audio_tokens"].shape[1:] == (192, 10)


def test_metrics_writer_copy(tmp_path):
    for cls, name in ((JaxMetricsWriter, "jax"), (MetricsWriter, "port")):
        w = cls(str(tmp_path / name))
        w.scalars(3, {"train/loss": 1.5, "train/lr": torch.tensor(0.25)})
        w.scalars(4, {"val/loss": 2})
        w.close()
    lines = {n: [json.loads(line) for line in open(tmp_path / n / "metrics.jsonl")] for n in ("jax", "port")}
    strip = lambda recs: [{k: v for k, v in r.items() if k != "time"} for r in recs]  # noqa: E731
    assert strip(lines["port"]) == strip(lines["jax"]) == [
        {"step": 3, "train/loss": 1.5, "train/lr": 0.25}, {"step": 4, "val/loss": 2.0}
    ]


# ---- the fit loop and the entry point -------------------------------------------------------


def test_fit_loop_validates_ranks_and_resumes(tmp_path):
    """Validation at the checkpoint cadence with the top-k accuracy set;
    checkpoints ranked by the validation means; a second loop resumes from
    the newest one; a LoRA state goes through the adapter step."""
    pt, ps = _trainer(seed=0, train_kw=dict(TRAIN_KW, num_warmup_steps=0))
    train = host_batches(pt.lm_config, 20)
    val = host_batches(pt.lm_config, 16, seed=1)
    fit = FitConfig(max_steps=4, val_interval=2, log_every=1, ckpt_dir=str(tmp_path / "ckpt"),
                    log_dir=str(tmp_path / "logs"), best_metric="val/audio_loss", max_val_batches=1)
    out = LMFitLoop(pt, lambda epoch: train, lambda: val, fit, device="cpu").run(ps)
    assert out is ps and ps.step == 4
    mgr = CheckpointManager(fit.ckpt_dir)
    assert mgr.all_steps() == [2, 4]
    metrics = mgr._meta(4)["metrics"]
    assert {"val/loss", "val/text_loss", "val/audio_loss", "val/audio_top1_acc", "val/audio_top50_acc"} <= set(metrics)
    recs = [json.loads(line) for line in open(tmp_path / "logs" / "metrics.jsonl")]
    assert [r["step"] for r in recs if "train/loss" in r] == [1, 2, 3, 4]
    assert [r["step"] for r in recs if "val/audio_loss" in r] == [2, 4]

    pt2, ps2 = _trainer(seed=3, train_kw=dict(TRAIN_KW, num_warmup_steps=0))
    LMFitLoop(pt2, lambda epoch: train, None, dataclasses.replace(fit, max_steps=5), device="cpu").run(ps2)
    # resumed from step 4; the last save has no metrics, ranks worst and yields to the two ranked ones
    assert ps2.step == 5 and ps2.opt_state.gradient_step == ps.opt_state.gradient_step
    assert CheckpointManager(fit.ckpt_dir).all_steps() == [2, 4]

    pls = pt.init_lora_state(1, port_lora.LoRAConfig(rank=2))
    lfit = dataclasses.replace(fit, max_steps=2, ckpt_dir=str(tmp_path / "lora_ckpt"), best_metric=None)
    LMFitLoop(pt, lambda epoch: train, lambda: val, lfit, device="cpu").run(pls)
    assert pls.step == 2 and any(ab["b"].abs().sum() > 0 for ab in pls.lora.values())
    with pytest.raises(ValueError):
        LMFitLoop(pt, lambda epoch: train, None, fit)  # the default device is the card; this trainer is on the CPU


def test_train_lm_cli_end_to_end(dataset, tmp_path, monkeypatch):
    """`train_lm.main --device cpu` on the synthetic WAVs: trains 2 steps
    and checkpoints, resumes to 3, then `infer_lm.main` loads that
    checkpoint and writes a WAV; `--distributed` and an enabled
    `distributed:` section are refused without a rendezvous."""
    codec_kw = dict(CODEC_KW, dmel_groups=10)  # the LM speaks 10 codebooks
    torch.manual_seed(0)
    CheckpointManager(str(tmp_path / "codec")).save(0, {"gen_params": DMelCodec(DMelCodecConfig(**codec_kw)).state_dict()})
    torch.save({"generator": BigVGAN(BigVGANConfig(**VOCODER_KW)).state_dict()}, tmp_path / "vocoder.pt")
    cfg = {
        "codec_ckpt_dir": str(tmp_path / "codec"),
        "codec_model": codec_kw,
        "slow_lm": dict(SLOW_KW, scan_layers=False, remat=True),
        "fast_lm": FAST_KW,
        "train": {"accumulate_grad": 1, "num_warmup_steps": 1, "skip_nonfinite_updates": 2},
        "fit": {"max_steps": 2, "val_interval": 100, "log_every": 1, "ckpt_dir": str(tmp_path / "lm_ckpt"),
                "log_dir": str(tmp_path / "lm_logs"), "use_mesh": False, "seed": 4},
        "data": {"train_manifest": str(dataset / "flat.jsonl"), "max_duration": 2.0},
    }
    (tmp_path / "lm.yaml").write_text(yaml.safe_dump(cfg))
    train_lm.main(["--config", str(tmp_path / "lm.yaml"), "--device", "cpu"])
    mgr = CheckpointManager(cfg["fit"]["ckpt_dir"])
    assert mgr.latest_step() == 2
    first = mgr.restore_latest_fields(None, ("params", "step", "opt_state"))
    assert first["step"] == 2 and first["opt_state"]["gradient_step"] == 2

    cfg["fit"]["max_steps"] = 3
    (tmp_path / "lm.yaml").write_text(yaml.safe_dump(cfg))
    train_lm.main(["--config", str(tmp_path / "lm.yaml"), "--device", "cpu"])
    assert mgr.latest_step() == 3
    second = mgr.restore_latest_fields(None, ("params", "step", "opt_state"))
    # resumed, not restarted: the third update went on from the second
    assert second["opt_state"]["gradient_step"] == 3
    assert not torch.equal(second["params"]["audio_head.weight"], first["params"]["audio_head.weight"])
    steps = [json.loads(line)["step"] for line in open(tmp_path / "lm_logs" / "metrics.jsonl")]
    assert steps == [1, 2, 3]

    infer_cfg = {
        "lm_ckpt_dir": cfg["fit"]["ckpt_dir"], "codec_ckpt_dir": cfg["codec_ckpt_dir"],
        "vocoder_ckpt": str(tmp_path / "vocoder.pt"), "model": codec_kw,
        "vocoder": {k: list(v) if isinstance(v, tuple) else v for k, v in VOCODER_KW.items()},
        "slow_lm": SLOW_KW, "fast_lm": FAST_KW, "inference": {"max_new_tokens": 4, "max_seq_len": 64, "top_k": 1},
    }
    (tmp_path / "infer.yaml").write_text(yaml.safe_dump(infer_cfg))
    out = tmp_path / "out.wav"
    infer_lm.main(["--config", str(tmp_path / "infer.yaml"), "--prompt", "hi", "--out", str(out), "--device", "cpu"])
    sr, wav = wavfile.read(out)
    assert sr == 24000 and wav.dtype == np.float32 and wav.size > 0 and np.isfinite(wav).all()

    # data-parallel training needs a rendezvous: without one it is refused
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="distributed training needs this process's rank"):
        train_lm.main(["--config", str(tmp_path / "lm.yaml"), "--device", "cpu", "--distributed"])
    cfg["distributed"] = {"enabled": True}
    (tmp_path / "dist.yaml").write_text(yaml.safe_dump(cfg))
    with pytest.raises(ValueError, match="distributed training needs this process's rank"):
        train_lm.main(["--config", str(tmp_path / "dist.yaml"), "--device", "cpu"])
    assert train_lm.main.__module__ == "dmel_codec_tpu_torch.cli.train_lm"
