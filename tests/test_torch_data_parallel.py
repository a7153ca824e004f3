"""Data parallelism of the port (`parallel/mesh.py`, `parallel/multihost.py`)
on the CPU: 2 ranks on the gloo backend, each a process of
tests/torch_dp_worker.py with a timeout of its own.

A data-parallel step must be the JAX step on the union of the ranks'
batches: the JAX package shards one global batch and takes its masked means
over all of it. So for the codec's GAN step (both updates), the LM's
accumulating step and the LoRA step, rank 0 and rank 1 hold batches whose
valid lengths differ (a zero-length filler of `batch_multiple` among them),
and the 2-rank run must give the losses, metrics and parameters of a
1-process port run on the union batch and of the JAX run on it; the ranks'
parameters must stay bit-equal. Then: ranks whose shards give different
numbers of batches per epoch finish `max_steps` together, a NaN batch on one
rank makes both skip the update, and both training CLIs run `--distributed`.

Every rank's batch has the same padded length: the union of two batches is
one array only then (and the models see the padding: a mel frame near the
end of a clip reads the zeros after it).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmel_codec_tpu.lm.inputs import TokenGridBuilder as JaxTokenGridBuilder
from dmel_codec_tpu.lm.inputs import pad_grids_to_batch as jax_pad_grids_to_batch
from dmel_codec_tpu.models.codec import DMelCodecConfig as JaxDMelCodecConfig
from dmel_codec_tpu.train import codec_trainer as jax_codec_trainer
from dmel_codec_tpu.train import lm_trainer as jax_lm_trainer
from dmel_codec_tpu.train import lora as jax_lora
from dmel_codec_tpu_torch.convert import (
    codec_state_dict_from_jax, codec_train_state_from_jax, discriminator_state_dict_from_jax, lm_state_dict_from_jax,
    lora_from_jax,
)
from dmel_codec_tpu_torch.models.codec import DMelCodecConfig
from dmel_codec_tpu_torch.train import codec_trainer as port_codec_trainer
from dmel_codec_tpu_torch.train import lm_trainer as port_lm_trainer
from dmel_codec_tpu_torch.train import lora as port_lora
from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
from dmel_codec_tpu_torch.train.lora import lora_leaves
from tests.test_torch_cli_precision import _lm_files
from tests.test_torch_support import to_np
from tests.test_torch_train_codec import HOP, SMALL_KW, TRAIN_FRAMES, _write_corpus, _yaml
from tests.test_torch_train_lm import FAST_KW, SLOW_KW, SPECIALS, TRAIN_KW, assert_params_close, configs, jnp_batch

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 120  # seconds for one 2-rank job: a start takes ~5 s, the jobs here a few more

# 2 ranks against 1 process, both the port: the same float32 arithmetic but
# the union's sums split in two and added (~1e-7 relative each): metrics
# 1e-5 relative, parameters 1e-6 absolute after two Adam updates of lr <= 1e-2
# (measured: metrics 1.8e-7, parameters 1.2e-7).
DP_RTOL, DP_PARAM_ATOL = 1e-5, 1e-6


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(tmp_path: Path, job: dict, world: int = 2, env: dict | None = None,
                worker: str = "tests.torch_dp_worker", timeout: float = RANK_TIMEOUT):
    """Start `job` on `world` gloo ranks, each a `python -m WORKER JOB RANK`
    process; returns a function that waits for them (the test works on its
    side meanwhile) and gives each rank's output dict."""
    job = dict(job, world=world, port=_port())
    torch.save(job, tmp_path / "job.pt")
    base = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = []
    for rank in range(world):
        rank_env = dict(base, **{k: v.format(rank=rank, port=job["port"]) for k, v in (env or {}).items()})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", worker, str(tmp_path / "job.pt"), str(rank)],
            cwd=ROOT, env=rank_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    deadline = time.monotonic() + timeout

    def wait() -> list:
        outputs = []
        try:
            for p in procs:
                outputs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            pytest.fail(f"a rank did not finish within {timeout} s (a hang in a collective?)")
        for rank, (p, out) in enumerate(zip(procs, outputs)):
            assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out[-3000:]}"
        return [torch.load(tmp_path / f"out_{rank}.pt", weights_only=False) for rank in range(world)]

    return wait


def _codec_pair(train_kw: dict):
    """(JAX trainer, its state, port trainer, port state) on the same
    weights: the JAX trainer's jitted init, carried over."""
    jt = jax_codec_trainer.CodecTrainer(JaxDMelCodecConfig(**SMALL_KW), jax_codec_trainer.CodecTrainConfig(**train_kw))
    jstate = jax.jit(jt.init_state, static_argnums=1)(jax.random.PRNGKey(0), TRAIN_FRAMES)
    pt = port_codec_trainer.CodecTrainer(DMelCodecConfig(**SMALL_KW), port_codec_trainer.CodecTrainConfig(**train_kw),
                                         device="cpu")
    tree = partial(jax.tree_util.tree_map, np.asarray)
    return jt, jstate, pt, codec_train_state_from_jax(pt, tree(jstate.gen_params), tree(jstate.disc_params))


def _lm_pair(train_kw: dict):
    """As `_codec_pair`, for the LM trainer (`tests/test_torch_train_lm.py`'s
    small configs)."""
    jcfg, pcfg = configs()
    jt = jax_lm_trainer.LMTrainer(jcfg, jax_lm_trainer.LMTrainConfig(**train_kw))
    js = jax.jit(jt.init_state)(jax.random.PRNGKey(0))
    pt = port_lm_trainer.LMTrainer(pcfg, port_lm_trainer.LMTrainConfig(**train_kw), device="cpu")
    ps = pt.init_state(0)
    pt.model.load_state_dict(lm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, js.params), pcfg))
    return jt, js, pt, ps


def union(a: dict, b: dict) -> dict:
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def assert_close_metrics(got: dict, want: dict, rtol: float, what: str) -> None:
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        g, w = float(got[k]), float(want[k])
        assert abs(g - w) <= rtol * max(abs(w), 1e-7), (what, k, g, w)


def assert_ranks_equal(outs: list, field: str) -> None:
    a, b = (o["state"][field] for o in outs)
    flat = lora_leaves if field == "lora" else (lambda t: t)
    for name, t in flat(a).items():
        assert torch.equal(t, flat(b)[name]), name


# ---- the codec's GAN step -------------------------------------------------------------


def _codec_shards(n_steps: int):
    """Per step: rank 0 two clips (full and 3/4 length), rank 1 one clip of
    half length and a zero-length filler; each with its decoder noise."""
    rng = np.random.default_rng(5)
    samples = HOP * TRAIN_FRAMES
    shards = [[], []]
    for _ in range(n_steps):
        audio = (rng.standard_normal((4, samples)) * 0.1).astype(np.float32)
        audio[3] = 0.0
        noise = rng.standard_normal((4, TRAIN_FRAMES, 120)).astype(np.float32)
        lengths = np.array([samples, samples * 3 // 4, samples // 2, 0], np.int32)
        for rank, rows in enumerate((slice(0, 2), slice(2, 4))):
            shards[rank].append({"audios": audio[rows], "audio_lengths": lengths[rows], "noise": noise[rows]})
    return shards


def test_codec_gan_step_on_two_ranks_is_the_union_step(tmp_path):
    """Two steps (the discriminator's update, then the generator's through
    the updated discriminator): the 2-rank run against one process on the
    union batch (1e-5, 1e-6) and against the JAX trainer on it (losses 2e-4,
    gradient norms 1e-3, parameters 2e-5: `tests/test_torch_train_codec.py`'s
    tolerances); the ranks' parameters bit-equal, and no NaN from the
    filler."""
    train_kw = dict(learning_rate=1e-3, num_warmup_steps=2)
    jt, jstate, pt, pstate = _codec_pair(train_kw)
    job = {"scenario": "steps", "model": "codec", "codec_kw": SMALL_KW, "train_kw": train_kw,
           "gen": {k: v.clone() for k, v in pt.codec.state_dict().items()},
           "disc": {k: v.clone() for k, v in pt.discriminator.state_dict().items()}}
    job["batches"] = shards = _codec_shards(2)
    ranks = start_ranks(tmp_path, job)

    step_fn = jax.jit(jt.train_step)
    ones, wants = [], []
    for i, (b0, b1) in enumerate(zip(*shards)):
        whole = union(b0, b1)
        jstate, want = step_fn(jstate, {k: jnp.asarray(v) for k, v in whole.items()}, jax.random.PRNGKey(i))
        pstate, one = pt.train_step(pstate, pt.device_batch(whole))
        ones.append(one)
        wants.append(want)
    outs = ranks()
    for i, (one, want) in enumerate(zip(ones, wants)):
        for out in outs:
            got = out["metrics"][i]
            assert all(np.isfinite(v) for v in got.values()), got
            assert_close_metrics(got, one, DP_RTOL, f"step {i} vs one process")
            for name in want:
                rtol = 1e-3 if "grad_norm" in name else 2e-4
                np.testing.assert_allclose(got[name], float(want[name]), rtol=rtol, atol=1e-7, err_msg=f"step {i} {name}")
    for field in ("gen_params", "disc_params"):
        assert_ranks_equal(outs, field)
    want_trees = {"gen_params": codec_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.gen_params)),
                  "disc_params": discriminator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.disc_params))}
    for field, mine in (("gen_params", pstate.gen_params), ("disc_params", pstate.disc_params)):
        got = outs[0]["state"][field]
        assert set(got) == set(mine) == set(want_trees[field])
        for name, p in got.items():
            np.testing.assert_allclose(p.numpy(), mine[name].detach().numpy(), rtol=0, atol=DP_PARAM_ATOL, err_msg=name)
            np.testing.assert_allclose(p.numpy(), want_trees[field][name].numpy(), rtol=0, atol=2e-5, err_msg=name)
    assert outs[0]["state"]["gen_opt_state"]["gradient_step"] == 2


# ---- the LM's accumulating step and the LoRA step -------------------------------------------


def _lm_shards(jcfg, n_steps: int, pad_to: int = 64):
    """Per micro-step: rank 0 two grids of 20 and 13 audio frames, rank 1 one
    of 9 and the grid of a filler (no text, no audio), all padded to one
    length."""
    rng = np.random.default_rng(7)
    gridder = JaxTokenGridBuilder(config=jcfg)
    shards = [[], []]
    for _ in range(n_steps):
        for rank, frames in enumerate(((20, 13), (9, 0))):
            grids = [gridder.build_train_grid(rng.integers(0, 500, size=5 if f else 0), rng.integers(0, 175, size=(f, 10)))
                     for f in frames]
            shards[rank].append(jax_pad_grids_to_batch(grids, jcfg, pad_to=pad_to))
    return shards


def _lm_job(pt, **extra) -> dict:
    return {"scenario": "steps", "model": "lm", "slow_kw": SLOW_KW, "fast_kw": FAST_KW, "specials": SPECIALS,
            "params": {k: v.detach().clone() for k, v in pt.model.state_dict().items()}, **extra}


def test_lm_accumulating_step_on_two_ranks_is_the_union_step(tmp_path):
    """accumulate_grad = 2, four micro-steps (two updates, the second at a
    non-zero lr), the einsum attention: every metric against one process on
    the union batch (1e-5) and against JAX (1e-4, as
    `tests/test_torch_train_lm.py`), the parameters too (1e-6; JAX 1e-5 +
    1e-4 |p|), the ranks' parameters and accumulators bit-equal."""
    jt, js, pt, ps = _lm_pair(TRAIN_KW)
    shards = _lm_shards(jt.lm_config, 4)
    assert not np.array_equal(shards[0][0]["valid"].sum(1), shards[1][0]["valid"].sum(1))
    ranks = start_ranks(tmp_path, _lm_job(pt, train_kw=TRAIN_KW, batches=shards))
    step = jax.jit(jt.train_step)
    ones, wants = [], []
    for b0, b1 in zip(*shards):
        whole = union(b0, b1)
        js, want = step(js, jnp_batch(whole))
        ps, one = pt.train_step(ps, pt.device_batch(whole))
        ones.append(one)
        wants.append(want)
    outs = ranks()
    for i, (one, want) in enumerate(zip(ones, wants)):
        for out in outs:
            assert_close_metrics(out["metrics"][i], one, DP_RTOL, f"micro-step {i} vs one process")
            assert_close_metrics(out["metrics"][i], want, 1e-4, f"micro-step {i} vs JAX")
    assert_ranks_equal(outs, "params")
    got = outs[0]["state"]["params"]
    for name, p in got.items():
        np.testing.assert_allclose(p.numpy(), ps.params[name].detach().numpy(), rtol=0, atol=DP_PARAM_ATOL, err_msg=name)
    assert_params_close(got, js.params, pt.lm_config)
    assert outs[0]["state"]["opt_state"]["gradient_step"] == outs[1]["state"]["opt_state"]["gradient_step"] == 2


def test_lora_step_on_two_ranks_is_the_union_step(tmp_path):
    """Two adapter-only steps at lr 1e-2: metrics and adapters against one
    process on the union batch and against JAX, the base untouched, the
    ranks' adapters bit-equal."""
    kw = dict(accumulate_grad=1, num_warmup_steps=0, learning_rate=1e-2, num_training_steps=10)
    jt, js, pt, ps = _lm_pair(kw)
    jls = jt.init_lora_state(jax.random.PRNGKey(1), jax_lora.LoRAConfig(rank=4, alpha=8.0), base_params=js.params)
    pls = pt.init_lora_state(1, port_lora.LoRAConfig(rank=4, alpha=8.0), base_params=ps.params)
    with torch.no_grad():
        for name, t in lora_leaves(lora_from_jax(jax.tree_util.tree_map(np.asarray, jls.lora))).items():
            lora_leaves(pls.lora)[name].copy_(t)
    shards = _lm_shards(jt.lm_config, 2)
    job = _lm_job(pt, train_kw=kw, batches=shards, lora_kw=dict(rank=4, alpha=8.0),
                  lora={k: v.detach().clone() for k, v in lora_leaves(pls.lora).items()})
    ranks = start_ranks(tmp_path, job)
    step = jax.jit(jt.lora_train_step)
    ones, wants = [], []
    for b0, b1 in zip(*shards):
        whole = union(b0, b1)
        jls, want = step(jls, jnp_batch(whole))
        pls, one = pt.lora_train_step(pls, pt.device_batch(whole))
        ones.append(one)
        wants.append(want)
    outs = ranks()
    for i, (one, want) in enumerate(zip(ones, wants)):
        for out in outs:
            assert_close_metrics(out["metrics"][i], one, DP_RTOL, f"step {i} vs one process")
            assert_close_metrics(out["metrics"][i], want, 1e-4, f"step {i} vs JAX")
    assert_ranks_equal(outs, "lora")
    want = lora_leaves(lora_from_jax(jax.tree_util.tree_map(np.asarray, jls.lora)))
    for name, t in lora_leaves(outs[0]["state"]["lora"]).items():
        np.testing.assert_allclose(t.numpy(), lora_leaves(pls.lora)[name].detach().numpy(), rtol=0, atol=DP_PARAM_ATOL)
        np.testing.assert_allclose(t.numpy(), to_np(want[name]), atol=1e-5, rtol=1e-4, err_msg=name)
    assert all(torch.equal(outs[0]["state"]["base_params"][n], p.detach()) for n, p in pls.base_params.items())


# ---- the loop's lockstep, the non-finite guard, the entry points --------------------------


def test_a_nan_batch_on_one_rank_skips_the_update_on_both(tmp_path):
    """`skip_nonfinite_updates = 2`: rank 1's second micro-step has a NaN
    `valid` weight. The summed gradient is NaN on both ranks, so both drop
    the micro-step (one non-finite count each, the accumulation not
    advanced), and both end where one process on the union batches does."""
    kw = dict(TRAIN_KW, skip_nonfinite_updates=2)
    pt = port_lm_trainer.LMTrainer(configs()[1], port_lm_trainer.LMTrainConfig(**kw), device="cpu")
    ps = pt.init_state(0)
    shards = _lm_shards(configs()[0], 5)
    shards[1][1]["valid"] = shards[1][1]["valid"].astype(np.float32)
    shards[1][1]["valid"][0, 3] = np.nan
    ranks = start_ranks(tmp_path, _lm_job(pt, train_kw=kw, batches=shards))
    for b0, b1 in zip(*shards):
        ps, _ = pt.train_step(ps, pt.device_batch(union(b0, b1)))
    outs = ranks()
    for out in outs:
        assert not np.isfinite(out["metrics"][1]["train/grad_norm"])
        opt = out["state"]["opt_state"]
        assert (opt["total_notfinite"], opt["gradient_step"], opt["mini_step"]) == (1, 2, 0)
    assert ps.opt_state.total_notfinite == 1
    assert_ranks_equal(outs, "params")
    for name, p in outs[0]["state"]["params"].items():
        np.testing.assert_allclose(p.numpy(), ps.params[name].detach().numpy(), rtol=0, atol=DP_PARAM_ATOL, err_msg=name)


def test_unequal_batch_counts_finish_max_steps_together(tmp_path):
    """`LMFitLoop` with rank 0's epoch 3 batches long and rank 1's 2: the
    loop counts steps, so both reach `max_steps` = 5 (rank 1 in its third
    epoch) without waiting on each other; rank 0 alone writes the
    checkpoints and the metrics; the ranks end bit-equal."""
    shards = _lm_shards(configs()[0], 3)
    shards[1] = shards[1][:2]
    fit_kw = dict(max_steps=5, val_interval=2, log_every=1, ckpt_dir=str(tmp_path / "ckpt"),
                  log_dir=str(tmp_path / "logs"), seed=3)
    job = {"scenario": "fit", "slow_kw": SLOW_KW, "fast_kw": FAST_KW, "specials": SPECIALS, "train_kw": TRAIN_KW,
           "batches": shards, "fit_kw": fit_kw}
    outs = start_ranks(tmp_path, job)()
    assert outs[0]["epochs"] == [0, 1] and outs[1]["epochs"] == [0, 1, 2]
    assert all(o["state"]["step"] == 5 for o in outs)
    assert_ranks_equal(outs, "params")
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [4, 5]
    lines = (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 5  # one writer: rank 0


@pytest.mark.parametrize("cli", ["train_codec", "train_lm"])
def test_training_cli_runs_distributed(tmp_path, cli):
    """`main(["--config", ..., "--distributed", "--device", "cpu"])` in two
    processes given torchrun's environment: each rank joins the gloo group,
    trains its shard of a 4-clip manifest (native decode) for 2 steps of the
    data-parallel path, rank 0 writes the checkpoint at step 2, and the
    group is gone when `main` returns."""
    manifest = _write_corpus(tmp_path)
    if cli == "train_codec":
        config = Path(_yaml(tmp_path, manifest, 2))
        cfg = yaml.safe_load(config.read_text())
        cfg["fit"]["use_mesh"] = True
        cfg["data"]["audio_backend"] = "native"
        fields = ("step", "gen_params", "disc_params")
    else:
        files = _lm_files(tmp_path)
        cfg = {
            "codec_ckpt_dir": files["codec_ckpt_dir"], "codec_model": files["codec_kw"],
            "slow_lm": files["slow_lm"], "fast_lm": files["fast_lm"],
            "train": {"accumulate_grad": 1, "num_warmup_steps": 1},
            "fit": {"max_steps": 2, "val_interval": 100, "log_every": 1, "seed": 4},
            "data": {"train_manifest": str(manifest), "max_duration": 0.3, "audio_backend": "native"},
        }
        fields = ("step", "params")
    cfg["fit"].update(ckpt_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"))
    config = tmp_path / "dist.yaml"
    config.write_text(yaml.safe_dump(cfg))
    env = {"RANK": "{rank}", "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "{port}"}
    job = {"scenario": "cli", "cli": cli, "argv": ["--config", str(config), "--distributed", "--device", "cpu"]}
    outs = start_ranks(tmp_path, job, env=env)()
    assert [o["group_left_up"] for o in outs] == [False, False]
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.all_steps() == [2]
    restored = mgr.restore_latest_fields(None, fields)
    assert restored["step"] == 2
    assert all(torch.isfinite(t).all() for t in restored[fields[1]].values())
    # rank 0 alone logs: a line per step, and the codec's validation at step 2
    assert len((tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()) == 2 + (cli == "train_codec")
