"""LM training on the card at full width: the kernels against
`flash_attention=False`, FA launches a micro-step with and without `remat`,
updates on accumulation boundaries, LoRA, `cli.train_lm` then
`cli.infer_lm` (`card`: see tests/card.py)."""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from dmel_codec_tpu_torch.cli import infer_lm, train_lm
from dmel_codec_tpu_torch.models.lm import SlowFastLMConfig
from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
from dmel_codec_tpu_torch.train.lm_trainer import LMTrainConfig, LMTrainer
from dmel_codec_tpu_torch.train.lora import LoRAConfig
from tests.card import (
    FA_KERNELS, SR, TOL_TRAIN_GRAD, TOL_TRAIN_LOSS, codec_and_vocoder, fa_launches, free_card, lm_train_batches,
    max_err, on_card, reset_launches, set_flash, write_manifest,
)

pytestmark = pytest.mark.card

LM_BATCH, TRAIN_SEQ, LONG_SEQ, ACCUMULATE, MICRO_STEPS = 2, 1024, 2048, 2, 4
LM_CFG = SlowFastLMConfig()
FLASH_CFG = dataclasses.replace(LM_CFG, text_weight=0.01, slow=dataclasses.replace(LM_CFG.slow, flash_attention=True))
TRAIN_CFG = LMTrainConfig(accumulate_grad=ACCUMULATE, num_warmup_steps=0)
N_LAYERS = LM_CFG.slow.num_layers

def test_trainer_kernels_against_flash_attention_off():
    """The first micro-step's loss and gradients of every parameter, the
    kernels on against `flash_attention=False` (float32 parameters on the
    card, one FA, FA-dKV and FA-dQ launch a slow layer, none on the einsum
    path)."""
    dev = on_card()
    free_card()
    trainer = LMTrainer(FLASH_CFG, TRAIN_CFG, device=dev)
    state = trainer.init_state(0)
    with torch.device("meta"):
        n_params = sum(p.numel() for p in type(trainer.model)(LM_CFG).parameters())
    assert sum(p.numel() for p in state.params.values()) == n_params
    assert all(p.dtype == torch.float32 and p.is_cuda for p in state.params.values())
    batch = lm_train_batches(trainer, TRAIN_SEQ, 1, seed=4)[0]
    assert batch["text_tokens"].shape == (LM_BATCH, TRAIN_SEQ)
    wrt = list(state.params.values())
    reset_launches(*FA_KERNELS.values())
    (loss_on, _), grads_on = trainer.loss_fn(state.params, batch, wrt=wrt)
    assert fa_launches() == {"FA": N_LAYERS, "FA-dKV": N_LAYERS, "FA-dQ": N_LAYERS}, fa_launches()
    set_flash(trainer.model, False)
    (loss_off, _), grads_off = trainer.loss_fn(state.params, batch, wrt=wrt)
    assert fa_launches() == {"FA": N_LAYERS, "FA-dKV": N_LAYERS, "FA-dQ": N_LAYERS}, fa_launches()
    loss_on, loss_off = loss_on.item(), loss_off.item()
    assert math.isfinite(loss_on) and abs(loss_on - loss_off) <= TOL_TRAIN_LOSS * abs(loss_off), (loss_on, loss_off)
    worst = max((max_err(g_on, g_off) / max(g_off.abs().max().item(), 1e-30), name)
                for name, g_on, g_off in zip(state.params, grads_on, grads_off))
    assert worst[0] <= TOL_TRAIN_GRAD, worst


def test_trainer_updates_on_accumulation_boundaries():
    """4 micro-steps = 2 updates through train_step: one FA, FA-dKV and
    FA-dQ launch a slow layer a micro-step, finite metrics, the first
    micro-step's loss that of `loss_fn`, every parameter
    changing on an update step and none on the others; then a LoRA update
    (2 micro-steps) moves every adapter and no base parameter."""
    dev = on_card()
    free_card()
    trainer = LMTrainer(FLASH_CFG, TRAIN_CFG, device=dev)
    state = trainer.init_state(0)
    batches = lm_train_batches(trainer, TRAIN_SEQ, 2, seed=4)
    with torch.no_grad():
        loss_0, _ = trainer.loss_fn(state.params, batches[0])
    snapshot = {n: p.detach().clone() for n, p in state.params.items()}
    reset_launches(*FA_KERNELS.values())
    for i in range(MICRO_STEPS):
        state, metrics = trainer.train_step(state, batches[i % 2])
        want = (i + 1) * N_LAYERS
        assert fa_launches() == {"FA": want, "FA-dKV": want, "FA-dQ": want}, (i, fa_launches())
        vals = {k: float(v) for k, v in metrics.items()}
        assert all(math.isfinite(x) for x in vals.values()), vals
        if i == 0:
            assert abs(vals["train/loss"] - loss_0.item()) <= 1e-5 * abs(loss_0.item())
        changed = sum(not torch.equal(snapshot[n], p) for n, p in state.params.items())
        is_update = (i + 1) % ACCUMULATE == 0
        assert changed == (len(state.params) if is_update else 0), (i, changed)
        if is_update:
            snapshot = {n: p.detach().clone() for n, p in state.params.items()}
    assert state.step == MICRO_STEPS and state.opt_state.gradient_step == MICRO_STEPS // ACCUMULATE

    lora_state = trainer.init_lora_state(1, LoRAConfig(), base_params=state.params)
    for i in range(ACCUMULATE):
        lora_state, metrics = trainer.lora_train_step(lora_state, batches[i % 2])
    assert sum(not torch.equal(snapshot[n], p) for n, p in state.params.items()) == 0
    assert sum(bool(ab["b"].abs().sum() > 0) for ab in lora_state.lora.values()) == len(lora_state.lora)
    assert lora_state.opt_state.gradient_step == 1


@pytest.mark.parametrize("seq,flash,remat,fa,bwd", [
    (TRAIN_SEQ, True, False, N_LAYERS, N_LAYERS), (TRAIN_SEQ, False, False, 0, 0),
    (TRAIN_SEQ, True, True, 2 * N_LAYERS, N_LAYERS), (LONG_SEQ, True, True, 2 * N_LAYERS, N_LAYERS),
    (LONG_SEQ, True, False, N_LAYERS, N_LAYERS)], ids=["1024", "1024-off", "1024-remat", "2048-remat", "2048"])
def test_fa_launches_a_micro_step(seq, flash, remat, fa, bwd):
    """One accumulation cycle (2 micro-steps, 1 update) at 2 x 1024 and
    2 x 2048: FA launches once a slow layer a micro-step, twice with
    `remat` (the backward recomputes the forward), FA-dKV and FA-dQ once;
    none with `flash_attention=False`; the parameters stay finite."""
    dev = on_card()
    free_card()
    slow = dataclasses.replace(FLASH_CFG.slow, flash_attention=flash, remat=remat)
    cfg = dataclasses.replace(FLASH_CFG, slow=slow, fast=dataclasses.replace(FLASH_CFG.fast, remat=remat))
    trainer = LMTrainer(cfg, TRAIN_CFG, device=dev)
    state = trainer.init_state(0)
    batches = lm_train_batches(trainer, seq, 2, seed=4 if seq == TRAIN_SEQ else 5)
    reset_launches(*FA_KERNELS.values())
    for batch in batches:
        state, _ = trainer.train_step(state, batch)
    assert fa_launches() == {"FA": 2 * fa, "FA-dKV": 2 * bwd, "FA-dQ": 2 * bwd}, fa_launches()
    assert all(torch.isfinite(p).all() for p in state.params.values())


SMALL_LM = ("slow_lm: {hidden_size: 256, intermediate_size: 512, num_layers: 4, num_heads: 4, num_kv_heads: 2, "
            "flash_attention: true, flash_min_seq: 64}\n"
            "fast_lm: {hidden_size: 128, intermediate_size: 256, num_layers: 2, num_heads: 4, num_kv_heads: 2}\n")


def test_train_lm_entry_point(tmp_path):
    """`cli.train_lm.main` on 8 synthetic WAVs with a small LM (the flagship
    codec tokenizes): checkpoints at 2 and 4, a resumed run to 6 that moves
    every tensor, every step logged, the flash kernels launched; then
    `cli.infer_lm.main` on the result writes a finite WAV."""
    dev = on_card()
    codec, voc32 = codec_and_vocoder(dev)
    CheckpointManager(str(tmp_path / "codec")).save(0, {"gen_params": codec.state_dict()})
    torch.save({"generator": voc32.to(torch.bfloat16).state_dict()}, tmp_path / "vocoder.pt")
    del codec, voc32
    rng = np.random.default_rng(6)
    ts = [np.arange(int(SR * (3.0 + 0.25 * i))) / SR for i in range(8)]
    write_manifest(tmp_path / "train.jsonl",
                   [0.4 * np.sin(2 * math.pi * (180 + 35 * i) * t) + 0.05 * rng.standard_normal(len(t))
                    for i, t in enumerate(ts)], [f"tone number {i}" for i in range(8)])

    def train_yaml(max_steps: int) -> str:
        path = tmp_path / f"lm_{max_steps}.yaml"
        path.write_text(
            f"codec_ckpt_dir: {tmp_path / 'codec'}\ntext_tokenizer_path: null\n" + SMALL_LM
            + "train: {accumulate_grad: 2, num_warmup_steps: 1, skip_nonfinite_updates: 5}\n"
            f"fit: {{max_steps: {max_steps}, val_interval: 2, log_every: 1, ckpt_dir: {tmp_path / 'lm_ckpt'}, "
            f"log_dir: {tmp_path / 'lm_logs'}, seed: 1}}\n"
            f"data: {{train_manifest: {tmp_path / 'train.jsonl'}, max_duration: 16.0}}\n")
        return str(path)

    reset_launches(*FA_KERNELS.values())
    train_lm.main(["--config", train_yaml(4)])  # the default device: the card
    launched = fa_launches()
    mgr = CheckpointManager(str(tmp_path / "lm_ckpt"))
    assert mgr.all_steps() == [2, 4], mgr.all_steps()
    first = mgr.restore_latest_fields(None, ("params", "step", "opt_state"))
    assert first["step"] == 4 and first["opt_state"]["gradient_step"] == 2
    train_lm.main(["--config", train_yaml(6)])
    second = mgr.restore_latest_fields(None, ("params", "step", "opt_state"))
    assert mgr.all_steps() == [4, 6] and second["step"] == 6 and second["opt_state"]["gradient_step"] == 3
    moved = sum(not torch.equal(first["params"][n], p) for n, p in second["params"].items())
    steps_logged = [json.loads(line)["step"] for line in open(tmp_path / "lm_logs" / "metrics.jsonl")]
    assert steps_logged == [1, 2, 3, 4, 5, 6] and moved == len(second["params"])
    assert all(torch.isfinite(p).all() for p in second["params"].values())
    assert all(n > 0 for n in launched.values()), launched
    (tmp_path / "infer.yaml").write_text(
        f"lm_ckpt_dir: {tmp_path / 'lm_ckpt'}\ncodec_ckpt_dir: {tmp_path / 'codec'}\n"
        f"vocoder_ckpt: {tmp_path / 'vocoder.pt'}\ntext_tokenizer_path: null\n" + SMALL_LM
        + "inference: {max_new_tokens: 16, max_seq_len: 256, cache_dtype: float32}\n")
    infer_lm.main(["--config", str(tmp_path / "infer.yaml"), "--prompt", "tone number 3",
                   "--out", str(tmp_path / "out.wav"), "--seed", "1"])
    wav_sr, wav = wavfile.read(tmp_path / "out.wav")
    assert wav_sr == SR and wav.dtype == np.float32 and wav.size > 0 and np.isfinite(wav).all()
