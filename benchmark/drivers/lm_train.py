"""Closed loop of LM training micro-steps: `LMTrainer.train_step` on seeded
token grids, as an LM trainer runs it.

Traffic parameters (the workload file's "params"):
  batch, seq        rows and positions of a micro-step's grid
  text_min, text_max  text tokens a row, before its audio frames
  pad_max           positions a row leaves padded at its end, at most
  pool              distinct grids made in set-up and sent in turn (the
                    first three are the checked steps)
  train             the trainer's LMTrainConfig
  limits            each compared number's limit
Every row is a training grid as `TokenGridBuilder.build_train_grid` lays it
out (specials, text, modality pads, silence, audio frames, end tokens), with
text and audio ids drawn from the seed, padded as `pad_grids_to_batch`
pads. Set-up runs the first three micro-steps through the window's own
call, on the very state the window then trains, and records what the check
compares: each step's loss, every leaf's gradient as the optimizer holds
it after step 1, every leaf's change over the three.

Spans: "train.step".
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import weights
from benchmark.harness.trace import span
from benchmark.reference import lm as ref_lm
from benchmark.reference import precision

CHECKED_STEPS = 3


def lm_config(cfg: dict, flash: bool):
    from dmel_codec_tpu_torch.models.lm import SlowFastLMConfig
    from dmel_codec_tpu_torch.models.transformer import TransformerConfig

    keys = ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads", "num_kv_heads",
            "rms_norm_eps", "rope_theta")
    dec = {part: TransformerConfig(**{k: cfg[part][k] for k in keys}, flash_attention=flash) for part in ("slow", "fast")}
    ids = {k: cfg[k] for k in ("audio_codebook_count", "audio_codebook_size", "bos_token_id", "eos_token_id",
                              "start_of_human_id", "end_of_human_id", "start_of_robot_id", "end_of_robot_id",
                              "start_of_music_id", "end_of_music_id", "text_pad_id", "slow_audio_pad_id",
                              "fast_audio_pad_id", "text_weight", "audio_weight")}
    return SlowFastLMConfig(slow=dec["slow"], fast=dec["fast"], **ids)


def make_batches(cfg: dict, p: dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """`pool` training batches [batch, seq] from the seed (host arrays)."""
    c, size, b, s = cfg["audio_codebook_count"], cfg["audio_codebook_size"], p["batch"], p["seq"]
    rng = np.random.default_rng(seed)
    shift = np.arange(c) * size
    silence = np.asarray(cfg["audio_silence_id"], np.int64) + shift
    out = []
    for _ in range(p["pool"]):
        text = np.full((b, s), cfg["text_pad_id"], np.int64)
        audio = np.full((b, s, c), cfg["slow_audio_pad_id"], np.int64)
        labels = np.full((b, s, c + 1), ref_lm.IGNORE, np.int64)
        valid = np.zeros((b, s), np.float32)
        for r in range(b):
            lt = int(rng.integers(p["text_min"], p["text_max"] + 1))
            n = s - int(rng.integers(0, p["pad_max"] + 1))
            la = n - lt - 14  # the rest of the row: 6 specials, two silences of 3, 2 end tokens
            t_row = np.concatenate([[cfg["start_of_human_id"], cfg["bos_token_id"]],
                                    rng.integers(0, cfg["bos_token_id"], lt),
                                    [cfg["eos_token_id"], cfg["end_of_human_id"], cfg["start_of_robot_id"],
                                     cfg["start_of_music_id"]],
                                    np.full(2 * 3 + la, cfg["text_pad_id"]), [cfg["end_of_music_id"], cfg["end_of_robot_id"]]])
            pad = np.full((lt + 8 - 2, c), cfg["slow_audio_pad_id"])
            a_row = np.concatenate([pad, np.tile(silence, (3, 1)), rng.integers(0, size, (la, c)) + shift,
                                    np.tile(silence, (3, 1)), np.full((2, c), cfg["slow_audio_pad_id"])])
            text[r, :n], audio[r, :n], valid[r, :n] = t_row, a_row, 1.0
            labels[r, :n, 0], labels[r, :n, 1:] = t_row, a_row
        out.append({"text_tokens": text, "audio_tokens": audio, "text_labels": labels[:, :, 0],
                    "audio_labels": labels[:, :, 1:], "valid": valid})
    return out


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> float:
    """The worst leaf's |program norm - reference norm| over the larger of
    the reference leaf's norm and the median leaf's."""
    names = [n for n in ref if keep(n)]
    median = float(np.median([ref[n] for n in names]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], median) for n in names)


class Driver:
    spans = ("train.",)

    def __init__(self, cell, seed: int, device: torch.device):
        self.cfg = cell.config
        self.p = cell.workload["params"]
        self.seed = int(seed)
        self.device = device
        self.k = 0
        self.seen: Dict[str, object] = {}

    def _device_batch(self, b: dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, torch.float32 if k == "valid" else torch.long) for k, v in b.items()}

    def setup(self) -> None:
        from dmel_codec_tpu_torch.train.lm_trainer import LMTrainConfig, LMTrainer, LMTrainState
        from dmel_codec_tpu_torch.utils.precision import strict_float32

        strict_float32()  # as the training entry point does before it builds a model
        t = self.p["train"]
        train_cfg = LMTrainConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in t.items()})
        self.trainer = LMTrainer(lm_config(self.cfg, flash=True), train_cfg, device=self.device)
        params = weights.make(ref_lm.param_shapes(self.cfg), self.seed, torch.float32, self.device)
        self.trainer.model.load_state_dict(params, strict=True)
        del params
        leaves = dict(self.trainer.model.named_parameters())
        self.state = LMTrainState(step=0, params=leaves, opt_state=self.trainer.make_optimizer(leaves))
        self.batches = [self._device_batch(b) for b in make_batches(self.cfg, self.p, self.seed)]
        # the checked steps, through the window's own call on the window's state
        start = {n: v.detach().clone() for n, v in leaves.items()}
        losses = []
        for i in range(CHECKED_STEPS):
            self.state, metrics = self.trainer.train_step(self.state, self.batches[i])
            losses.append(float(metrics["train/loss"]))
            if i == 0:
                acc = self.state.opt_state.acc_grads
                self.seen["grad"] = {n: float(g.norm()) for n, g in zip(self.state.opt_state.names, acc)}
        self.seen["loss"] = losses
        self.seen["change"] = {n: float((v.detach() - start[n]).norm()) for n, v in leaves.items()}
        del start
        self.k = CHECKED_STEPS
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> dict:
        batch = self.batches[self.k % len(self.batches)]
        self.k += 1
        start = time.perf_counter()
        with span("train.step"):
            self.state, _ = self.trainer.train_step(self.state, batch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        end = time.perf_counter()
        b, s = batch["text_tokens"].shape
        return {"start": start, "end": end, "tokens": b * s}

    def release(self) -> None:
        del self.trainer, self.state
        self.batches = None

    # ---- the check --------------------------------------------------------
    def reference_steps(self, tf32: bool = False, rows=None) -> Dict[str, object]:
        """The reference through the checked steps from the same seed and
        batches: each step's loss, the first gradient's leaf norms and
        every leaf's change over the steps; `rows` keeps only those rows of
        every batch (a fault the check must catch)."""
        t = dict(self.p["train"])
        params = weights.make(ref_lm.param_shapes(self.cfg), self.seed, torch.float32, self.device)
        start = {n: v.clone() for n, v in params.items()}
        batches = [self._device_batch(b) for b in make_batches(self.cfg, self.p, self.seed)[:CHECKED_STEPS]]
        state, acc, losses, grad = {}, None, [], None
        k = max(1, t["accumulate_grad"])
        with precision(tf32):
            for i, batch in enumerate(batches):
                loss, g = ref_lm.loss_and_grads(params, self.cfg, batch, rows)
                losses.append(loss)
                if grad is None:
                    grad = {n: float(v.norm()) for n, v in g.items()}
                acc = g if acc is None else {n: acc[n] + (g[n] - acc[n]) / (i % k + 1) for n in g}
                if i % k == k - 1:
                    ref_lm.adamw_update(params, acc, state, t)
                    acc = None
        change = {n: float((params[n] - start[n]).norm()) for n in params}
        return {"loss": losses, "grad": grad, "change": change}

    def numbers(self, got: Dict[str, object], ref: Dict[str, object]) -> Dict[str, float]:
        """loss: the worst step's |loss - reference| / |reference|; grad and
        change: the worst leaf's gap of norms (leaf_gaps), leaving out of
        the change the leaves whose reference gradient is under a
        thousandth of the median leaf's (they move by round-off alone)."""
        g = ref["grad"]
        floor = 1e-3 * float(np.median(list(g.values())))
        return {
            "loss": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"])),
            "grad": leaf_gaps(got["grad"], g, lambda n: True),
            "change": leaf_gaps(got["change"], ref["change"], lambda n: g[n] >= floor),
        }

    controls = ("tf32", "half_batch")

    def check(self, records: List[dict], control: Optional[str] = None) -> List[dict]:
        """The numbers of the program's checked steps against the reference;
        with a control, of the reference with TF32 on ("tf32") or on half of
        each batch, the mean over the rest ("half_batch") in its place."""
        ref = self.reference_steps()
        got = {None: lambda: self.seen, "tf32": lambda: self.reference_steps(tf32=True),
               "half_batch": lambda: self.reference_steps(rows=slice(0, self.p["batch"] // 2))}[control]()
        return [{"name": n, "value": v, "limit": float(self.p["limits"][n])} for n, v in self.numbers(got, ref).items()]
