"""Slow-fast LM trainer (port of `dmel_codec_tpu/train/lm_trainer.py`): the
train step with gradient accumulation, and the adapter-only LoRA step.

AdamW lr 1e-4, betas (0.8, 0.99), eps 1e-5, weight decay 0.08 on everything
EXCEPT biases and norm weights (embeddings are decayed), cosine schedule
with warmup 1000 -> 60k steps and floor 0.2, gradient accumulation over 60
micro-steps, clip-norm 1.0, loss weights text 0.01 / audio 1.0, top-k
accuracies with ignore ids {-100, slow_audio_pad}.

A train state holds tensors that the steps update IN PLACE (which is what
buffer donation gives the JAX trainer): `train_step(state, batch)` returns
the same state object, advanced. A full state's `params` are the trainer's
own model parameters, so a trainer carries one full state at a time.

The optimizer chain has optax's semantics (`train/optim.py`): gradients are
averaged over `accumulate_grad` micro-steps, the clip acts on the average,
the schedule advances once per update, and with `skip_nonfinite_updates`
a non-finite micro-step is dropped, up to N in a row.

With `data_parallel` set (a `parallel.mesh.DataParallel`; the fit loop sets
it under a process group) each step is the step on the union of the ranks'
batches: the losses and accuracies are this rank's shares of the global
masked means, and the gradients and the logged values are summed over the
ranks before the clip, the non-finite guard and the update, so every rank
takes the same update.

`shard_state(state, mesh, fsdp)` lays a state out on a (data, model) mesh
(`parallel/mesh.dp_tp_mesh`), as the JAX trainer's `shard_state` and
`jit_train_step(mesh, fsdp)` do: Megatron tensor parallelism over the model
axis (`parallel/tensor.py`), data parallelism over the data axis, and with
`fsdp` ZeRO-3 over the data axis (`parallel/fsdp.py`). `train_step` then
runs the step on the union of the data ranks' batches; the parameters and
Adam moments stay laid out from step to step.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.func import functional_call

from dmel_codec_tpu_torch.models.lm import IGNORE_INDEX, ChatMusicLM, SlowFastLMConfig
from dmel_codec_tpu_torch.parallel.fsdp import GatherOnUse
from dmel_codec_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, DataParallel, ParamLayout, axis_group, axis_size, global_batch, global_count,
    lm_param_shardings, shard_lm_params,
)
from dmel_codec_tpu_torch.parallel.tensor import check_whole_heads, set_model_groups, vocab_parallel_rank
from dmel_codec_tpu_torch.train.lora import (
    LoRAConfig,
    init_lora,
    lora_leaves,
    loss_and_grads_lora,
    merge_lora,
)
from dmel_codec_tpu_torch.train.optim import AccumulatingAdamW, copy_into, detached
from dmel_codec_tpu_torch.train.schedule import cosine_schedule_with_warmup
from dmel_codec_tpu_torch.utils.trace import span

BATCH_KEYS = ("text_tokens", "audio_tokens", "text_labels", "audio_labels", "valid")


@dataclasses.dataclass(frozen=True)
class LMTrainConfig:
    learning_rate: float = 1e-4
    betas: Tuple[float, float] = (0.8, 0.99)
    eps: float = 1e-5
    weight_decay: float = 0.08
    grad_clip: float = 1.0
    num_warmup_steps: int = 1000
    num_training_steps: int = 60_000
    final_lr_ratio: float = 0.2
    accumulate_grad: int = 60
    topk: Tuple[int, ...] = (1, 2, 5, 10, 20, 50)
    # > 0: a micro-step whose gradient is not finite is dropped (up to N in
    # a row; then the optimizer gives up and takes it)
    skip_nonfinite_updates: int = 0


def _decay_mask(params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """True = apply weight decay. No decay for biases and norm weights;
    embeddings are decayed (see the JAX package's `_decay_mask`)."""

    def decayed(name: str) -> bool:
        parts = name.split(".")
        if parts[-1] == "bias":
            return False
        return not (parts[-1] == "weight" and any("norm" in p.lower() for p in parts))

    return {name: decayed(name) for name in params}


def topk_accuracy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ks: Sequence[int],
    ignore_ids: Sequence[int] = (IGNORE_INDEX,),
    vocab_group=None,
) -> Dict[int, torch.Tensor]:
    """Shifted next-token top-k accuracy. logits [..., S, V], labels
    [..., S]. A label counts as a hit at k when fewer than k logits come
    before it in a stable descending order (ties go to the lower index, as
    `jax.lax.top_k` breaks them). Inside a data-parallel step the valid
    labels are counted over every rank (this rank's share of the accuracy).
    With `vocab_group` the logits are this rank's slice of the vocabulary."""
    logits = logits[..., :-1, :]
    labels = labels[..., 1:]
    vocab = logits.shape[-1] * (1 if vocab_group is None else torch.distributed.get_world_size(vocab_group))
    valid = torch.ones_like(labels, dtype=torch.bool)
    for ig in ignore_ids:
        valid &= labels != ig
    n_valid = global_count(valid.sum()).clamp(min=1)
    in_range = (labels >= 0) & (labels < vocab)
    if vocab_group is not None:
        rank = vocab_parallel_rank(logits, labels.clamp(0, vocab - 1), vocab_group)
    else:
        lab = labels.clamp(0, vocab - 1)[..., None]
        lab_logit = logits.gather(-1, lab)
        index = torch.arange(vocab, device=logits.device)
        rank = ((logits > lab_logit) | ((logits == lab_logit) & (index < lab))).sum(-1)
    return {k: ((rank < k) & valid & in_range).sum() / n_valid for k in ks}


@dataclasses.dataclass
class LMTrainState:
    """`step` counts micro-steps. `params` maps names to the trained
    tensors; `opt_state` is the `AccumulatingAdamW` over them."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: AccumulatingAdamW

    def state_dict(self) -> dict:
        return {"step": self.step, "params": detached(self.params), "opt_state": self.opt_state.state_dict()}

    def load_state_dict(self, fields: dict) -> None:
        copy_into(self.params, fields["params"], "params")
        self.opt_state.load_state_dict(fields["opt_state"])
        self.step = int(fields["step"])


@dataclasses.dataclass
class LoRATrainState:
    """Finetune state: the base params stay frozen (no optimizer moments for
    them), only the adapter tree trains. Checkpointing `lora` alone is a
    LoRA-only checkpoint."""

    step: int
    base_params: Dict[str, torch.Tensor]
    lora: Dict[str, Dict[str, torch.Tensor]]
    opt_state: AccumulatingAdamW

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "base_params": detached(self.base_params),
            "lora": {name: detached(ab) for name, ab in self.lora.items()},
            "opt_state": self.opt_state.state_dict(),
        }

    def load_state_dict(self, fields: dict) -> None:
        copy_into(self.base_params, fields["base_params"], "base_params")
        copy_into(lora_leaves(self.lora), lora_leaves(fields["lora"]), "lora")
        self.opt_state.load_state_dict(fields["opt_state"])
        self.step = int(fields["step"])


class _LossModule(nn.Module):
    """The trainer's loss as a module, so that `functional_call` can run it
    on any parameter tree. With `wrt` the gradients are taken INSIDE the
    call: under `remat` the backward pass runs the blocks again, and must
    find the same swapped-in parameters."""

    def __init__(self, lm: ChatMusicLM):
        super().__init__()
        self.lm = lm

    def forward(self, batch: Dict[str, torch.Tensor], wrt: Optional[Sequence[torch.Tensor]] = None):
        embeds = self.lm.embed_inputs(batch["text_tokens"], batch["audio_tokens"])
        embeds = embeds * batch["valid"][..., None].to(embeds.dtype)
        out = self.lm(embeds, batch["text_labels"], batch["audio_labels"])
        if wrt is None:
            return out
        return out, torch.autograd.grad(out["loss"], list(wrt))


class LMTrainer:
    def __init__(
        self,
        lm_config: SlowFastLMConfig = SlowFastLMConfig(text_weight=0.01),
        train_config: LMTrainConfig = LMTrainConfig(),
        device="cuda",
    ):
        self.lm_config = lm_config
        self.config = train_config
        self.device = torch.device(device)
        self.data_parallel: Optional[DataParallel] = None  # set by the fit loop under a process group
        self.layout: Optional[ParamLayout] = None  # set by shard_state
        self._fsdp: Optional[GatherOnUse] = None  # set by shard_state(fsdp=True)
        with torch.device(self.device):
            self.model = ChatMusicLM(lm_config)
        self.model.train()
        self._loss_module = _LossModule(self.model)
        c = train_config
        self.schedule = cosine_schedule_with_warmup(
            c.learning_rate, c.num_warmup_steps, c.num_training_steps, final_lr_ratio=c.final_lr_ratio
        )

    # ---- states ------------------------------------------------------------
    def make_optimizer(self, params: Dict[str, torch.Tensor], *, adapter: bool = False) -> AccumulatingAdamW:
        """`adapter=True`: LoRA a/b matrices get NO weight decay (decaying
        `a` while b == 0 shrinks the init with zero loss signal)."""
        decay = {name: False for name in params} if adapter else _decay_mask(params)
        return AccumulatingAdamW(params, decay, self.config, self.schedule, layout=None if adapter else self.layout)

    def init_params(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """The model's parameters, re-initialised from `seed` (no optimizer
        state): name -> the model's own parameter tensor."""
        self.model.reset_parameters(generator=torch.Generator(device=self.device).manual_seed(seed))
        return dict(self.model.named_parameters())

    def init_state(self, seed: int = 0) -> LMTrainState:
        params = self.init_params(seed)
        return LMTrainState(step=0, params=params, opt_state=self.make_optimizer(params))

    def shard_state(self, state: LMTrainState, mesh, fsdp: bool = False) -> LMTrainState:
        """Lay `state` (this trainer's full state) out on `mesh`, a
        `DeviceMesh` with a "data" and / or a "model" axis: the parameters
        become this rank's pieces (`parallel/mesh.lm_param_shardings`:
        Megatron's split over the model axis, with `fsdp` ZeRO-3 over the
        data axis too) and the trainer's own parameters, the attention, MLP
        and head modules run on them with the model group's collectives, and
        the data axis becomes `data_parallel`. The optimizer is built anew
        on the pieces (the JAX trainer re-initialises it under jit), so the
        Adam moments take the same layout. Raises when the model axis would
        cut a head."""
        if self.layout is not None:
            raise RuntimeError("this trainer's state is laid out on a mesh already")
        names = mesh.mesh_dim_names or ()
        if MODEL_AXIS in names:
            check_whole_heads(self.lm_config, axis_size(mesh, MODEL_AXIS))
        specs = lm_param_shardings(state.params, mesh, fsdp=fsdp)
        pieces = shard_lm_params(state.params, mesh, specs=specs)
        modules = dict(self.model.named_modules())
        for name, piece in pieces.items():
            owner, _, attr = name.rpartition(".")
            setattr(modules[owner], attr, nn.Parameter(piece))
        self.layout = ParamLayout(mesh, specs)
        if MODEL_AXIS in names:
            set_model_groups(self.model, specs, self.layout.model_group)
        if fsdp:
            self._fsdp = GatherOnUse(self.model, specs, self.layout.data_group)
        self.data_parallel = DataParallel(axis_group(mesh, DATA_AXIS)) if DATA_AXIS in names else None
        params = dict(self.model.named_parameters())
        return LMTrainState(step=state.step, params=params, opt_state=self.make_optimizer(params))

    def device_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A host batch (numpy arrays or tensors) on the trainer's device,
        ids and labels as int64."""
        out = {}
        for key in BATCH_KEYS:
            t = torch.as_tensor(batch[key])
            out[key] = t.to(self.device, torch.float32 if key == "valid" else torch.long)
        return out

    # ---- loss and metrics --------------------------------------------------
    def loss_fn(self, params: Dict[str, torch.Tensor], batch, wrt: Optional[Sequence[torch.Tensor]] = None):
        """(loss, out) of the model run on `params`; with `wrt`, also the
        gradients of the loss with respect to those tensors:
        ((loss, out), grads)."""
        named = {f"lm.{k}": v for k, v in params.items()}
        with self._fsdp.saved_tensors_freed() if self._fsdp is not None else contextlib.nullcontext():
            if wrt is None:
                out = functional_call(self._loss_module, named, (batch,))
                return out["loss"], out
            out, grads = functional_call(self._loss_module, named, (batch, wrt))
        return (out["loss"], out), grads

    def _depth_labels(self, batch) -> torch.Tensor:
        b, s = batch["text_labels"].shape
        c = self.lm_config.audio_codebook_count
        return torch.cat(
            [
                batch["text_labels"][:, 1:].reshape(b * (s - 1), 1),
                batch["audio_labels"][:, 1:, :].reshape(b * (s - 1), c),
            ],
            dim=1,
        )

    def _audio_accuracy(self, out, batch, prefix: str) -> Dict[str, torch.Tensor]:
        acc = topk_accuracy(
            out["audio_logits"].detach(),
            self._depth_labels(batch),
            self.config.topk,
            ignore_ids=(IGNORE_INDEX, self.lm_config.slow_audio_pad_id),
            vocab_group=self.model.vocab_groups["audio_head"],
        )
        return {f"{prefix}/audio_top{k}_acc": v for k, v in acc.items()}

    def _train_metrics(self, step: int, loss, out, grads, opt_state: AccumulatingAdamW, accuracy=None) -> Dict[str, Any]:
        """The step's metrics. Under data parallelism the gradients are first
        summed over the ranks IN PLACE (the update takes them so; a shard of
        a leaf cut over the data axis comes summed from its reduce-scatter),
        and the losses and accuracies, this rank's shares, are summed too."""
        shares = {
            "train/loss": loss.detach(),
            "train/text_loss": out["text_loss"].detach(),
            "train/audio_loss": out["audio_loss"].detach(),
        } | (accuracy or {})
        if self.data_parallel is not None:
            if self.layout is None:
                self.data_parallel.sum_(grads)
            else:
                self.data_parallel.sum_([g for n, g in zip(opt_state.names, grads) if not self.layout.data_sharded(n)])
            shares = self.data_parallel.sum_metrics(shares)
        return {
            "train/grad_norm": opt_state.global_norm(grads),
            **shares,
            "train/lr": self.schedule(step // max(1, self.config.accumulate_grad)),
        }

    @torch.no_grad()
    def eval_metrics(self, params: Dict[str, torch.Tensor], batch) -> Dict[str, torch.Tensor]:
        """Validation metrics: losses + the top-k accuracy set."""
        loss, out = self.loss_fn(params, batch)
        metrics = {"val/loss": loss, "val/text_loss": out["text_loss"], "val/audio_loss": out["audio_loss"]}
        return metrics | self._audio_accuracy(out, batch, "val")

    # ---- steps -------------------------------------------------------------
    def train_step(self, state: LMTrainState, batch) -> Tuple[LMTrainState, Dict[str, Any]]:
        """One micro-step on a device batch. The state is advanced in
        place and returned. `train/grad_norm` is the norm of this
        micro-step's own gradient, before averaging and clipping. Its parts
        run under the spans `train.loss_and_grads`, `train.metrics` and
        `train.update`."""
        with span("train.loss_and_grads"), global_batch(self.data_parallel):
            (loss, out), grads = self.loss_fn(state.params, batch, wrt=list(state.params.values()))
        with span("train.metrics"):
            with global_batch(self.data_parallel):
                accuracy = self._audio_accuracy(out, batch, "train")
            metrics = self._train_metrics(state.step, loss, out, grads, state.opt_state, accuracy)
        del out
        with span("train.update"):
            state.opt_state.update(grads)
        state.step += 1
        return state, metrics

    # ---- LoRA finetuning ---------------------------------------------------
    def _require_lora_setup(self) -> None:
        if not hasattr(self, "lora_config"):
            raise RuntimeError(
                "LoRA training requires init_lora_state(seed, lora_config, base_params) first: it "
                "fixes the adapters' rank and targets. To resume from a checkpoint, call "
                "init_lora_state with the SAME LoRAConfig, then restore the state over it."
            )

    def init_lora_state(
        self, seed: int = 0, lora_config: Optional[LoRAConfig] = None,
        base_params: Optional[Dict[str, torch.Tensor]] = None,
    ) -> LoRATrainState:
        """Base params (frozen) + adapters with b = 0: the merged model
        starts exactly at the base model. Pass `base_params` to finetune
        from loaded weights (e.g. the Qwen2 foundation)."""
        if self.layout is not None:
            raise RuntimeError("LoRA finetuning runs on a trainer whose state is not laid out on a mesh")
        self.lora_config = lora_config or LoRAConfig()
        base = base_params if base_params is not None else self.init_params(seed)
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        lora = init_lora(base, self.lora_config, gen)
        return LoRATrainState(
            step=0, base_params=base, lora=lora,
            opt_state=self.make_optimizer(lora_leaves(lora), adapter=True),
        )

    def lora_train_step(self, state: LoRATrainState, batch) -> Tuple[LoRATrainState, Dict[str, Any]]:
        self._require_lora_setup()
        with global_batch(self.data_parallel):
            (loss, out), grads = loss_and_grads_lora(
                self.loss_fn, state.base_params, state.lora, self.lora_config, batch
            )
        flat = list(lora_leaves(grads).values())
        metrics = self._train_metrics(state.step, loss, out, flat, state.opt_state)
        del out
        state.opt_state.update(flat)
        state.step += 1
        return state, metrics

    def merged_lora_params(self, state: LoRATrainState) -> Dict[str, torch.Tensor]:
        """Base + adapters folded in: for generation / eval after finetune."""
        self._require_lora_setup()
        with torch.no_grad():
            return merge_lora(state.base_params, state.lora, self.lora_config)
