"""The trainers' optimizer (the optax chain of `dmel_codec_tpu/train/lm_trainer.py`
and `codec_trainer.py`): clip by global norm -> AdamW on a schedule, behind
gradient accumulation and the non-finite guard. `config` is an
`LMTrainConfig` or a `CodecTrainConfig`: it reads `learning_rate`, `betas`,
`eps`, `weight_decay`, `grad_clip`, `accumulate_grad` and
`skip_nonfinite_updates`.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from dmel_codec_tpu_torch.utils.trace import span


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


class AccumulatingAdamW:
    """clip-by-global-norm -> AdamW(schedule), behind gradient accumulation
    and the non-finite guard, with the semantics of the JAX trainers'
    `optax.apply_if_finite(optax.MultiSteps(optax.chain(clip, adamw), k), n)`:

      * `update(grads)` is one micro-step. The accumulator keeps the running
        MEAN of the micro-step gradients; on every k-th micro-step the mean
        is clipped, AdamW takes one step at lr = schedule(number of updates
        so far), and the accumulator is cleared.
      * With `skip_nonfinite_updates` = n > 0, a micro-step whose gradient
        holds a NaN or Inf changes nothing (not even the accumulator's
        count), unless n such micro-steps came directly before it: then it
        is taken like any other, and the update it is part of turns every
        parameter non-finite (optax does that on the micro-step itself, also
        where no update is emitted: its masked update is 0 * NaN; here the
        parameters follow at the cycle's emitting micro-step).
    `torch.optim.AdamW` is optax's `adamw`: decay decoupled and times the
    scheduled lr, eps outside the root after bias correction. Parameters
    are updated in place.

    With `layout` (a `parallel.mesh.ParamLayout`: the parameters are this
    rank's shards) the clip's norm is the whole tree's and the non-finite
    guard decides once for every rank of the mesh, so that all ranks take
    the same update or skip the same micro-step."""

    def __init__(self, params: Dict[str, torch.Tensor], decay: Dict[str, bool], config, schedule, layout=None):
        self.config = config
        self.schedule = schedule
        self.layout = layout
        self.names = list(params)
        self.params = [params[n] for n in self.names]
        groups = [
            {"params": [params[n] for n in self.names if decay[n]], "weight_decay": config.weight_decay},
            {"params": [params[n] for n in self.names if not decay[n]], "weight_decay": 0.0},
        ]
        self.adamw = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=config.learning_rate, betas=tuple(config.betas), eps=config.eps
        )
        self.k = max(1, config.accumulate_grad)
        self.acc_grads = [torch.zeros_like(p) for p in self.params] if self.k > 1 else None
        self.mini_step = 0
        self.gradient_step = 0
        self.notfinite_count = 0
        self.total_notfinite = 0

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], watch: Sequence[torch.Tensor] = ()) -> None:
        """One micro-step; `grads` (in the order of the parameters) are
        consumed: the accumulation and the clip work in place on them.
        `watch`: gradients of parameters this optimizer does not train (a
        frozen subtree), which the non-finite guard tests with the rest.
        The guard and the clip, each with its host read, run under the
        spans `train.update.guard` and `train.update.clip`."""
        grads = list(grads)
        limit = self.config.skip_nonfinite_updates
        if limit > 0:
            with span("train.update.guard"):  # its host read of the flag
                if self.layout is not None:
                    finite = self.layout.all_finite([*grads, *watch])
                else:
                    finite = bool(torch.stack([torch.isfinite(g).all() for g in (*grads, *watch)]).all())
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            self.total_notfinite += 0 if finite else 1
            if not (finite or self.notfinite_count > limit):
                return
        if self.acc_grads is not None:
            # acc += (g - acc) / (n + 1): the running mean over the micro-steps
            torch._foreach_sub_(grads, self.acc_grads)
            torch._foreach_div_(grads, float(self.mini_step + 1))
            torch._foreach_add_(self.acc_grads, grads)
            emit = self.mini_step == self.k - 1
            self.mini_step = (self.mini_step + 1) % self.k
            if not emit:
                return
            grads = self.acc_grads
        with span("train.update.clip"):  # its host read of the norm
            norm = float(self.global_norm(grads))
            if not norm < self.config.grad_clip:
                torch._foreach_div_(grads, norm)
                torch._foreach_mul_(grads, self.config.grad_clip)
        lr = self.schedule(self.gradient_step)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adamw.step()
        for p in self.params:
            p.grad = None
        self.gradient_step += 1
        if self.acc_grads is not None:
            torch._foreach_zero_(self.acc_grads)

    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The norm of the whole tree of `grads` (in the parameters' order)."""
        if self.layout is not None:
            return self.layout.global_norm(self.names, grads)
        return global_norm(grads)

    def state_dict(self) -> dict:
        acc = None
        if self.acc_grads is not None:
            acc = dict(zip(self.names, self.acc_grads))
        return {
            "adamw": self.adamw.state_dict(),
            "acc_grads": acc,
            "mini_step": self.mini_step,
            "gradient_step": self.gradient_step,
            "notfinite_count": self.notfinite_count,
            "total_notfinite": self.total_notfinite,
        }

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        self.adamw.load_state_dict(sd["adamw"])
        if (sd["acc_grads"] is None) != (self.acc_grads is None):
            raise ValueError("the checkpoint's accumulate_grad setting differs from this optimizer's")
        if self.acc_grads is not None:
            for name, acc in zip(self.names, self.acc_grads):
                acc.copy_(sd["acc_grads"][name])
        for key in ("mini_step", "gradient_step", "notfinite_count", "total_notfinite"):
            setattr(self, key, int(sd[key]))


def detached(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in tree.items()}


@torch.no_grad()
def copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor], what: str) -> None:
    if set(dst) != set(src):
        raise ValueError(f"{what}: the checkpoint's tensors differ from the state's ({sorted(set(dst) ^ set(src))[:5]})")
    for name, t in dst.items():
        t.copy_(src[name])
