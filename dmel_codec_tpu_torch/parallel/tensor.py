"""Megatron tensor parallelism over the mesh's model axis.

The JAX package cuts the LM's leaves (`parallel/mesh.lm_param_pspec`) and
lets XLA's partitioner add the collectives. The port places them itself,
as Megatron does:

  * `copy_to_model` before a column-parallel projection (`q/k/v_proj`,
    `gate/up_proj`, the two heads): identity forward, all-reduce of the
    input's gradient backward, since each rank's slice of the output sends
    back only its part of that gradient;
  * `reduce_from_model` after a row-parallel projection (`o_proj`,
    `down_proj`): all-reduce forward, which completes the contraction over
    the cut input features, identity backward.

A head cut over the vocabulary gives each rank its slice of the logits. The
losses and accuracies need the whole vocabulary; `vocab_parallel_cross_entropy`
and `vocab_parallel_rank` compute them from the slices with all-reduces of
[N] vectors (a row's max, sum of exponentials, the label's logit, a count),
where gathering the flagship's text logits at 2 x 1024 would move
2048 x 151936 x 4 B = 1.24 GB per rank.

Each module's group is set by `set_model_groups` (`LMTrainer.shard_state`);
with none the module runs as before.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
from torch import nn

from dmel_codec_tpu_torch.parallel.mesh import MODEL_AXIS, Spec


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: identity forward, all-reduce backward (no-op without a group)."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: all-reduce forward, identity backward (no-op without a group)."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def _vocab_offset(local_vocab: int, group) -> int:
    return dist.get_rank(group) * local_vocab


class _VocabParallelCE(torch.autograd.Function):
    """Sum over the rows with a label != ignore of -log softmax(logits)[label],
    from this rank's columns [offset, offset + V_local) of the logits."""

    @staticmethod
    def forward(ctx, logits, labels, ignore_index, group):
        local_vocab = logits.shape[-1]
        offset = _vocab_offset(local_vocab, group)
        row_max = _all_reduce(logits.max(dim=-1).values, group, dist.ReduceOp.MAX)
        exp = torch.exp(logits - row_max[:, None])
        sum_exp = _all_reduce(exp.sum(dim=-1), group)
        local = labels - offset
        here = (local >= 0) & (local < local_vocab)
        picked = logits.gather(-1, local.clamp(0, local_vocab - 1)[:, None])[:, 0]
        label_logit = _all_reduce(torch.where(here, picked, torch.zeros_like(picked)), group)
        valid = labels != ignore_index
        per_row = torch.log(sum_exp) + row_max - label_logit
        softmax = exp.div_(sum_exp[:, None])
        ctx.save_for_backward(softmax, local, here & valid, valid)
        return torch.where(valid, per_row, torch.zeros_like(per_row)).sum()

    @staticmethod
    def backward(ctx, grad):
        softmax, local, hit, valid = ctx.saved_tensors
        g = softmax * valid[:, None].to(softmax.dtype)
        rows = torch.nonzero(hit, as_tuple=True)[0]
        g[rows, local[rows]] -= 1.0
        return g * grad, None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int, group) -> torch.Tensor:
    """The summed cross entropy of float32 `logits` [N, V_local] (this rank's
    vocabulary slice) against `labels` [N] (global ids): the same value on
    every rank of `group`, and the gradient of each rank's slice."""
    return _VocabParallelCE.apply(logits, labels, ignore_index, group)


@torch.no_grad()
def vocab_parallel_rank(logits: torch.Tensor, labels: torch.Tensor, group) -> torch.Tensor:
    """For `logits` [..., V_local] (this rank's slice) and in-range global
    `labels` [...]: how many logits of the whole vocabulary come before the
    label's in a stable descending order (ties go to the lower index), as
    `train/lm_trainer.topk_accuracy` counts them on one process."""
    local_vocab = logits.shape[-1]
    offset = _vocab_offset(local_vocab, group)
    local = labels - offset
    here = (local >= 0) & (local < local_vocab)
    picked = logits.gather(-1, local.clamp(0, local_vocab - 1)[..., None])
    label_logit = _all_reduce(torch.where(here[..., None], picked, torch.zeros_like(picked)), group)
    index = torch.arange(offset, offset + local_vocab, device=logits.device)
    ahead = (logits > label_logit) | ((logits == label_logit) & (index < labels[..., None]))
    return _all_reduce(ahead.sum(-1), group)


def check_whole_heads(lm_config, model_size: int) -> None:
    """Raise unless `model_size` divides the query and key-value heads of
    both decoders: a rank runs whole heads. (The JAX package's per-leaf
    rule also cuts a head, e.g. the flagship's 128-wide `k_proj` 4 ways,
    and XLA gathers it back; explicit Megatron collectives cannot.)"""
    for which in ("slow", "fast"):
        cfg = getattr(lm_config, which)
        if cfg.num_heads % model_size or cfg.num_kv_heads % model_size:
            raise ValueError(
                f"tensor parallelism over {model_size} ranks would cut a head of the {which} decoder "
                f"({cfg.num_heads} query / {cfg.num_kv_heads} key-value heads): the model axis must divide both "
                f"decoders' head counts"
            )


def set_model_groups(lm: nn.Module, specs: Dict[str, Spec], group) -> None:
    """Give each attention and MLP block of `lm` (a `ChatMusicLM`) whose
    projections `specs` cut over the model axis the model `group`, and each
    head cut over its vocabulary the group in `lm.vocab_groups`. A block or
    head that fell back to replication keeps None: every rank runs it whole.
    A DeepSeek-V3, Kimi Linear or Nemotron-H block (latent attention, Kimi
    delta attention, Mamba-2, NoPE attention, experts) has no cut here: it
    raises NotImplementedError."""
    from dmel_codec_tpu_torch.models.deepseek_v3 import LatentAttention, MoE
    from dmel_codec_tpu_torch.models.kimi_linear import KimiDeltaAttention
    from dmel_codec_tpu_torch.models.nemotron_h import Mamba2Mixer, NoPEAttention
    from dmel_codec_tpu_torch.models.transformer import MLP, Attention

    def cut(name: str) -> bool:
        return MODEL_AXIS in specs[name]

    for prefix, m in lm.named_modules():
        if isinstance(m, (LatentAttention, KimiDeltaAttention, Mamba2Mixer, NoPEAttention, MoE)):
            raise NotImplementedError(
                f"tensor parallelism has no cut of {prefix} ({type(m).__name__}): Kimi delta attention, "
                f"Mamba-2 state-space layers, NoPE attention, latent attention and experts run on one rank "
                f"whole; use data parallelism or a Qwen2 decoder"
            )
        if isinstance(m, Attention):
            m.model_group = group if cut(f"{prefix}.q_proj.weight") else None
        elif isinstance(m, MLP):
            m.model_group = group if cut(f"{prefix}.gate_proj.weight") else None
    lm.vocab_groups = {head: group if cut(f"{head}.weight") else None for head in ("text_head", "audio_head")}
