"""Pipeline parallelism (GPipe) for a decoder over a "stage" group (port of
`dmel_codec_tpu/parallel/pipeline.py`).

The decoder's blocks are split into S contiguous stages, one per rank of
the group, and a batch into M microbatches that stream through the stages:
at tick t stage s runs its blocks on microbatch t - s, received from stage
s - 1 (stage 0 takes it from the input), and sends the result on to stage
s + 1 (send / recv). Microbatch m leaves the last stage at tick m + S - 1:
M + S - 1 ticks, with an (S - 1) / M bubble. The last stage's hidden state
is broadcast to every rank (the JAX function's `psum`) and the final
RMSNorm applied there.

The backward runs the schedule in reverse: the last stage starts from the
output's gradient, each stage backpropagates through its blocks microbatch
by microbatch (the activations each tick kept) and sends the input's
gradient to the stage before it; stage 0's is broadcast as the input's
gradient. Each rank ends with the gradients of its own stage's parameters.
Every rank of the group must run the backward of the (replicated) output:
they all compute the same loss of it, and the schedule takes the last
stage's gradient of the output.

The JAX function works on the stacked scan layout ([L, ...] leaves cut
[S, L/S, ...]); the port keeps `Decoder.layers`, so a stage is the module
range `split_stage_params` gives.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from dmel_codec_tpu_torch.parallel.mesh import mesh_device_type

STAGE_AXIS = "stage"


def stage_mesh(n_stages: int) -> DeviceMesh:
    """1-D pipeline mesh over the first `n_stages` ranks (every rank of the
    process group must call it)."""
    if n_stages > dist.get_world_size():
        raise ValueError(f"{n_stages} stages need {n_stages} ranks, the group has {dist.get_world_size()}")
    return DeviceMesh(mesh_device_type(), torch.arange(n_stages), mesh_dim_names=(STAGE_AXIS,))


def split_stage_params(layers: Sequence[nn.Module], n_stages: int) -> List[nn.ModuleList]:
    """The decoder's blocks as `n_stages` contiguous stages of L / S blocks."""
    n = len(layers)
    if n % n_stages:
        raise ValueError(f"{n} layers not divisible by {n_stages} stages")
    per = n // n_stages
    return [nn.ModuleList(layers[s * per: (s + 1) * per]) for s in range(n_stages)]


class _Schedule:
    """One stage's side of the GPipe schedule."""

    def __init__(self, blocks: nn.ModuleList, group, n_stages: int, n_microbatches: int, run_blocks: Callable):
        self.blocks, self.group, self.s, self.m = blocks, group, n_stages, n_microbatches
        self.stage = dist.get_rank(group)
        self.run_blocks = run_blocks

    def peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def forward(self, x: torch.Tensor, keep: bool):
        """Returns (the last stage's hidden states broadcast to every rank,
        [(input leaf, output)] per microbatch when `keep`)."""
        stage, last = self.stage, self.s - 1
        micro = x.chunk(self.m)
        kept, outs, sends = [], [], []
        for t in range(self.m + self.s - 1):
            i = t - stage
            if not 0 <= i < self.m:
                continue
            if stage == 0:
                inp = micro[i]
            else:
                inp = torch.empty_like(micro[i])
                dist.recv(inp, self.peer(stage - 1), group=self.group)
            with torch.enable_grad():
                inp = inp.detach().requires_grad_(keep)
                out = self.run_blocks(inp)
            if keep:
                kept.append((inp, out))
            if stage < last:
                sends.append(dist.isend(out.detach().contiguous(), self.peer(stage + 1), group=self.group))
            else:
                outs.append(out.detach())
        for request in sends:
            request.wait()
        hidden = torch.cat(outs) if stage == last else torch.empty_like(x)
        if self.s > 1:
            dist.broadcast(hidden, self.peer(last), group=self.group)
        return hidden, kept

    def backward(self, grad: torch.Tensor, kept, params: Sequence[torch.Tensor]):
        """Returns (the input's gradient on every rank, this stage's parameter gradients)."""
        stage, last = self.stage, self.s - 1
        grad_micro = grad.chunk(self.m)
        param_grads = [torch.zeros_like(p) for p in params]
        grad_in = [None] * self.m
        sends = []
        for t in reversed(range(self.m + self.s - 1)):
            i = t - stage
            if not 0 <= i < self.m:
                continue
            inp, out = kept[i]
            if stage == last:
                g = grad_micro[i].contiguous()
            else:
                g = torch.empty_like(out)
                dist.recv(g, self.peer(stage + 1), group=self.group)
            grads = torch.autograd.grad(out, [inp, *params], g, allow_unused=True)
            for acc, pg in zip(param_grads, grads[1:]):
                if pg is not None:
                    acc += pg
            if stage > 0:
                sends.append(dist.isend(grads[0].contiguous(), self.peer(stage - 1), group=self.group))
            else:
                grad_in[i] = grads[0]
        for request in sends:
            request.wait()
        grad_x = torch.cat(grad_in) if stage == 0 else torch.empty_like(grad)
        if self.s > 1:
            dist.broadcast(grad_x, self.peer(0), group=self.group)
        return grad_x, param_grads


class _Pipelined(torch.autograd.Function):
    @staticmethod
    def forward(ctx, schedule: _Schedule, keep: bool, x, *params):
        hidden, kept = schedule.forward(x, keep)
        ctx.schedule, ctx.kept = schedule, kept
        return hidden

    @staticmethod
    def backward(ctx, grad):
        params = [p for p in ctx.schedule.blocks.parameters()]
        grad_x, param_grads = ctx.schedule.backward(grad, ctx.kept, params)
        ctx.kept = None
        return (None, None, grad_x, *param_grads)


def pipelined_decoder(decoder, group, n_microbatches: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """Pipelined forward of `decoder` (a `models.transformer.Decoder`) over
    `group` (a process group, or a `stage_mesh`): this rank runs stage
    `rank` of `split_stage_params(decoder.layers, size)`.

    Returns fn(inputs_embeds [B, S, H]) -> hidden [B, S, H] (on every rank,
    after the final norm), equal to `decoder(inputs_embeds)[0]` and
    differentiable with respect to the input and this stage's parameters.
    B must divide by `n_microbatches`. With `flash_attention` and
    S >= `flash_min_seq` the stage's blocks run the flash kernel (FA, and
    FA-dKV / FA-dQ in the backward) on a CUDA tensor."""
    from dmel_codec_tpu_torch.models.transformer import rope_cos_sin

    if isinstance(group, DeviceMesh):
        group = group.get_group(STAGE_AXIS)
    elif group is None:
        group = dist.group.WORLD
    n_stages = dist.get_world_size(group)
    cfg = decoder.config
    blocks = split_stage_params(decoder.layers, n_stages)[dist.get_rank(group)]

    def forward(inputs_embeds: torch.Tensor) -> torch.Tensor:
        b, s, _ = inputs_embeds.shape
        if b % n_microbatches:
            raise ValueError(f"batch {b} not divisible by {n_microbatches} microbatches")
        mb, dev = b // n_microbatches, inputs_embeds.device
        cos, sin = rope_cos_sin(torch.arange(s, device=dev).expand(mb, s), cfg.head_dim, cfg.rope_theta)
        flash = cfg.flash_attention and s >= cfg.flash_min_seq
        mask = None if flash else torch.ones(s, s, dtype=torch.bool, device=dev).tril().expand(mb, s, s)

        def run_blocks(x: torch.Tensor) -> torch.Tensor:
            for block in blocks:
                x = block(x, cos, sin, mask, None, None, True)
            return x

        schedule = _Schedule(blocks, group, n_stages, n_microbatches, run_blocks)
        params = list(blocks.parameters())
        keep = torch.is_grad_enabled() and (inputs_embeds.requires_grad or any(p.requires_grad for p in params))
        hidden = _Pipelined.apply(schedule, keep, inputs_embeds, *params)
        return decoder.norm(hidden)

    return forward
