"""One rank of a tensor-parallel, FSDP, sequence-parallel or pipeline job on
the gloo backend, for tests/test_torch_tensor_parallel.py,
tests/test_torch_fsdp.py, tests/test_torch_sequence_parallel.py and
tests/test_torch_pipeline_parallel.py (imports torch and the port only):

    python -m tests.torch_parallel_worker JOB.pt RANK

JOB.pt names the scenario and holds its inputs and a list of runs; each run
is made on a mesh or group of the first ranks of the world (every rank takes
part in making it), the other ranks wait at a barrier. The rank writes what
it saw to JOB.pt's directory as out_<RANK>.pt: {run name: outputs}.
"""

from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist
from torch.func import functional_call

from dmel_codec_tpu_torch.models import lm as port_lm
from dmel_codec_tpu_torch.models import transformer as port_tf
from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
from dmel_codec_tpu_torch.parallel import (
    data_mesh, dp_tp_mesh, pipelined_decoder, stage_mesh, time_sharded_decode, time_sharded_encode,
)
from dmel_codec_tpu_torch.parallel.mesh import all_gather_dim
from dmel_codec_tpu_torch.train import lm_trainer


def lm_run(job, run, rank: int) -> dict:
    """shard_state on the run's mesh, then the job's steps on this rank's
    data shard of each batch."""
    model, data = run.get("model"), run["data"]
    mesh = data_mesh(data) if model is None else dp_tp_mesh(model, data)
    members = data * (model or 1)
    cfg = port_lm.SlowFastLMConfig(slow=port_tf.TransformerConfig(**job["slow_kw"]),
                                   fast=port_tf.TransformerConfig(**job["fast_kw"]), **job["lm_kw"])
    if rank >= members:
        return {}
    trainer = lm_trainer.LMTrainer(cfg, lm_trainer.LMTrainConfig(**job["train_kw"]), device="cpu")
    state = trainer.init_state(0)
    trainer.model.load_state_dict(job["params"])
    if run.get("expect_raise"):
        try:
            trainer.shard_state(state, mesh, fsdp=run["fsdp"])
        except ValueError as e:
            return {"raised": str(e)}
        return {"raised": None}
    full_bytes = sum(p.numel() * p.element_size() for p in state.params.values())
    state = trainer.shard_state(state, mesh, fsdp=run["fsdp"])
    q = "slow_decoder.layers.0.self_attn.q_proj.weight"
    out = {"q_shape": tuple(state.params[q].shape), "q_spec": trainer.layout.specs[q],
           "specs": dict(trainer.layout.specs), "metrics": []}
    coordinate = mesh.get_local_rank("data")
    if run["fsdp"]:
        out["gathered_alive"] = gathered_alive(trainer, state, job["batches"][0], coordinate, data)
    for batch in job["batches"]:
        rows = len(batch["valid"]) // data
        mine = {k: v[coordinate * rows: (coordinate + 1) * rows] for k, v in batch.items()}
        state, metrics = trainer.train_step(state, trainer.device_batch(mine))
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
    adam = trainer_moments(state)
    out["layout_kept"] = (
        tuple(state.params[q].shape) == out["q_shape"]
        and all(p is dict(trainer.model.named_parameters())[n] for n, p in state.params.items())
        and all(adam[n][0].shape == p.shape for n, p in state.params.items())
    )
    out["bytes_at_rest"] = sum(p.numel() * p.element_size() for p in state.params.values()) + sum(
        m.numel() * m.element_size() for pair in adam.values() for m in pair)
    out["replicated_bytes"] = 3 * full_bytes
    full = unshard(state.params, trainer.layout.specs, mesh)
    if rank == 0:
        out["params"] = full
    return out


def gathered_alive(trainer, state, batch, coordinate: int, data: int) -> dict:
    """How many gathered whole leaves a forward leaves alive while its graph
    is kept for the backward: through `loss_fn` (which frees them after each
    unit's use), and through a bare `functional_call` (which keeps them)."""
    rows = len(batch["valid"]) // data
    mine = trainer.device_batch({k: v[coordinate * rows: (coordinate + 1) * rows] for k, v in batch.items()})
    loss, _ = trainer.loss_fn(state.params, mine)
    freed = len(trainer._fsdp.gathered)
    del loss
    named = {f"lm.{k}": v for k, v in state.params.items()}
    out = functional_call(trainer._loss_module, named, (mine,))
    kept = len(trainer._fsdp.gathered)
    del out
    return {"loss_fn": freed, "bare": kept}


@torch.no_grad()
def unshard(params: dict, specs: dict, mesh) -> dict:
    """Every laid-out parameter whole: each cut dimension gathered over its axis."""
    out = {}
    for name, t in params.items():
        full = t.detach()
        for dim, axis in enumerate(specs[name]):
            if axis is not None:
                full = all_gather_dim(full, dim, mesh.get_group(axis))
        out[name] = full
    return out


def trainer_moments(state) -> dict:
    """name -> (Adam's first moment, second moment) of this rank."""
    adamw = state.opt_state.adamw
    by_param = {id(p): n for n, p in state.params.items()}
    return {by_param[id(p)]: (s["exp_avg"], s["exp_avg_sq"]) for p, s in adamw.state.items()}


def lm(job, rank: int) -> dict:
    outs = {}
    for run in job["runs"]:
        outs[run["name"]] = lm_run(job, run, rank)
        dist.barrier()
    return outs


def sequence(job, rank: int) -> dict:
    """Each run: time_sharded_encode / decode over the first n ranks, on
    this rank's chunk of the time axis."""
    model = DMelCodec(DMelCodecConfig(**job["codec_kw"])).eval()
    model.load_state_dict(job["codec"])
    groups = {n: dist.new_group(list(range(n))) for n in sorted({run["n"] for run in job["runs"]})}
    outs = {}
    for run in job["runs"]:
        n, halo = run["n"], run["halo"]
        if rank < n:
            group = groups[n]
            try:
                if run["kind"] == "encode":
                    mels = run["mels"]
                    c = mels.shape[1] // n
                    fn = time_sharded_encode(model, group, halo_frames=halo)
                    idx, idx_len = fn(mels[:, rank * c: (rank + 1) * c], run["lengths"])
                    outs[run["name"]] = {"indices": idx, "lengths": idx_len}
                else:
                    indices, noise = run["indices"], run["noise"]
                    c, f = indices.shape[2] // n, noise.shape[1] // n
                    fn = time_sharded_decode(model, group, halo_frames=halo)
                    mel = fn(indices[:, :, rank * c: (rank + 1) * c], run["lengths"], noise[:, rank * f: (rank + 1) * f])
                    outs[run["name"]] = {"mel": mel}
            except ValueError as e:
                outs[run["name"]] = {"raised": str(e)}
        dist.barrier()
    return outs


def pipeline(job, rank: int) -> dict:
    """Each run: pipelined_decoder over the first S ranks with M
    microbatches, the forward and the gradients of sum(out * w)."""
    outs = {}
    for s, m in job["runs"]:
        mesh = stage_mesh(s)
        if rank < s:
            decoder = port_tf.Decoder(port_tf.TransformerConfig(**job["dec_kw"]))
            decoder.load_state_dict(job["decoder"])
            x = job["x"].clone().requires_grad_()
            out = pipelined_decoder(decoder, mesh, m)(x)
            (out * job["w"]).sum().backward()
            outs[(s, m)] = {
                "out": out.detach(), "x_grad": x.grad,
                "grads": {n: p.grad for n, p in decoder.named_parameters() if p.grad is not None},
            }
        dist.barrier()
    return outs


def main() -> None:
    job_path, rank = sys.argv[1], int(sys.argv[2])
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    job = torch.load(job_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{job['port']}", world_size=job["world"], rank=rank)
    try:
        out = {"lm": lm, "sequence": sequence, "pipeline": pipeline}[job["scenario"]](job, rank)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(os.path.dirname(job_path), f"out_{rank}.pt"))


if __name__ == "__main__":
    main()
