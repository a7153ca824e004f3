"""One rank of a data-parallel job on the gloo backend, for
tests/test_torch_data_parallel.py (imports torch and the port only, so a
rank starts in a few seconds):

    python -m tests.torch_dp_worker JOB.pt RANK

JOB.pt (torch.save of plain objects) names the scenario, the world size,
the rendezvous port and the scenario's inputs; the rank writes what it saw
to JOB.pt's directory as out_<RANK>.pt.
"""

from __future__ import annotations

import importlib
import os
import sys

import torch
import torch.distributed as dist

from dmel_codec_tpu_torch.models import lm as port_lm
from dmel_codec_tpu_torch.models import transformer as port_tf
from dmel_codec_tpu_torch.models.codec import DMelCodecConfig
from dmel_codec_tpu_torch.parallel.mesh import DataParallel
from dmel_codec_tpu_torch.train import codec_trainer, lm_trainer, lora
from dmel_codec_tpu_torch.train.lm_loop import LMFitLoop
from dmel_codec_tpu_torch.train.loop import FitConfig


def lm_config(job) -> port_lm.SlowFastLMConfig:
    return port_lm.SlowFastLMConfig(
        slow=port_tf.TransformerConfig(**job["slow_kw"]), fast=port_tf.TransformerConfig(**job["fast_kw"]),
        text_weight=0.01, **job["specials"],
    )


def codec_trainer_from(job, dp):
    trainer = codec_trainer.CodecTrainer(
        DMelCodecConfig(**job["codec_kw"]), codec_trainer.CodecTrainConfig(**job["train_kw"]), device="cpu"
    )
    trainer.data_parallel = dp
    state = trainer.init_state(0)
    trainer.codec.load_state_dict(job["gen"])
    trainer.discriminator.load_state_dict(job["disc"])
    return trainer, state


def lm_trainer_from(job, dp):
    trainer = lm_trainer.LMTrainer(lm_config(job), lm_trainer.LMTrainConfig(**job["train_kw"]), device="cpu")
    trainer.data_parallel = dp
    state = trainer.init_state(0)
    trainer.model.load_state_dict(job["params"])
    if job.get("lora") is None:
        return trainer, state
    lstate = trainer.init_lora_state(1, lora.LoRAConfig(**job["lora_kw"]), base_params=state.params)
    with torch.no_grad():
        for name, t in lora.lora_leaves(lstate.lora).items():
            t.copy_(job["lora"][name])
    return trainer, lstate


def steps(job, rank: int, dp: DataParallel) -> dict:
    """The scenario's batches of this rank, one train step each."""
    if job["model"] == "codec":
        trainer, state = codec_trainer_from(job, dp)
        step_fn = trainer.train_step
    else:
        trainer, state = lm_trainer_from(job, dp)
        step_fn = trainer.lora_train_step if job.get("lora") is not None else trainer.train_step
    metrics = []
    for batch in job["batches"][rank]:
        state, m = step_fn(state, trainer.device_batch(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    fields = state.state_dict()
    return {"metrics": metrics, "state": fields}


def fit(job, rank: int, dp: DataParallel) -> dict:
    """`LMFitLoop.run` with this rank's batch list as every epoch."""
    trainer = lm_trainer.LMTrainer(lm_config(job), lm_trainer.LMTrainConfig(**job["train_kw"]), device="cpu")
    batches = job["batches"][rank]
    epochs = []

    def train_batches(epoch):
        epochs.append(epoch)
        return iter(batches)

    state = LMFitLoop(trainer, train_batches, None, FitConfig(**job["fit_kw"]), device="cpu").run()
    return {"state": state.state_dict(), "epochs": epochs}


def cli(job, rank: int, dp: DataParallel) -> dict:
    """An entry point's `main` with `--distributed`, the rendezvous from
    torchrun's environment (set by the parent); it makes its own group."""
    importlib.import_module(f"dmel_codec_tpu_torch.cli.{job['cli']}").main(job["argv"])
    return {"group_left_up": dist.is_initialized()}


def main() -> None:
    job_path, rank = sys.argv[1], int(sys.argv[2])
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    job = torch.load(job_path, weights_only=False)
    scenario = {"steps": steps, "fit": fit, "cli": cli}[job["scenario"]]
    if job["scenario"] == "cli":
        out = scenario(job, rank, None)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{job['port']}", world_size=job["world"],
                                rank=rank)
        try:
            out = scenario(job, rank, DataParallel())
        finally:
            dist.destroy_process_group()
    torch.save(out, os.path.join(os.path.dirname(job_path), f"out_{rank}.pt"))


if __name__ == "__main__":
    main()
