"""On the card: each cell's control comes out not correct, at a size a test
run holds (the cell's widths and depth, less traffic), and the program
itself correct beside it. The control is the plain reference one precision
below the configuration in the program's place: TF32 for the float32 cells,
fp8 weights for the bf16 one; training also with half of each batch left
out. Run with `python3 -m pytest benchmark/tests -q -m card`."""

import copy
import gc

import pytest
import torch

from benchmark.harness import runner, spec

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)
SMALLER = {
    "codec.batch16.f32": {"batch": 4, "cycle": 2},
    "codec.single.f32": {"cycle": 4, "check_requests": 3},
    "lm.train.2x2048.f32": {"seq": 1024, "pool": 4},
    "lm.serve.b16.bf16": {"batch": 4, "inference": {"max_new_tokens": 64}},
}


def smaller_cell(name: str) -> spec.Cell:
    cell = spec.cell(name)
    cell.workload = copy.deepcopy(cell.workload)
    for k, v in SMALLER[name].items():
        if isinstance(v, dict):
            cell.workload["params"][k].update(v)
        else:
            cell.workload["params"][k] = v
    return cell


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(SMALLER))
def test_control_is_not_correct(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is read on the card")
    from benchmark.run import _environment

    _environment()
    cell = smaller_cell(name)
    drv = spec.driver(cell.workload["driver"]).Driver(cell, seed, torch.device("cuda", 0))
    drv.setup()
    records = runner.window(drv, 1.0, None, None)
    drv.release()
    gc.collect()
    torch.cuda.empty_cache()
    assert runner.correct(drv.check(records))
    for control in drv.controls:
        assert not runner.correct(drv.check(records, control=control)), control
