"""FSDP (ZeRO-3) of the port's LM train step (`parallel/fsdp.py`,
`LMTrainer.shard_state(..., fsdp=True)`) on the CPU, alone on a 2-rank data
mesh and with tensor parallelism on a 2 x 2 (data x model) mesh: 4 gloo
ranks, each a process of tests/torch_parallel_worker.py.

As tests/test_fsdp.py for the JAX package: the step equals the replicated
one (here: the JAX single-device step and the port's one-process step on
the union batch), each rank's parameters and Adam moments shrink, the
layout composes with tensor parallelism and is stable across steps. The
specs equal the JAX `_with_fsdp` specs leaf by leaf in torch's layout.
"""

from __future__ import annotations

import pytest
import torch

from dmel_codec_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, with_fsdp
from tests.test_torch_tensor_parallel import assert_step_matches, run_job, spec_pairs

# at 2 data ranks a cut leaf is half, the replicated norms and biases whole
REST_FRACTION = 0.6


@pytest.mark.parametrize("model_size,data_size", [(None, 2), (None, 4), (None, 8), (2, 2)])
def test_fsdp_specs_equal_the_jax_specs(model_size, data_size):
    """The largest free dimension that the data axis divides, leaf for leaf
    (with TP: the model axis keeps the Megatron dimension)."""
    pairs = spec_pairs(model_size, data_size)
    for name, (ours, theirs) in pairs.items():
        assert ours == theirs, (name, ours, theirs)
    assert pairs["text_embed.weight"][0] == (DATA_AXIS, None)
    assert pairs["slow_decoder.layers.0.input_layernorm.weight"][0] == (None,)
    if model_size:
        assert pairs["slow_decoder.layers.0.self_attn.q_proj.weight"][0] == (MODEL_AXIS, DATA_AXIS)
        assert pairs["slow_decoder.layers.0.mlp.down_proj.weight"][0] == (DATA_AXIS, MODEL_AXIS)


def test_ties_break_on_the_jax_layout():
    """A square Linear weight is cut on `in` (torch's dim 1), the flax
    kernel's first axis; a square embedding on dim 0, as flax has it."""
    square = torch.zeros(8, 8)
    assert with_fsdp((None, None), square, 2, flax_kernel=True) == (None, DATA_AXIS)
    assert with_fsdp((None, None), square, 2, flax_kernel=False) == (DATA_AXIS, None)
    assert with_fsdp((MODEL_AXIS, None), square, 2, flax_kernel=True) == (MODEL_AXIS, DATA_AXIS)
    assert with_fsdp((None,), torch.zeros(8), 2) == (None,)
    assert with_fsdp((None, None), torch.zeros(3, 5), 2) == (None, None)


RUNS = [dict(name="data2", model=None, data=2, fsdp=True), dict(name="2x2", model=2, data=2, fsdp=True)]


@pytest.fixture(scope="module")
def fsdp_result(tmp_path_factory):
    return run_job(tmp_path_factory.mktemp("fsdp"), RUNS)


@pytest.mark.parametrize("name", ["data2", "2x2"])
def test_fsdp_step_matches_jax_and_one_process(fsdp_result, name):
    """Two steps: every rank's metrics and the gathered parameters against
    the JAX step and the one-process port step (the JAX tests' tolerances)."""
    assert_step_matches(fsdp_result, name)


@pytest.mark.parametrize("name", ["data2", "2x2"])
def test_fsdp_state_at_rest_is_cut(fsdp_result, name):
    """Each rank's parameters plus Adam moments at rest: at most 0.6 of the
    replicated state's bytes; `q_proj` cut on `in` over the data axis (and
    on `out` over the model axis with TP)."""
    want = (None, DATA_AXIS) if name == "data2" else (MODEL_AXIS, DATA_AXIS)
    for out in fsdp_result["outs"]:
        if out[name]:
            assert out[name]["q_spec"] == want
            assert out[name]["bytes_at_rest"] <= REST_FRACTION * out[name]["replicated_bytes"], out[name]


@pytest.mark.parametrize("name", ["data2", "2x2"])
def test_fsdp_second_step_keeps_layout(fsdp_result, name):
    for out in fsdp_result["outs"]:
        if out[name]:
            assert out[name]["layout_kept"]
            assert out[name]["metrics"][1]["train/loss"] == out[name]["metrics"][1]["train/loss"]  # finite, not NaN


def test_gathered_leaves_are_freed_after_use(fsdp_result):
    """ZeRO-3, not a sharded optimizer: after the forward, with its graph
    kept for the backward, no gathered whole leaf is alive (each is gathered
    again when the backward needs it); a bare forward keeps them all."""
    for name in ("data2", "2x2"):
        for out in fsdp_result["outs"]:
            if out[name]:
                assert out[name]["gathered_alive"]["loss_fn"] == 0, out[name]["gathered_alive"]
                assert out[name]["gathered_alive"]["bare"] > 0, out[name]["gathered_alive"]
