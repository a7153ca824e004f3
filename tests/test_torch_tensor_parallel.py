"""Megatron tensor parallelism of the port's LM train step
(`parallel/mesh.py`, `parallel/tensor.py`, `LMTrainer.shard_state`) on the
CPU: 4 gloo ranks, each a process of tests/torch_parallel_worker.py.

The JAX package proves its (data, model) step equal to the data-parallel
one (tests/test_tensor_parallel.py). Here the port's laid-out step is held
to the JAX package's single-device step and to the port's one-process step
on the same weights and the union batch, at TINY_LM (the JAX tests' LM),
on a 1 x 2 mesh (ranks 0 and 1) and a 2 x 2 mesh (data x model); the
port's specs equal the JAX specs leaf by leaf in torch's layout.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from dmel_codec_tpu.lm.inputs import TokenGridBuilder, pad_grids_to_batch
from dmel_codec_tpu.parallel import mesh as jax_mesh
from dmel_codec_tpu.train import lm_trainer as jax_lm_trainer
from dmel_codec_tpu_torch.convert import lm_state_dict_from_jax
from dmel_codec_tpu_torch.models import lm as port_lm
from dmel_codec_tpu_torch.models import transformer as port_tf
from dmel_codec_tpu_torch.parallel.mesh import MODEL_AXIS, lm_param_specs
from dmel_codec_tpu_torch.parallel.tensor import check_whole_heads
from dmel_codec_tpu_torch.train import lm_trainer as port_lm_trainer
from tests.test_lm import TINY_LM
from tests.test_torch_data_parallel import start_ranks

TRAIN_KW = dict(accumulate_grad=1, num_warmup_steps=2)  # as the JAX TP / FSDP tests
RANKS, RANK_TIMEOUT = 4, 240
# the JAX tests' tolerances (tests/test_tensor_parallel.py)
METRIC_RTOL, METRIC_ATOL = 2e-4, 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-6


def port_config() -> port_lm.SlowFastLMConfig:
    """TINY_LM in the port's classes."""
    kw = lambda c: {f: getattr(c, f) for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers",  # noqa: E731
                                                "num_heads", "num_kv_heads")}
    return port_lm.SlowFastLMConfig(slow=port_tf.TransformerConfig(**kw(TINY_LM.slow)),
                                    fast=port_tf.TransformerConfig(**kw(TINY_LM.fast)), text_weight=0.01)


def host_batches(n: int = 2, seed: int = 0) -> list:
    """n batches of 8 grids as the JAX test's `_batch` makes them (numpy)."""
    rng = np.random.default_rng(seed)
    gridder = TokenGridBuilder(config=TINY_LM)
    out = []
    for _ in range(n):
        grids = [gridder.build_train_grid(rng.integers(0, 1000, size=(3 + i % 4,)), rng.integers(0, 175, size=(6, 10)))
                 for i in range(8)]
        out.append({k: np.asarray(v) for k, v in pad_grids_to_batch(grids, TINY_LM).items()})
    return out


def run_job(tmp_path, runs: list) -> dict:
    """The JAX trainer's TINY_LM state carried over; `runs` on 4 gloo ranks
    while this process takes the same steps with JAX and with one port
    process on the union batches. Returns the ranks' outputs and both sides'
    metrics and parameters."""
    jt = jax_lm_trainer.LMTrainer(TINY_LM, jax_lm_trainer.LMTrainConfig(**TRAIN_KW))
    js = jax.jit(jt.init_state)(jax.random.PRNGKey(0))
    pcfg = port_config()
    pt = port_lm_trainer.LMTrainer(pcfg, port_lm_trainer.LMTrainConfig(**TRAIN_KW), device="cpu")
    ps = pt.init_state(0)
    pt.model.load_state_dict(lm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, js.params), pcfg))
    batches = host_batches()
    job = {"scenario": "lm", "slow_kw": port_config().slow.__dict__, "fast_kw": port_config().fast.__dict__,
           "lm_kw": dict(text_weight=0.01), "train_kw": TRAIN_KW, "batches": batches, "runs": runs,
           "params": {k: v.detach().clone() for k, v in pt.model.state_dict().items()}}
    wait = start_ranks(tmp_path, job, world=RANKS, worker="tests.torch_parallel_worker", timeout=RANK_TIMEOUT)
    step = jax.jit(jt.train_step)
    jax_metrics, one_metrics = [], []
    for batch in batches:
        js, m = step(js, {k: jax.numpy.asarray(v) for k, v in batch.items()})
        jax_metrics.append({k: float(v) for k, v in m.items()})
        ps, m = pt.train_step(ps, pt.device_batch(batch))
        one_metrics.append({k: float(v) for k, v in m.items()})
    return {"outs": wait(), "jax_metrics": jax_metrics, "one_metrics": one_metrics,
            "jax_params": lm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, js.params), pcfg),
            "one_params": {k: v.detach() for k, v in ps.params.items()}}


def assert_step_matches(result: dict, name: str) -> None:
    """Every rank's metrics at both steps, and the gathered parameters after
    them, against the JAX step and the one-process port step."""
    outs = [o[name] for o in result["outs"] if o[name]]
    for out in outs:
        for i, (want_jax, want_one) in enumerate(zip(result["jax_metrics"], result["one_metrics"])):
            got = out["metrics"][i]
            assert set(got) == set(want_jax) == set(want_one)
            for k in got:
                for want, side in ((want_jax, "JAX"), (want_one, "one process")):
                    np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                               err_msg=f"{name} step {i} {k} vs {side}")
    params = outs[0]["params"]
    assert set(params) == set(result["jax_params"]) == set(result["one_params"])
    for n, p in params.items():
        for want, side in ((result["jax_params"][n], "JAX"), (result["one_params"][n], "one process")):
            np.testing.assert_allclose(p.numpy(), want.numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{name} {n} vs {side}")


# ---- the specs -------------------------------------------------------------------


def jax_name(path) -> str:
    """A flax path of the LM's params -> the port's parameter name."""
    keys = [getattr(k, "key", str(k)) for k in path]
    keys = [k.replace("layers_", "layers.") for k in keys]
    if keys[-1] in ("kernel", "embedding"):
        keys[-1] = "weight"
    return ".".join(keys)


def jax_spec_in_torch_layout(path, leaf, spec) -> tuple:
    """A JAX PartitionSpec of a flax leaf, as the spec of the port's tensor:
    a Dense kernel [in, out] is the Linear weight [out, in] (reversed); the
    audio projector's kernel [C, H, H_out] is the weight [H_out, C * H]."""
    entries = list(spec) + [None] * (leaf.ndim - len(spec))
    keys = [getattr(k, "key", str(k)) for k in path]
    if keys[-1] == "kernel" and leaf.ndim == 3:
        return (entries[2], entries[0] or entries[1])
    if keys[-1] == "kernel":
        return tuple(reversed(entries))
    return tuple(entries)


def spec_pairs(model_size, data_size):
    """(port spec, JAX spec in torch's layout) for every leaf of TINY_LM."""
    jt = jax_lm_trainer.LMTrainer(TINY_LM, jax_lm_trainer.LMTrainConfig())
    shapes = jax.eval_shape(jt.init_state, jax.random.PRNGKey(0)).params
    port_params = dict(port_lm.ChatMusicLM(port_config()).named_parameters())
    ours = lm_param_specs(port_params, model_size, data_size)
    pairs = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        spec = jax_mesh.lm_param_pspec(path, leaf, model_size) if model_size else jax.sharding.PartitionSpec()
        if data_size:
            spec = jax_mesh._with_fsdp(spec, leaf, data_size)
        name = jax_name(path)
        pairs[name] = (ours[name], jax_spec_in_torch_layout(path, leaf, spec))
    assert set(pairs) == set(ours)
    return pairs


@pytest.mark.parametrize("model_size", [2, 4])
def test_tp_specs_equal_the_jax_specs(model_size):
    """Column / row rules and the divisibility fallback, leaf for leaf."""
    pairs = spec_pairs(model_size, None)
    for name, (ours, theirs) in pairs.items():
        assert ours == theirs, (name, ours, theirs)
    assert pairs["slow_decoder.layers.0.self_attn.q_proj.weight"][0] == (MODEL_AXIS, None)
    assert pairs["slow_decoder.layers.0.mlp.down_proj.weight"][0] == (None, MODEL_AXIS)
    assert pairs["text_head.weight"][0] == (MODEL_AXIS, None)


# ---- the step on 4 gloo ranks -------------------------------------------------------

RUNS = [dict(name="1x2", model=2, data=1, fsdp=False), dict(name="2x2", model=2, data=2, fsdp=False),
        dict(name="cut", model=4, data=1, fsdp=False, expect_raise=True)]


@pytest.fixture(scope="module")
def tp_result(tmp_path_factory):
    return run_job(tmp_path_factory.mktemp("tp"), RUNS)


@pytest.mark.parametrize("name", ["1x2", "2x2"])
def test_tp_step_matches_jax_and_one_process(tp_result, name):
    """Two steps (the first at lr 0, the second updates): the losses,
    accuracies, gradient norm and lr on every rank, and the gathered
    parameters, against the JAX step and the one-process port step."""
    assert_step_matches(tp_result, name)


@pytest.mark.parametrize("name", ["1x2", "2x2"])
def test_tp_second_step_keeps_layout(tp_result, name):
    """The second step takes the first's state as it is: the same pieces,
    still the trainer's own parameters, Adam's moments at their shape."""
    for out in tp_result["outs"]:
        if out[name]:
            assert out[name]["layout_kept"]
            assert np.isfinite(out[name]["metrics"][1]["train/loss"])


def test_tp_shards_are_split(tp_result):
    """A rank holds half of `q_proj`'s rows (its 2 of the 4 heads), and the
    embeddings stay whole."""
    hidden = TINY_LM.slow.hidden_size  # q_proj: heads x head_dim = hidden rows
    for name in ("1x2", "2x2"):
        out = tp_result["outs"][0][name]
        assert out["q_shape"] == (hidden // 2, hidden)
        assert out["q_spec"] == (MODEL_AXIS, None)
        assert out["specs"]["text_embed.weight"] == (None, None)


def test_a_model_axis_that_cuts_a_head_raises(tp_result):
    """TINY_LM has 2 key-value heads: 4-way tensor parallelism would cut
    one, which the port refuses (where the JAX package's per-leaf rule cuts
    `k_proj` and lets XLA gather it back)."""
    for out in tp_result["outs"]:
        assert "would cut a head" in out["cut"]["raised"]
    check_whole_heads(port_config(), 2)
    with pytest.raises(ValueError, match="model axis must divide"):
        check_whole_heads(port_config(), 4)
