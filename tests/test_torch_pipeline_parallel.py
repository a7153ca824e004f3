"""The GPipe decoder of the port (`parallel/pipeline.py`) on the CPU: 4 gloo
ranks, each a process of tests/torch_parallel_worker.py; stage groups of
the first 2 and of all 4 ranks.

As tests/test_pipeline_parallel.py for the JAX package: the pipelined
schedule computes what the one-device decoder computes, forward hidden
states and gradients, here against the JAX `Decoder` and the port's own on
the same weights (the JAX test's config: 4 layers, 32 wide, 4 / 2 heads).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_codec_tpu.models import transformer as jax_tf
from dmel_codec_tpu_torch.convert import decoder_state_dict_from_jax
from dmel_codec_tpu_torch.models import transformer as port_tf
from dmel_codec_tpu_torch.parallel.pipeline import split_stage_params
from tests.test_torch_data_parallel import start_ranks

DEC_KW = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=4, num_heads=4, num_kv_heads=2)
RUNS = [(2, 4), (4, 2), (4, 8)]  # (stages, microbatches)
FWD_ATOL, GRAD_ATOL = 2e-5, 5e-4  # the JAX tests' tolerances


def test_split_stage_params():
    decoder = port_tf.Decoder(port_tf.TransformerConfig(**DEC_KW))
    stages = split_stage_params(decoder.layers, 4)
    assert [len(s) for s in stages] == [1, 1, 1, 1] and stages[2][0] is decoder.layers[2]
    assert [list(s) for s in split_stage_params(decoder.layers, 2)] == [list(decoder.layers[:2]), list(decoder.layers[2:])]
    with pytest.raises(ValueError, match="not divisible by 3 stages"):
        split_stage_params(decoder.layers, 3)


@pytest.fixture(scope="module")
def pipe_result(tmp_path_factory):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 12, 32)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    jdec = jax_tf.Decoder(config=jax_tf.TransformerConfig(**DEC_KW))
    params = jdec.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    sd = decoder_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), DEC_KW["num_layers"])
    job = {"scenario": "pipeline", "dec_kw": DEC_KW, "decoder": sd, "x": torch.from_numpy(x),
           "w": torch.from_numpy(w), "runs": RUNS}
    wait = start_ranks(tmp_path_factory.mktemp("pipe"), job, world=4, worker="tests.torch_parallel_worker")

    def loss(p, x_):
        out, _ = jdec.apply({"params": p}, x_)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, jax_out), (g_params, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    port = port_tf.Decoder(port_tf.TransformerConfig(**DEC_KW))
    port.load_state_dict(sd)
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = port(xt)
    (out * torch.from_numpy(w)).sum().backward()
    return {"outs": wait(), "jax_out": np.asarray(jax_out), "jax_x_grad": np.asarray(g_x),
            "jax_grads": decoder_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, g_params), DEC_KW["num_layers"]),
            "one_out": out.detach(), "one_x_grad": xt.grad, "one_grads": {n: p.grad for n, p in port.named_parameters()}}


@pytest.mark.parametrize("stages,micro", RUNS)
def test_pipeline_forward_matches_jax_and_one_process(pipe_result, stages, micro):
    """The hidden state after the final norm, the same on every stage."""
    for r in range(stages):
        got = pipe_result["outs"][r][(stages, micro)]["out"].numpy()
        np.testing.assert_allclose(got, pipe_result["jax_out"], atol=FWD_ATOL, rtol=FWD_ATOL)
        np.testing.assert_allclose(got, pipe_result["one_out"].numpy(), atol=FWD_ATOL, rtol=FWD_ATOL)


@pytest.mark.parametrize("stages,micro", RUNS)
def test_pipeline_grads_match_jax_and_one_process(pipe_result, stages, micro):
    """The gradients of sum(out * w) for the input (on every rank) and for
    every parameter (each block's on the rank of its stage, the final norm's
    on every rank), and none for another stage's blocks."""
    per = DEC_KW["num_layers"] // stages
    for r in range(stages):
        out = pipe_result["outs"][r][(stages, micro)]
        for want in (pipe_result["jax_x_grad"], pipe_result["one_x_grad"].numpy()):
            np.testing.assert_allclose(out["x_grad"].numpy(), want, atol=GRAD_ATOL, rtol=GRAD_ATOL)
        mine = {f"layers.{i}." for i in range(r * per, (r + 1) * per)}
        want_names = {n for n in pipe_result["one_grads"] if n == "norm.weight" or any(n.startswith(m) for m in mine)}
        assert set(out["grads"]) == want_names
        for n, g in out["grads"].items():
            for want in (pipe_result["jax_grads"][n], pipe_result["one_grads"][n]):
                np.testing.assert_allclose(g.numpy(), want.numpy(), atol=GRAD_ATOL, rtol=GRAD_ATOL, err_msg=n)
