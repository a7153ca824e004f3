"""Time-sharded codec encode / decode of the port (`parallel/sequence.py`)
on the CPU: 4 gloo ranks, each a process of tests/torch_parallel_worker.py,
groups of the first 2 and of all 4.

As tests/test_sequence_parallel.py for the JAX package, the proof is
exactness: each rank's chunk of the tokens equals the one-process port's
encode and the JAX encode (run op by op under `jax.disable_jit()`: jitted,
the JAX encode sits one index lower for ~1 token in 1,500, ROADMAP §3), and
each rank's chunk of the mel equals the one-process port's decode and the
JAX decode within 1e-5, at the JAX test's codec (12 residual channels, 3
layers) and lengths [64, 48].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_codec_tpu.models.codec import DMelCodec as JaxDMelCodec
from dmel_codec_tpu.models.codec import DMelCodecConfig as JaxDMelCodecConfig
from dmel_codec_tpu_torch.convert import codec_state_dict_from_jax
from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
from tests.test_torch_data_parallel import start_ranks
from tests.test_torch_support import init_params

CODEC_KW = dict(encoder_residual_channels=12, encoder_layers=3, decoder_layers=3)
LENGTHS = [64, 48]
DECODE_TOL = 1e-5  # float32 summation order over 3 WaveNet layers, as the JAX test


def _runs(mels, long_mels, long_lengths, indices, noise):
    """Encode and decode at 2 and 4 ranks with the default halo (128 frames:
    every window reaches over the whole clip); the long clip at 4 ranks of
    64 frames with a halo of 96 frames (from two ranks away) and of 32
    (from the neighbours only: the 3-layer stacks reach 7 frames, the
    ConvNeXt blocks 18); a chunk off the token grid."""
    lengths = torch.tensor(LENGTHS)
    runs = []
    for n in (2, 4):
        runs.append(dict(name=f"encode{n}", kind="encode", n=n, halo=128, mels=mels, lengths=lengths))
        runs.append(dict(name=f"decode{n}", kind="decode", n=n, halo=128, indices=indices, lengths=lengths // 4,
                         noise=noise))
    for halo in (96, 32):
        runs.append(dict(name=f"long{halo}", kind="encode", n=4, halo=halo, mels=long_mels, lengths=long_lengths))
    runs.append(dict(name="off_grid", kind="encode", n=4, halo=32, mels=mels[:, :56], lengths=lengths))
    return runs


@pytest.fixture(scope="module")
def seq_result(tmp_path_factory):
    jcfg = JaxDMelCodecConfig(**CODEC_KW)
    jmodel = JaxDMelCodec(config=jcfg)
    t = 64
    params = init_params(jmodel, 0, jnp.zeros((2, t, jcfg.n_mels)), jnp.ones((2, t, 1)), jnp.zeros((2, 1)),
                         jnp.zeros((2, t, jcfg.concat_dim)))
    port = DMelCodec(DMelCodecConfig(**CODEC_KW)).eval()
    port.load_state_dict(codec_state_dict_from_jax(params))
    rng = np.random.default_rng(0)
    mels = torch.from_numpy(rng.standard_normal((2, t, jcfg.n_mels)).astype(np.float32))
    long_mels = torch.from_numpy(rng.standard_normal((2, 256, jcfg.n_mels)).astype(np.float32))
    long_lengths = torch.tensor([256, 150])
    lengths = torch.tensor(LENGTHS)
    with torch.no_grad():
        one_idx, one_len = port.encode(mels, lengths)
        noise = torch.from_numpy(np.random.default_rng(1).standard_normal((2, t, jcfg.concat_dim)).astype(np.float32))
        one_mel = port.decode(one_idx, one_len, noise)
        one_long, _ = port.encode(long_mels, long_lengths)
    job = {"scenario": "sequence", "codec_kw": CODEC_KW, "codec": port.state_dict(),
           "runs": _runs(mels, long_mels, long_lengths, one_idx, noise)}
    wait = start_ranks(tmp_path_factory.mktemp("seq"), job, world=4, worker="tests.torch_parallel_worker")

    def encode(p, m, l):
        return jmodel.apply({"params": p}, m, l, method=JaxDMelCodec.encode)

    with jax.disable_jit():
        jax_idx, jax_len = encode(params, jnp.asarray(mels.numpy()), jnp.asarray(LENGTHS))
    jax_mel = jax.jit(lambda p, i, l, n: jmodel.apply({"params": p}, i, l, n, method=JaxDMelCodec.decode))(
        params, jnp.asarray(one_idx.numpy()), jnp.asarray(one_len.numpy()), jnp.asarray(noise.numpy()))
    return {"outs": wait(), "one_idx": one_idx, "one_len": one_len, "one_mel": one_mel, "one_long": one_long,
            "jax_idx": np.asarray(jax_idx), "jax_len": np.asarray(jax_len), "jax_mel": np.asarray(jax_mel)}


def joined(outs, name: str, key: str, n: int, dim: int) -> torch.Tensor:
    """The first n ranks' chunks of one run, in rank order."""
    return torch.cat([outs[r][name][key] for r in range(n)], dim=dim)


@pytest.mark.parametrize("n", [2, 4])
def test_time_sharded_encode_matches_one_process_and_jax(seq_result, n):
    outs = seq_result["outs"]
    for r in range(n):
        assert outs[r][f"encode{n}"]["indices"].shape == (2, 10, 64 // 4 // n)
        np.testing.assert_array_equal(outs[r][f"encode{n}"]["lengths"].numpy(), seq_result["one_len"].numpy())
    got = joined(outs, f"encode{n}", "indices", n, 2)
    np.testing.assert_array_equal(got.numpy(), seq_result["one_idx"].numpy())
    np.testing.assert_array_equal(got.numpy(), seq_result["jax_idx"])
    np.testing.assert_array_equal(seq_result["one_len"].numpy(), seq_result["jax_len"])


@pytest.mark.parametrize("n", [2, 4])
def test_time_sharded_decode_matches_one_process_and_jax(seq_result, n):
    outs = seq_result["outs"]
    got = joined(outs, f"decode{n}", "mel", n, 1)
    assert outs[0][f"decode{n}"]["mel"].shape == (2, 64 // n, 100)
    np.testing.assert_allclose(got.numpy(), seq_result["one_mel"].numpy(), atol=DECODE_TOL, rtol=DECODE_TOL)
    np.testing.assert_allclose(got.numpy(), seq_result["jax_mel"], atol=DECODE_TOL, rtol=DECODE_TOL)


@pytest.mark.parametrize("halo", [96, 32])
def test_chunks_shorter_than_the_halo_gather_from_further_ranks(seq_result, halo):
    """4 ranks of 64 frames: a halo of 96 frames takes frames from two ranks
    away, one of 32 from the neighbours only; both give the one-process
    tokens (a clip ending inside rank 2's chunk too)."""
    got = joined(seq_result["outs"], f"long{halo}", "indices", 4, 2)
    np.testing.assert_array_equal(got.numpy(), seq_result["one_long"].numpy())


def test_a_chunk_off_the_token_grid_raises(seq_result):
    """56 frames over 4 ranks is 14 a rank, not a multiple of 4."""
    for r in range(4):
        assert "multiple of 4" in seq_result["outs"][r]["off_grid"]["raised"]
