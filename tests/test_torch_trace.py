"""The port's spans (`dmel_codec_tpu_torch/utils/trace.py`) on the CPU at
tiny sizes: with no profiler `span` is one shared null context that records
nothing, and under `torch.profiler` each layer boundary records its span,
nested as the readers of the benchmark expect: the codec's and the
vocoder's around a request, `lm.prefill` in generation, the trainer's and
the optimizer's around a micro-step, the codec trainer's parts."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import pytest
import torch

from dmel_codec_tpu_torch.eval.codecs import DMelCodecAdapter
from dmel_codec_tpu_torch.lm.generate import InferenceConfig, SlowFastGenerator
from dmel_codec_tpu_torch.lm.inputs import TokenGridBuilder, pad_grids_to_batch
from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
from dmel_codec_tpu_torch.models.lm import ChatMusicLM, SlowFastLMConfig
from dmel_codec_tpu_torch.models.transformer import TransformerConfig
from dmel_codec_tpu_torch.train.codec_trainer import CodecTrainConfig, CodecTrainer
from dmel_codec_tpu_torch.train.lm_trainer import LMTrainConfig, LMTrainer
from dmel_codec_tpu_torch.utils.trace import span
from tests.test_torch_support import strict_f32  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("strict_f32")

CODEC_KW = dict(n_mels=20, dmel_groups=2, encoder_residual_channels=6, encoder_layers=3, decoder_layers=3)
VOCODER_KW = dict(num_mels=20, upsample_initial_channel=32, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4))
SPECIALS = dict(
    bos_token_id=500, eos_token_id=500, start_of_human_id=501, end_of_human_id=502, start_of_robot_id=503,
    end_of_robot_id=504, start_of_music_id=505, end_of_music_id=506, text_pad_id=507,
)
LM = SlowFastLMConfig(
    slow=TransformerConfig(vocab_size=512, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
                           num_kv_heads=2),
    fast=TransformerConfig(vocab_size=1800, hidden_size=24, intermediate_size=48, num_layers=2, num_heads=4,
                           num_kv_heads=2),
    text_weight=0.01, **SPECIALS,
)


LAYERS = ("codec.", "vocoder.", "lm.", "train.")  # the program's span names start so; torch's own do not


def recorded(fn) -> Dict[str, Optional[str]]:
    """{span name: the name of its innermost enclosing span, or None} of
    the program's spans a CPU profile of `fn()` records."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    spans = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation() and e.name().startswith(LAYERS)]
    out = {}
    for name, a, b in spans:
        around = [s for s in spans if s[1] <= a and b <= s[2] and s != (name, a, b)]
        out[name] = min(around, key=lambda s: s[2] - s[1])[0] if around else None
    return out


def test_span_without_a_profiler_is_one_null_context():
    """No profiler: the same shared object for every name; a profiler
    started after it was made records nothing from it."""
    off = span("trace.test.a")
    assert off is span("trace.test.b")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with off:
            torch.ones(4).sum()
        with span("trace.test.on"):
            torch.ones(4).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    assert names == ["trace.test.on"]


@pytest.fixture(scope="module")
def adapter():
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        codec = DMelCodec(DMelCodecConfig(**CODEC_KW))
        vocoder = BigVGAN(BigVGANConfig(**VOCODER_KW))
    return DMelCodecAdapter(codec, vocoder, seed=1)


ENCODE = {"codec.mel": None, "codec.encode": None, "codec.encode.wavenet": "codec.encode",
          "codec.encode.fsq": "codec.encode"}
DECODE = {"codec.decode": None, "codec.decode.fsq": "codec.decode", "codec.decode.wavenet": "codec.decode",
          "vocoder.pre": None, "vocoder.s0": None, "vocoder.s1": None, "vocoder.post": None}


@pytest.mark.parametrize("call,want", [("encode", ENCODE), ("decode", DECODE)])
def test_codec_request_spans(adapter, call, want):
    """DMelCodecAdapter.encode / .decode (the vocoder runs its CPU plain
    versions): the codec's spans nested in encode and decode, the vocoder's
    beside them."""
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal((2, 256 * 24))).astype(np.float32)
    lengths = np.array([256 * 24, 256 * 16])
    if call == "encode":
        got = recorded(lambda: adapter.encode(audio, lengths))
    else:
        idx, idx_len = adapter.encode(audio, lengths)
        got = recorded(lambda: adapter.decode(idx, idx_len))
    assert got == want


def _prompts(b: int = 2, s: int = 10):
    gridder = TokenGridBuilder(config=LM)
    grids = [gridder.build_infer_grid(text_ids=np.arange(1, 2 + i)) for i in range(b)]
    text = np.full((b, s), LM.text_pad_id, np.int64)
    audio = np.full((b, s, LM.audio_codebook_count), LM.slow_audio_pad_id, np.int64)
    for i, (t, a) in enumerate(grids):
        text[i, s - len(t):], audio[i, s - len(t):] = t, a
    return text, audio


def test_generation_records_the_prefill():
    """The eager generate_batched: the prompts' upload and the prefill under
    `lm.prefill`; the frame steps open no span."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = ChatMusicLM(LM).eval()
    gen = SlowFastGenerator(model, InferenceConfig(max_new_tokens=3, max_seq_len=16))
    text, audio = _prompts()
    assert recorded(lambda: gen.generate_batched(text, audio, torch.Generator().manual_seed(0))) == {"lm.prefill": None}


def test_lm_train_step_spans():
    """One micro-step with the non-finite guard on and an update every
    micro-step: the trainer's three parts, the guard and the clip in the
    update."""
    trainer = LMTrainer(LM, LMTrainConfig(accumulate_grad=1, skip_nonfinite_updates=3, num_warmup_steps=0,
                                          num_training_steps=10), device="cpu")
    state = trainer.init_state(0)
    rng = np.random.default_rng(0)
    gridder = TokenGridBuilder(config=LM)
    grids = [gridder.build_train_grid(rng.integers(0, 500, 5), rng.integers(0, 175, (12 - 3 * i, 10)))
             for i in range(2)]
    batch = {k: torch.as_tensor(v) for k, v in pad_grids_to_batch(grids, LM).items()}
    got = recorded(lambda: trainer.train_step(state, batch))
    assert got == {"train.loss_and_grads": None, "train.metrics": None, "train.update": None,
                   "train.update.guard": "train.update", "train.update.clip": "train.update"}


def test_codec_train_step_spans():
    """One CodecTrainer micro-step: its eight parts as `codec.train.<part>`,
    each optimizer's guard and clip inside its part."""
    trainer = CodecTrainer(DMelCodecConfig(encoder_residual_channels=12, encoder_layers=2, decoder_layers=2),
                           CodecTrainConfig(skip_nonfinite_updates=1), device="cpu")
    state = trainer.init_state(0)
    rng = np.random.default_rng(0)
    samples = 256 * 16
    batch = {"audios": torch.as_tensor(0.1 * rng.standard_normal((2, samples)), dtype=torch.float32),
             "audio_lengths": torch.as_tensor([samples, samples // 2])}
    got = recorded(lambda: trainer.train_step(state, batch, torch.Generator().manual_seed(0)))
    parts = ("preamble", "generator_forward", "discriminator_forward", "discriminator_backward",
             "discriminator_optimizer", "generator_losses", "generator_backward", "generator_optimizer")
    assert {n: p for n, p in got.items() if not n.startswith("train.")} == {f"codec.train.{p}": None for p in parts}
    for name in ("train.update.guard", "train.update.clip"):  # the generator's, the later of the two
        assert got[name] == "codec.train.generator_optimizer"
