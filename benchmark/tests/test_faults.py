"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped (the CPU, a tiny size), everything else
as in a run, once for each fault the cell can have."""

import time

import pytest
import torch

from benchmark.harness import runner
from benchmark.tests.conftest import tiny_cell

SEED = 2**31 + 424242


def run(name: str) -> list:
    out = runner.run_cell(tiny_cell(name), SEED, 0.5, False, torch.device("cpu"), time.perf_counter())
    return out["checks"]


def failed(checks: list) -> set:
    return {c["name"] for c in checks if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("name", ["codec.batch16.f32", "codec.single.f32"])
def test_codec_answer_altered(name, monkeypatch):
    """One sample of the waveform altered where the vocoder produces it."""
    from dmel_codec_tpu_torch.models.bigvgan import FusedBigVGAN

    post = FusedBigVGAN.post

    def altered(self, x):
        y = post(self, x).clone()
        y[0, 300] += 0.5 * float(y.abs().max())
        return y

    monkeypatch.setattr(FusedBigVGAN, "post", altered)
    assert "wave" in failed(run(name))


def test_codec_token_altered(monkeypatch):
    """The encoder's indices altered where they are produced (every index
    one level off): the decoder's mel, decoded from them, and the indices."""
    from dmel_codec_tpu_torch.models.codec import DMelCodec

    encode = DMelCodec.encode

    def altered(self, mels, lengths):
        idx, n = encode(self, mels, lengths)
        return (idx + 1) % self.config.codebook_size, n

    monkeypatch.setattr(DMelCodec, "encode", altered)
    assert "fsq_mismatch" in failed(run("codec.batch16.f32"))


def test_train_state_unchanged(monkeypatch):
    """A step that returns its state unchanged: the optimizer takes nothing."""
    from dmel_codec_tpu_torch.train.optim import AccumulatingAdamW

    monkeypatch.setattr(AccumulatingAdamW, "update", lambda self, grads, watch=(): None)
    assert {"grad", "change"} <= failed(run("lm.train.2x2048.f32"))


def test_train_half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from dmel_codec_tpu_torch.train.lm_trainer import LMTrainer

    step = LMTrainer.train_step

    def half(self, state, batch):
        rows = batch["text_tokens"].shape[0] // 2
        return step(self, state, {k: v[:rows] for k, v in batch.items()})

    monkeypatch.setattr(LMTrainer, "train_step", half)
    assert failed(run("lm.train.2x2048.f32")) & {"loss", "grad"}


def test_serve_token_altered(monkeypatch):
    """A served token altered where the generator produces it."""
    from dmel_codec_tpu_torch.lm.generate import SlowFastGenerator

    generate = SlowFastGenerator.generate_batched

    def altered(self, text, audio, generator=None):
        audio_ids, text_ids = generate(self, text, audio, generator)
        text_ids[0] = text_ids[0].copy()
        text_ids[0][1] = (text_ids[0][1] + 12345) % self.cfg.slow.vocab_size
        return audio_ids, text_ids

    monkeypatch.setattr(SlowFastGenerator, "generate_batched", altered)
    assert "token_gap" in failed(run("lm.serve.b16.bf16"))


def test_sound_runs_pass():
    for name in ("codec.single.f32", "lm.train.2x2048.f32", "lm.serve.b16.bf16"):
        assert not failed(run(name)), name
