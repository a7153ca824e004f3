"""The codec's paths on the card: requests in bf16 and float32, the
float32 vocoder stage by stage, streaming and `cli.stream_codec`, codec
training, `cli.train_codec`, overfit, evaluation and the codec zoo (`card`:
see tests/card.py)."""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from dmel_codec_tpu_torch.cli import evaluate, stream_codec, train_codec
from dmel_codec_tpu_torch.cli.common import load_codec_adapter
from dmel_codec_tpu_torch.data.audio import resample_audio
from dmel_codec_tpu_torch.data.loader import BucketBatcher, DataLoader
from dmel_codec_tpu_torch.data.manifest import load_manifest
from dmel_codec_tpu_torch.dsp.spectrogram import LogMelSpectrogram
from dmel_codec_tpu_torch.eval import ecapa
from dmel_codec_tpu_torch.eval.codecs import make_codec
from dmel_codec_tpu_torch.eval.evaluation import Evaluation
from dmel_codec_tpu_torch.eval.metrics import detect_f0
from dmel_codec_tpu_torch.models import streaming
from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, FusedBigVGAN
from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
from dmel_codec_tpu_torch.ops.anti_alias import anti_alias_activation
from dmel_codec_tpu_torch.ops.stage_conv import stage_conv
from dmel_codec_tpu_torch.ops.stage_fused import amp_stage, amp_stage_v1
from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
from dmel_codec_tpu_torch.train.codec_trainer import CodecTrainConfig, CodecTrainer
from tests.card import (
    BATCH, FA_KERNELS, FRAMES, FUSE_MAX_CHANNELS, HOP, OVERFIT_FRACTION, SECONDS, SR, TOL, TOL_CHUNKED_DECODE,
    TOL_CHUNKED_STAGE, TOL_CHUNKED_WAVE, TOL_RERUN, VOCODE_CHUNK, VOCODE_HALO, WINDOW, check_close, codec_and_vocoder,
    fa_launches, free_card, jitter_snake, max_err, on_card, plain_kernels, rel_err, reset_launches, write_manifest,
)

pytestmark = pytest.mark.card

CCFG = DMelCodecConfig()
N_STAGES = len(BigVGANConfig().upsample_rates)
N_FUSED = sum(BigVGANConfig().stage_channels(i) <= FUSE_MAX_CHANNELS for i in range(N_STAGES))
WANT_K2 = N_FUSED * 18  # 18 act -> conv launches a fused stage
WANT_K1 = (N_STAGES - N_FUSED) * 18 + 1  # 18 acts a per-block stage, and act_post
EXACT_SECONDS, LONG_MINUTES, CHAIN_SECONDS, CLI_SECONDS = 8, 10, 60, 20
CODEC_TRAIN_BATCH, OVERFIT_SECONDS, OVERFIT_STEPS, OVERFIT_LR = 16, 60.0, 250, 3e-3
# Run in a fresh process from the checkout's root: turn TF32 on (PyTorch
# lets cuDNN convs use it by default), run an entry point's main, print what
# the process allows afterwards (utils/precision.tf32_flags).
CLI_TF32_PROBE = """
import importlib, json, sys
import torch
torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
importlib.import_module("dmel_codec_tpu_torch.cli." + sys.argv[1]).main(sys.argv[2:])
from dmel_codec_tpu_torch.utils.precision import tf32_flags
print(json.dumps(tf32_flags()))
"""


@pytest.fixture(scope="module")
def models():
    """The flagship codec (bf16) and vocoder (float32 and bf16) with seeded weights, and the front end."""
    dev = on_card()
    codec, voc32 = codec_and_vocoder(dev)
    yield {"codec": codec, "voc32": voc32, "voc16": copy.deepcopy(voc32).to(torch.bfloat16),
           "mel": LogMelSpectrogram().to(dev)}
    free_card()


def audio_for(request: int, dev) -> torch.Tensor:
    """BATCH clips of SECONDS: two partials on a pitch per clip and request."""
    t = torch.arange(SECONDS * SR, device=dev) / SR
    f0 = 110.0 * (1 + request) * (1 + torch.arange(BATCH, device=dev)[:, None] / BATCH)
    return 0.5 * torch.sin(2 * math.pi * f0 * t) + 0.1 * torch.sin(2 * math.pi * 3.1 * f0 * t)


def tone(seconds: float, dev) -> torch.Tensor:
    t = torch.arange(int(seconds * SR), device=dev) / SR
    return 0.5 * torch.sin(2 * math.pi * 220.0 * t) + 0.1 * torch.sin(2 * math.pi * 3.1 * 220.0 * t)


def launch_counts() -> dict:
    return {"K1": anti_alias_activation.launches, "K2": amp_stage.launches, "K2-v1": amp_stage_v1.launches,
            **amp_stage.launches_by_kernel, **amp_stage_v1.launches_by_kernel}


# ---- codec requests ---------------------------------------------------------------------


@torch.no_grad()
def test_codec_requests_in_bf16(models):
    """Three requests of 16 clips x 4 s through log-mel -> encode -> decode
    -> serving BigVGAN, bf16: indices in their codebooks, finite waveforms
    within [-1, 1]; K1 37 and K2 72 launches a request, every K2 launch on
    the bf16 tensor-core kernel, no K3 (bf16 s0 / s1 keep cuDNN)."""
    dev = on_card()
    codec, vocoder = models["codec"], FusedBigVGAN(models["voc16"], fuse_max_channels=FUSE_MAX_CHANNELS)
    gen = torch.Generator(device=dev).manual_seed(0)
    lengths = torch.full((BATCH,), FRAMES, device=dev)
    reset_launches(anti_alias_activation, amp_stage, stage_conv)
    for r in range(3):
        idx, ilen = codec.encode(models["mel"](audio_for(r, dev))[:, :FRAMES].to(torch.bfloat16), lengths)
        wav = vocoder(codec.decode(idx, ilen, generator=gen))
        assert idx.shape == (BATCH, CCFG.dmel_groups * CCFG.n_codebooks, FRAMES // 4), idx.shape
        assert 0 <= int(idx.min()) and int(idx.max()) < CCFG.codebook_size
        assert wav.shape == (BATCH, FRAMES * HOP) and torch.isfinite(wav).all() and wav.abs().max() <= 1.0
    assert amp_stage.launches_by_kernel == {"act_conv_tc_kernel": 3 * WANT_K2, "act_conv_tf32_kernel": 0}
    assert stage_conv.launches == 0
    assert (anti_alias_activation.launches, amp_stage.launches) == (3 * WANT_K1, 3 * WANT_K2)


@torch.no_grad()
def test_float32_vocoder_stage_by_stage(models):
    """The float32 vocoder (what a released checkpoint takes) stage by
    stage, each stage fed the same input on the kernels and on their plain
    versions (every K2 launch on the split-TF32 kernel, s0 / s1 on K1 and
    K3). The input is the log-mel of a request's audio: the random codec's
    output is near zero, which would make every comparison trivially
    small."""
    dev = on_card()
    fused = FusedBigVGAN(models["voc32"], fuse_max_channels=FUSE_MAX_CHANNELS)
    x = fused.pre(models["mel"](audio_for(0, dev))[:, :FRAMES])
    reset_launches()
    for i in range(len(fused.stages)):
        got = fused.stage(i, x)
        with pytest.MonkeyPatch.context() as m:
            plain_kernels(m)
            check_close(f"s{i}", got, fused.stage(i, x), TOL[("K2", torch.float32)])
        x = got
    assert amp_stage.launches_by_kernel == {"act_conv_tc_kernel": 0, "act_conv_tf32_kernel": WANT_K2}
    got = fused.post(x)
    with pytest.MonkeyPatch.context() as m:
        plain_kernels(m)
        check_close("act_post + conv_post", got, fused.post(x), TOL[("K2", torch.float32)])


@torch.no_grad()
def test_codec_request_in_float32(models):
    """One request through a float32 DMelCodec and vocoder, as
    `cli.stream_codec` builds them with no checkpoint: K1 37, K2 72 (all on
    the split-TF32 kernel) and K3 36 launches; float32 waveforms."""
    dev = on_card()
    torch.manual_seed(0)
    codec = DMelCodec(DMelCodecConfig()).eval().to(dev)
    fused = FusedBigVGAN(models["voc32"], fuse_max_channels=FUSE_MAX_CHANNELS)
    reset_launches(anti_alias_activation, amp_stage, stage_conv)
    idx, ilen = codec.encode(models["mel"](audio_for(0, dev))[:, :FRAMES], torch.full((BATCH,), FRAMES, device=dev))
    wav = fused(codec.decode(idx, ilen, generator=torch.Generator(device=dev).manual_seed(0)))
    launches = {"K1": anti_alias_activation.launches, "K2": amp_stage.launches, **amp_stage.launches_by_kernel,
                "K3": stage_conv.launches}
    assert launches == {"K1": WANT_K1, "K2": WANT_K2, "act_conv_tc_kernel": 0, "act_conv_tf32_kernel": WANT_K2,
                        "K3": WANT_K1 - 1}, launches
    assert idx.shape == (BATCH, CCFG.dmel_groups * CCFG.n_codebooks, FRAMES // 4)
    assert wav.shape == (BATCH, FRAMES * HOP) and wav.dtype == torch.float32
    assert torch.isfinite(wav).all() and wav.abs().max() <= 1.0


# ---- streaming ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clip8():
    """An 8 s clip's mel frames and decoder noise, from a numpy seed."""
    rng = np.random.default_rng(1)
    frames = (EXACT_SECONDS * SR // HOP // 4) * 4
    return ((0.5 * rng.standard_normal((1, frames, BigVGANConfig().num_mels))).astype(np.float32),
            rng.standard_normal((1, frames, CCFG.concat_dim)).astype(np.float32))


@torch.no_grad()
def test_chunked_codec_matches_one_shot(clip8):
    """chunked_encode (3 windows of 256 + 2 x 128) gives the one-shot
    tokens; chunked_decode (3 windows of 64 + 2 x 32 tokens) the one-shot
    mel within TOL_CHUNKED_DECODE, float32."""
    dev = on_card()
    mel, noise = clip8
    torch.manual_seed(0)
    codec = DMelCodec(DMelCodecConfig()).eval().to(dev)
    idx, ilen = codec.encode(torch.from_numpy(mel).to(dev), torch.full((1,), mel.shape[1], device=dev))
    mel_one = codec.decode(idx, ilen, torch.from_numpy(noise).to(dev))
    idx_chunked = streaming.chunked_encode(codec, mel, chunk_frames=256)
    assert idx_chunked.shape == tuple(idx.shape) and int((idx_chunked != idx.cpu().numpy()).sum()) == 0
    mel_chunked = streaming.chunked_decode(codec, idx_chunked, noise=noise, chunk_tokens=64)
    check_close("chunked_decode", torch.from_numpy(mel_chunked), mel_one.cpu(), TOL_CHUNKED_DECODE)


def stagewise_window_error(fused, mel: np.ndarray, dev) -> float:
    """The chunked-vs-one-shot gate of the serving vocoder, stage by stage:
    every stage runs on each window's slice of its one-shot input and is
    held against the same region of its one-shot output, beyond 128
    samples (more than a stage reaches) from a cut that is not a signal
    edge. Returns the largest error relative to max(1, max |one-shot|)."""
    t = mel.shape[1]
    xs = [fused.pre(torch.from_numpy(mel).to(dev))]
    for i in range(len(fused.stages)):
        xs.append(fused.stage(i, xs[-1]))
    worst = 0.0
    for _, pos in streaming.window_positions(t, VOCODE_CHUNK, VOCODE_HALO):
        rate = 1
        for i, u in enumerate(fused.config.upsample_rates):
            out = fused.stage(i, xs[i][:, :, pos * rate: (pos + WINDOW) * rate].contiguous())
            rate *= u
            lo = 0 if pos == 0 else 128
            hi = out.shape[2] - (0 if pos + WINDOW == t else 128)
            want = xs[i + 1][:, :, pos * rate + lo: pos * rate + hi]
            worst = max(worst, rel_err(out[:, :, lo:hi], want))
    return worst


@torch.no_grad()
@pytest.mark.parametrize("use_v2", [True, False])
def test_chunked_vocoder_matches_one_shot(models, clip8, use_v2):
    """chunked_vocode against the one-shot vocoder, float32: stage by
    stage within TOL_CHUNKED_STAGE, end to end within TOL_CHUNKED_WAVE
    (the JAX package's kernel path is off by 1.58e-1 there)."""
    dev = on_card()
    mel, _ = clip8
    fused = FusedBigVGAN(models["voc32"], fuse_max_channels=FUSE_MAX_CHANNELS, use_v2=use_v2)
    one_shot = fused(torch.from_numpy(mel).to(dev)).cpu().numpy()
    chunked = streaming.chunked_vocode(fused, mel, VOCODE_CHUNK, VOCODE_HALO)
    assert chunked.shape == one_shot.shape == (1, mel.shape[1] * HOP)
    assert float(np.abs(chunked - one_shot).max()) <= TOL_CHUNKED_WAVE
    assert stagewise_window_error(fused, mel, dev) <= TOL_CHUNKED_STAGE


@torch.no_grad()
@pytest.mark.parametrize("use_v2", [True, False])
@pytest.mark.parametrize("dname", ["bf16", "float32"])
def test_ten_minutes_through_chunked_vocode(models, dname, use_v2):
    """10 minutes, B = 1, through chunked_vocode: a finite waveform within
    [-1, 1]; K1, K2 and K2-v1 launches as the routes say for every window
    (use_v2=False runs v1 at every fused stage: K2-v1 where it holds the
    stage), each on the kernel of the vocoder's dtype."""
    on_card()
    voc = models["voc16" if dname == "bf16" else "voc32"]
    k2_kernel, v1_kernel = (("act_conv_tc_kernel", "stage_v1_tc_kernel") if dname == "bf16"
                            else ("act_conv_tf32_kernel", "stage_v1_tf32_kernel"))
    frames = LONG_MINUTES * 60 * SR // HOP
    n_windows = -(-frames // VOCODE_CHUNK)
    mel = (0.5 * np.random.default_rng(2).standard_normal((1, frames, BigVGANConfig().num_mels))).astype(np.float32)
    fused = FusedBigVGAN(voc, fuse_max_channels=FUSE_MAX_CHANNELS, use_v2=use_v2)
    reset_launches(anti_alias_activation, amp_stage, amp_stage_v1)
    wav = streaming.chunked_vocode(fused, mel, VOCODE_CHUNK, VOCODE_HALO)
    assert wav.shape == (1, frames * HOP) and np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    n_v1 = fused.routes.count("K2-v1")
    n_k2 = fused.routes.count("K2") + fused.routes.count("K2/v1")
    assert use_v2 or ("K2" not in fused.routes and n_v1 > 0), fused.routes
    counts = launch_counts()
    assert (counts["K1"], counts["K2"], counts["K2-v1"]) == (n_windows * WANT_K1, n_windows * 18 * n_k2,
                                                             n_windows * n_v1), counts
    assert counts[k2_kernel] == counts["K2"] and counts[v1_kernel] == counts["K2-v1"], counts
    by_kernel = {**amp_stage.launches_by_kernel, **amp_stage_v1.launches_by_kernel}
    assert sum(by_kernel.values()) == counts["K2"] + counts["K2-v1"], by_kernel


def test_sixty_seconds_through_the_chunked_chain(models):
    """60 s through chunked_encode -> chunked_decode -> chunked_vocode, bf16."""
    dev = on_card()
    mel = models["mel"](tone(CHAIN_SECONDS, dev)[None]).cpu().numpy()
    frames = (mel.shape[1] // 4) * 4
    idx = streaming.chunked_encode(models["codec"], mel)
    gen_mel = streaming.chunked_decode(models["codec"], idx, seed=0)
    wav = streaming.chunked_vocode(FusedBigVGAN(models["voc16"], fuse_max_channels=FUSE_MAX_CHANNELS), gen_mel,
                                   VOCODE_CHUNK, VOCODE_HALO)
    assert idx.shape == (1, CCFG.dmel_groups * CCFG.n_codebooks, frames // 4)
    assert 0 <= idx.min() and idx.max() < CCFG.codebook_size
    assert gen_mel.shape == (1, frames, CCFG.n_mels) and np.isfinite(gen_mel).all()
    assert wav.shape == (1, frames * HOP) and np.isfinite(wav).all() and np.abs(wav).max() <= 1.0


def run_stream_codec(tmp: Path, *extra: str) -> dict:
    """`cli.stream_codec.main` (default device, --use-v1) on a 20 s tone written to `tmp`: the tokens of 20 s and
    a finite float32 24 kHz WAV within [-1, 1]; returns the launches."""
    wavfile.write(tmp / "in.wav", SR, tone(CLI_SECONDS, "cpu").numpy().astype(np.float32))
    reset_launches(anti_alias_activation, amp_stage, amp_stage_v1, *FA_KERNELS.values())
    stream_codec.main(["--in", str(tmp / "in.wav"), "--tokens-out", str(tmp / "tokens.npy"),
                       "--out", str(tmp / "out.wav"), "--use-v1", *extra])
    torch.cuda.synchronize()
    wav_sr, wav = wavfile.read(tmp / "out.wav")
    frames = (CLI_SECONDS * SR // HOP // 4) * 4
    assert np.load(tmp / "tokens.npy").shape == (1, CCFG.dmel_groups * CCFG.n_codebooks, frames // 4)
    assert wav_sr == SR and wav.dtype == np.float32 and wav.shape == (frames * HOP,)
    assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    return {**launch_counts(), **fa_launches()}


@pytest.fixture(scope="module")
def stream_cli(tmp_path_factory):
    on_card()
    return run_stream_codec(tmp_path_factory.mktemp("stream"))


def test_stream_codec_entry_point(stream_cli):
    """`cli.stream_codec.main` on a 20 s WAV, no checkpoint: a float32
    vocoder, so every K2 and K2-v1 launch on the split-TF32 kernels."""
    on_card()
    launches = stream_cli
    assert launches["act_conv_tc_kernel"] == launches["stage_v1_tc_kernel"] == 0, launches
    assert launches["act_conv_tf32_kernel"] == launches["K2"] > 0, launches
    assert launches["stage_v1_tf32_kernel"] == launches["K2-v1"] > 0 and launches["K1"] > 0, launches


def test_stream_codec_pins_float32_in_a_fresh_process(tmp_path):
    """The entry point pins float32 itself: a fresh process turns TF32 on,
    runs stream_codec's main (encode only) and reports TF32 off after."""
    on_card()
    wavfile.write(tmp_path / "in.wav", SR, tone(4, "cpu").numpy().astype(np.float32))
    proc = subprocess.run([sys.executable, "-c", CLI_TF32_PROBE, "stream_codec", "--in", str(tmp_path / "in.wav"),
                           "--tokens-out", str(tmp_path / "tokens.npy")],
                          cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    flags = json.loads(proc.stdout.strip().splitlines()[-1])
    assert flags["cuda.matmul.allow_tf32"] is False and flags["cudnn.allow_tf32"] is False, flags
    assert flags.get("cudnn.conv.fp32_precision") != "tf32", flags


# ---- codec training -------------------------------------------------------------------------

METRICS = ("train/grad_norm/generator", "train/grad_norm/discriminator", "train/discriminator/loss",
           "train/discriminator/loss_real", "train/discriminator/loss_fake", "train/generator/loss",
           "train/generator/loss_mel", "train/generator/loss_adv", "train/lr")


def synthetic_clips(n: int, seconds: float, seed: int, floor: float = 0.0) -> np.ndarray:
    """Sums of four sines and a 0.1 s noise burst per clip, over white noise
    of amplitude `floor`, from a numpy seed."""
    rng = np.random.default_rng(seed)
    n_samples = int(seconds * SR)
    t = np.arange(n_samples) / SR
    clips = np.zeros((n, n_samples), np.float32)
    for i in range(n):
        for amp, freq in zip(rng.uniform(0.05, 0.3, 4), rng.uniform(100.0, 4000.0, 4)):
            clips[i] += (amp * np.sin(2 * math.pi * freq * t)).astype(np.float32)
        start = rng.integers(0, n_samples - SR // 10)
        clips[i, start: start + SR // 10] += (0.2 * rng.standard_normal(SR // 10)).astype(np.float32)
        clips[i] += (floor * rng.standard_normal(n_samples)).astype(np.float32)
    return clips


def codec_batches(trainer: CodecTrainer, n: int, seed: int) -> list:
    """n device batches of 16 clips x 4 s with given decoder noise; the last clip has half length."""
    rng = np.random.default_rng(seed + 1000)
    n_samples = SECONDS * SR
    lengths = np.full((CODEC_TRAIN_BATCH,), n_samples)
    lengths[-1] = n_samples // 2
    return [trainer.device_batch({
        "audios": synthetic_clips(CODEC_TRAIN_BATCH, SECONDS, seed + i), "audio_lengths": lengths,
        "noise": rng.standard_normal((CODEC_TRAIN_BATCH, n_samples // HOP, CCFG.concat_dim)).astype(np.float32)})
        for i in range(n)]


def snapshot(state) -> dict:
    return {which: {n: p.detach().clone() for n, p in getattr(state, which).items()}
            for which in ("gen_params", "disc_params")}


def changed(state, snap) -> dict:
    return {which: sum(not torch.equal(snap[which][n], p) for n, p in getattr(state, which).items())
            for which in ("gen_params", "disc_params")}


def test_codec_trainer_steps_and_a_second_run():
    """CodecTrainer at the flagship width, float32, B = 16 clips x 4 s (one
    of half length) with given decoder noise: 4 steps of nine finite
    metrics, nothing moving at the first update (lr 0), both networks at
    the second; a second run from the same state, batches and noise gives
    the six losses within TOL_RERUN."""
    dev = on_card()
    free_card()
    trainer = CodecTrainer(DMelCodecConfig(), CodecTrainConfig(num_warmup_steps=2), device=dev)
    batches = codec_batches(trainer, 2, seed=7)

    def run():
        state = trainer.init_state(0)
        assert all(p.dtype == torch.float32 and p.is_cuda
                   for p in (*state.gen_params.values(), *state.disc_params.values()))
        snap, history = snapshot(state), []
        for i in range(4):
            state, metrics = trainer.train_step(state, batches[i % 2])
            vals = {k: float(v) for k, v in metrics.items()}
            assert set(vals) == set(METRICS) and all(math.isfinite(x) for x in vals.values()), vals
            history.append((vals, changed(state, snap)))
        return state, history

    state, first = run()
    # the first update has lr 0 (LambdaLR semantics): nothing moves; from the second on, both networks do
    assert first[0][1] == {"gen_params": 0, "disc_params": 0}, first[0][1]
    assert first[1][1] == {"gen_params": len(state.gen_params), "disc_params": len(state.disc_params)}
    assert state.step == 4 and state.gen_opt_state.gradient_step == 4 and state.disc_opt_state.gradient_step == 4
    assert all(p.grad is None for p in (*trainer.codec.parameters(), *trainer.discriminator.parameters()))
    _, second = run()
    worst = max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-12) for (a, _), (b, _) in zip(first, second)
                for k in METRICS[2:8])
    assert worst <= TOL_RERUN, worst


def test_codec_trainer_freezes_the_encoder():
    """freeze_encoder: over 3 steps the encoder and the quantizer stay
    bit-unchanged and every other generator tensor trains."""
    dev = on_card()
    free_card()
    trainer = CodecTrainer(DMelCodecConfig(), CodecTrainConfig(num_warmup_steps=2, freeze_encoder=True), device=dev)
    batches = codec_batches(trainer, 2, seed=7)
    state = trainer.init_state(0)
    snap = snapshot(state)
    for i in range(3):
        state, _ = trainer.train_step(state, batches[i % 2])
    frozen = [n for n in state.gen_params if n.startswith(("encoder.", "quantizer."))]
    assert frozen and sum(not torch.equal(snap["gen_params"][n], state.gen_params[n]) for n in frozen) == 0
    rest = [n for n in state.gen_params if n not in frozen]
    assert sum(not torch.equal(snap["gen_params"][n], state.gen_params[n]) for n in rest) == len(rest)
    assert len(state.gen_opt_state.params) == len(rest)


def test_train_codec_entry_point(stream_cli, tmp_path):
    """`cli.train_codec.main` on 8 synthetic WAVs at the flagship width:
    checkpoints at 2 and 4, a resumed run to 6 moving every tensor, val_loss
    at 2, 4 and 6; then `cli.stream_codec.main` serves the generator it
    wrote with the launches of the untrained one."""
    on_card()
    clips = synthetic_clips(8, 4.75, seed=12)
    write_manifest(tmp_path / "train.jsonl", [clips[i, : int(SR * (3.0 + 0.25 * i))] for i in range(8)])

    def codec_yaml(max_steps: int) -> str:
        path = tmp_path / f"codec_{max_steps}.yaml"
        path.write_text(
            "train: {learning_rate: 1.0e-4, num_warmup_steps: 1}\n"
            f"fit: {{max_steps: {max_steps}, val_interval: 2, log_every: 1, ckpt_dir: {tmp_path / 'codec_ckpt'}, "
            f"log_dir: {tmp_path / 'codec_logs'}, seed: 1}}\n"
            f"data: {{train_manifest: {tmp_path / 'train.jsonl'}, val_manifest: {tmp_path / 'train.jsonl'}, "
            "max_duration: 16.0}\n")
        return str(path)

    train_codec.main(["--config", codec_yaml(4)])  # the default device: the card; `model:` absent = the flagship
    mgr = CheckpointManager(str(tmp_path / "codec_ckpt"))
    fields = ("step", "gen_params", "disc_params", "gen_opt_state", "disc_opt_state")
    assert mgr.all_steps() == [2, 4], mgr.all_steps()
    first = mgr.restore_latest_fields(None, fields)
    assert first["step"] == 4 and first["gen_opt_state"]["gradient_step"] == 4
    with torch.device("meta"):
        assert sum(v.numel() for v in first["gen_params"].values()) == sum(
            p.numel() for p in DMelCodec(DMelCodecConfig()).parameters())
    train_codec.main(["--config", codec_yaml(6)])
    second = mgr.restore_latest_fields(None, fields)
    assert mgr.all_steps() == [4, 6] and second["step"] == 6 and second["disc_opt_state"]["gradient_step"] == 6
    for which in ("gen_params", "disc_params"):
        assert all(not torch.equal(first[which][n], p) for n, p in second[which].items()), which
    records = [json.loads(line) for line in open(tmp_path / "codec_logs" / "metrics.jsonl")]
    val_losses = {r["step"]: r["val_loss"] for r in records if "val_loss" in r}
    assert [r["step"] for r in records if "train/lr" in r] == [1, 2, 3, 4, 5, 6] and sorted(val_losses) == [2, 4, 6]
    assert all(torch.isfinite(p).all() and p.dtype == torch.float32 for p in second["gen_params"].values())
    assert all(math.isfinite(v) for v in val_losses.values())
    (tmp_path / "serve").mkdir()
    served = run_stream_codec(tmp_path / "serve", "--codec-ckpt", str(tmp_path / "codec_ckpt"))
    assert served == {**stream_cli, "FA": 0, "FA-dKV": 0, "FA-dQ": 0}, (served, stream_cli)


def test_overfit_one_batch():
    """One fixed batch of 4 x 2 s (sums of sines over a noise floor, so that
    every mel band is occupied and the training quality scalar is 1.0:
    val_loss is taken at the fixed quality 2.0, and on clips with empty
    bands it does not follow the training loss), a raised learning rate, up
    to 250 steps or 60 s: the lowest val_loss reading (every 50 steps)
    falls below OVERFIT_FRACTION of its start and the last below the start
    (the adversarial term makes single readings jump)."""
    dev = on_card()
    free_card()
    trainer = CodecTrainer(DMelCodecConfig(), CodecTrainConfig(learning_rate=OVERFIT_LR, num_warmup_steps=20),
                           device=dev)
    state = trainer.init_state(0)
    batch = trainer.device_batch({"audios": synthetic_clips(4, 2.0, seed=13, floor=0.003),
                                  "audio_lengths": np.array([2 * SR, 2 * SR, 2 * SR, SR])})
    gen = torch.Generator(device=dev).manual_seed(0)

    def val_loss() -> float:
        return float(trainer.eval_step(state, batch, torch.Generator(device=dev).manual_seed(1))["val_loss"])

    curve = {0: val_loss()}
    t0 = time.perf_counter()
    while state.step < OVERFIT_STEPS and time.perf_counter() - t0 < OVERFIT_SECONDS:
        state, _ = trainer.train_step(state, batch, gen)
        if state.step % 50 == 0:
            curve[state.step] = val_loss()
    curve[state.step] = val_loss()
    assert state.step >= 100, state.step
    best = min(v for step, v in curve.items() if step > 0)
    assert best < OVERFIT_FRACTION * curve[0] and curve[state.step] < curve[0], curve


# ---- evaluation -------------------------------------------------------------------------------

# Evaluation tolerances, absolute in each column's unit:
#  kernel path vs plain path (the same checkpoint, batches and decoder
#    noise): the float32 vocoder's kernels sit within 2e-6 of their plain
#    versions per stage (test_float32_vocoder_stage_by_stage), so the
#    waveforms differ by ~1e-5 of their peak; the harness's columns move by
#    far less than these bounds, which still tell a wrong kernel apart (any
#    column off by a percent): si_snr 1e-3 dB, mel_l1 1e-4, stoi 1e-4,
#    f0_corr 1e-3, pesq 1e-3. The encoder runs no kernel:
#    codebook_entropy_mean must be equal.
#  ECAPA on the card vs the same module on the CPU: float32 convs (TF32
#    off) in another summation order through ~12 layers: 1e-4 of max |CPU|.
#  zoo, card vs CPU: a code may flip where two codes (RVQ) or two levels
#    (FSQ) are within the float32 rounding of a tie, and an RVQ flip moves
#    the later layers' residuals: at most 1 % of the codes may differ;
#    audio decoded from the same codes, float32 convs and LSTMs in another
#    order: 1e-4 of max(1, max |CPU|).
TOL_EVAL_PLAIN = {"si_snr": 1e-3, "mel_l1": 1e-4, "stoi": 1e-4, "f0_corr": 1e-3, "pesq": 1e-3}
TOL_ECAPA, TOL_ZOO_CODES, TOL_ZOO_AUDIO = 1e-4, 1e-2, 1e-4
EVAL_CLIPS, EVAL_MAX_DURATION = 8, 30.0


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    """8 clips at 24 kHz, 2.5 to 6 s (sums of four sines with a vibrato and
    two 0.1 s noise bursts each), their manifest, a flagship float32
    DMelCodec checkpoint and BigVGAN state_dict with seeded weights, and
    the evaluation YAML."""
    on_card()
    tmp = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(24)
    clips = []
    for i in range(EVAL_CLIPS):
        t = np.arange(int((2.5 + 0.5 * i) * SR)) / SR
        x = np.zeros(t.size)
        for amp, freq in zip(rng.uniform(0.05, 0.3, 4), rng.uniform(100.0, 3000.0, 4)):
            x += amp * np.sin(2 * math.pi * freq * (t + 0.002 * np.sin(2 * math.pi * 5.0 * t)))
        for start in rng.integers(0, t.size - SR // 10, 2):
            x[start: start + SR // 10] += 0.2 * rng.standard_normal(SR // 10)
        clips.append(x)
    write_manifest(tmp / "test.jsonl", clips)
    torch.manual_seed(24)
    CheckpointManager(str(tmp / "codec")).save(0, {"gen_params": DMelCodec(DMelCodecConfig()).state_dict()})
    torch.save(jitter_snake(BigVGAN(BigVGANConfig())).state_dict(), tmp / "bigvgan_generator.pt")
    (tmp / "eval.yaml").write_text(
        f"codec_ckpt_dir: {tmp / 'codec'}\nvocoder_ckpt: {tmp / 'bigvgan_generator.pt'}\n"
        f"test_manifest: {tmp / 'test.jsonl'}\nmax_duration: {EVAL_MAX_DURATION}\nwhisper_path: null\n"
        "compute_pesq: true\ncompute_spk_sim: false\n")
    cuts = load_manifest(str(tmp / "test.jsonl"))
    return {"tmp": tmp, "cuts": cuts, "batches": list(DataLoader(cuts, max_duration=EVAL_MAX_DURATION, shuffle=False))}


def _adapter(setup):
    return load_codec_adapter(str(setup["tmp"] / "codec"), vocoder_ckpt=str(setup["tmp"] / "bigvgan_generator.pt"))


def test_evaluate_entry_point(eval_setup):
    """`cli.evaluate.main` (default device) with compute_pesq: finite means
    of the expected columns; K1 and K2 launches for every batch, every K2
    launch on the split-TF32 kernel. f0_corr (Pearson's r of the two pitch
    tracks over frames voiced in both) is left out by the harness, as by
    the JAX one, where it is undefined: a random vocoder's output is
    smooth, so the tracker may find one lag in every voiced frame, and a
    constant track leaves r undefined; where it is missing, every
    reconstruction's track holds at most one value."""
    on_card()
    n_batches = len(BucketBatcher(eval_setup["cuts"], EVAL_MAX_DURATION, shuffle=False).batches())
    reset_launches(anti_alias_activation, amp_stage)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        evaluate.main(["--config", str(eval_setup["tmp"] / "eval.yaml")])
    torch.cuda.synchronize()
    launches = {"K1": anti_alias_activation.launches, "K2": amp_stage.launches, **amp_stage.launches_by_kernel}
    means = json.loads(buf.getvalue())
    required = {"si_snr", "mel_l1", "stoi", "codebook_entropy_mean", "pesq"}
    assert required <= set(means) <= required | {"f0_corr"}, means
    assert all(math.isfinite(v) for v in means.values()), means
    assert launches == {"K1": n_batches * WANT_K1, "K2": n_batches * WANT_K2, "act_conv_tc_kernel": 0,
                        "act_conv_tf32_kernel": n_batches * WANT_K2}, launches
    if "f0_corr" not in means:
        adapter = _adapter(eval_setup)
        for b in eval_setup["batches"]:
            rec = adapter.rec_audio_from_audio(b["audios"], b["audio_lengths"])
            for i, n in enumerate(b["audio_lengths"]):
                f0 = detect_f0(rec[i, : min(n, rec.shape[1])], SR)
                assert len(np.unique(f0[f0 > 0])) <= 1


def test_evaluation_kernels_against_plain(eval_setup):
    """The same batches through Evaluation.step with the kernels and with
    their plain versions: the entropy equal, the other columns within
    TOL_EVAL_PLAIN."""
    dev = on_card()
    runs = []
    for plain in (False, True):
        adapter = _adapter(eval_setup)
        with pytest.MonkeyPatch.context() as m:
            if plain:
                plain_kernels(m)
            runs.append([Evaluation(adapter, compute_pesq=True, device=dev).step(b) for b in eval_setup["batches"]])
    assert all(g.keys() == w.keys() for g, w in zip(*runs)), runs
    diffs = {k: max(abs(g[k] - w[k]) for g, w in zip(*runs)) for k in runs[0][0]}
    assert diffs["codebook_entropy_mean"] == 0.0, diffs
    assert all(v <= TOL_EVAL_PLAIN[k] for k, v in diffs.items() if k != "codebook_entropy_mean"), diffs


def test_ecapa_speaker_similarity(eval_setup, tmp_path):
    """ECAPA-TDNN at speechbrain's voxceleb width from an
    `embedding_model.ckpt` with seeded weights: a spk_sim in [-1, 1]; the
    embedding on the card against the same module on the CPU."""
    dev = on_card()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(25)
        torch.save(ecapa.ECAPA_TDNN().state_dict(), tmp_path / "embedding_model.ckpt")
    spk = Evaluation(_adapter(eval_setup), compute_pesq=False,
                     spk_weights_path=str(tmp_path / "embedding_model.ckpt"), device=dev)
    spk_sim = spk.run(eval_setup["batches"][:1]).means["spk_sim"]
    assert math.isfinite(spk_sim) and -1.0 <= spk_sim <= 1.0, spk_sim
    b = eval_setup["batches"][0]
    clip16 = torch.from_numpy(resample_audio(b["audios"][0, : b["audio_lengths"][0]], SR, 16000)).to(dev)
    fb = ecapa.ecapa_fbank(clip16)
    got = ecapa.embed(spk.spk_params, fb)
    want = ecapa.embed(copy.deepcopy(spk.spk_params).cpu(), fb.cpu())
    assert max_err(got.cpu(), want) <= TOL_ECAPA * want.abs().max().item()


@pytest.mark.parametrize("name", ["speechtokenizer", "encodec", "fishspeech"])
def test_zoo_codec_on_the_card(eval_setup, name):
    """A zoo codec at its published widths with seeded weights through
    Evaluation.run on the clips resampled to its rate: codes inside the
    codebook, finite means; one clip on the card against the CPU: at most
    TOL_ZOO_CODES of the codes differ, audio from the same codes within
    TOL_ZOO_AUDIO of max(1, max |CPU|)."""
    dev = on_card()
    codec = make_codec(name, seed=0)  # the default device: the card
    sr = codec.sample_rate
    batches = []
    for b in eval_setup["batches"]:
        parts = [resample_audio(b["audios"][i, : b["audio_lengths"][i]], SR, sr) for i in range(len(b["texts"]))]
        audios = np.zeros((len(parts), max(p.size for p in parts)), np.float32)
        for i, p in enumerate(parts):
            audios[i, : p.size] = p
        batches.append({"audios": audios, "audio_lengths": np.array([p.size for p in parts]), "texts": b["texts"]})
    codes, _ = codec.encode(batches[0]["audios"], batches[0]["audio_lengths"])
    assert 0 <= codes.min() and codes.max() < codec.config.codebook_size, (codes.min(), codes.max())
    means = Evaluation(codec, compute_pesq=True, device=dev).run(batches).means
    assert {"si_snr", "mel_l1", "codebook_entropy_mean", "pesq"} <= set(means), means
    assert all(math.isfinite(v) for v in means.values()), means
    clip = batches[0]["audios"][:1, :sr]
    cpu_codec = make_codec(name, copy.deepcopy(codec.model).cpu(), device="cpu")
    got_codes, _ = codec.encode(clip)
    want_codes, _ = cpu_codec.encode(clip)
    assert float(np.mean(got_codes != want_codes)) <= TOL_ZOO_CODES
    want_audio = torch.from_numpy(cpu_codec.decode(want_codes)[0])
    got_audio = torch.from_numpy(codec.decode(want_codes)[0])
    assert max_err(got_audio, want_audio) <= TOL_ZOO_AUDIO * max(1.0, want_audio.abs().max().item())


@pytest.mark.parametrize("name", ["dac", "mimi"])
def test_zoo_codec_without_transformers_raises(name, monkeypatch):
    """The adapters that wrap HF transformers raise their guarded error
    where it cannot be imported (blocked here, whether or not it is
    installed)."""
    on_card()
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match=f"codec '{name}' needs transformers"):
        make_codec(name)
