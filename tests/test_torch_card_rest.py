"""The rest on the card: the host data path, `cli.convert` served by
`cli.stream_codec`, data-parallel entry points and the parallel layer in a
one-rank NCCL group (NCCL across ranks needs a second card), and the public
modules against the CPU (`card`: see tests/card.py)."""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import shutil
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
from scipy.io import wavfile

from dmel_codec_tpu_torch.cli import convert, preprocess, stream_codec, train_codec, train_lm
from dmel_codec_tpu_torch.data import audio as audio_mod
from dmel_codec_tpu_torch.data.loader import DataLoader
from dmel_codec_tpu_torch.data.manifest import load_manifest
from dmel_codec_tpu_torch.dsp.spectrogram import LogMelSpectrogram
from dmel_codec_tpu_torch.models import DMelCodecConfig, FireflyGAN, streaming
from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, FusedBigVGAN
from dmel_codec_tpu_torch.models.codec import DMelCodec
from dmel_codec_tpu_torch.models.discriminator import MelDiscriminator
from dmel_codec_tpu_torch.models.lm import SlowFastLMConfig
from dmel_codec_tpu_torch.models.transformer import Decoder
from dmel_codec_tpu_torch.nn import DownSample1d, Snake, UpSample1d, WaveNet
from dmel_codec_tpu_torch.ops.anti_alias import anti_alias_activation
from dmel_codec_tpu_torch.ops.stage_fused import amp_stage
from dmel_codec_tpu_torch.parallel import dp_tp_mesh, pipelined_decoder, stage_mesh, time_sharded_decode, \
    time_sharded_encode
from dmel_codec_tpu_torch.train.checkpoint import CheckpointManager
from dmel_codec_tpu_torch.train.lm_trainer import LMTrainConfig, LMTrainer
from tests.card import (
    FA_KERNELS, HOP, SECONDS, SR, TOL_CHUNKED_DECODE, TOL_TRAIN_GRAD, check_close, fa_launches, free_card, jitter_snake,
    lm_train_batches, max_err, on_card, reset_launches, write_manifest,
)

pytestmark = pytest.mark.card

# Tolerances:
#  native vs python decode: the same samples through two Kaiser polyphase
#    FIRs that sum in another order: 2e-5 (tests/test_native_audio.py).
#  convert -> stream_codec against the modules built from the same
#    state_dicts: the same weights through the same code on one card: the
#    codes equal, the audio within 2e-5 (the chunked tolerance).
#  train_lm --distributed at world size 1 against the run without: every
#    all-reduce of one rank returns its input, so only the backward's own
#    nondeterminism can move the losses after the first update: 1e-6
#    relative.
#  the laid-out trainer (tensor parallel over a model group of one, with and
#    without FSDP over a data group of one) against the plain trainer, the
#    same seed and batches: the losses within 1e-6 relative. They cannot be
#    bit-equal: the vocab-parallel cross entropy sums -log softmax as
#    log(sum exp(x - max)) + max - x[label] where F.cross_entropy takes
#    log_softmax, and the layout's global norm adds the squares by kind
#    before the root, each ~1e-7 relative in float32; the kernels, the
#    GEMMs and the collectives over one rank change no bit.
#  the GPipe decoder (one stage, 2 microbatches of 1) against the plain
#    decoder on the batch of 2: the same kernels, but float32 GEMMs of half
#    the rows may take another cuBLAS kernel and sum in another order
#    (~1e-7 relative per op, over 24 blocks): the hidden state within 1e-4
#    of max(1, max |plain|), each gradient within TOL_TRAIN_GRAD of its
#    tensor's largest.
#  time-sharded encode / decode at world size 1 against the one-process
#    encode / decode: the same modules on the same window: tokens equal,
#    the mel within TOL_CHUNKED_DECODE.
HOST_WAVS, HOST_RATES, LM_CLIP_SECONDS, LM_DIST_RTOL = 20, (16000, 24000, 44100), 42.0, 1e-6
TOL_PARALLEL_LOSS, TOL_PIPELINE_OUT = 1e-6, 1e-4
LM_BATCH, TRAIN_SEQ, MICRO_STEPS, SHARDED_SECONDS = 2, 1024, 4, 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun_env(m: pytest.MonkeyPatch) -> None:
    """The variables torchrun sets, for one process of a one-rank group (undone with `m`)."""
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(free_port())}.items():
        m.setenv(k, v)


@pytest.fixture
def nccl_group():
    """A process group of one rank on NCCL around the test."""
    on_card()
    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
                            device_id=dev)
    try:
        yield dev
    finally:
        dist.destroy_process_group()
        free_card()


# ---- the host path --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """`cli.preprocess` on 20 seeded WAVs (int16 / int32 / float32, mono and stereo, 16 / 24 / 44.1 kHz)."""
    on_card()
    tmp = tmp_path_factory.mktemp("host")
    (tmp / "wavs").mkdir()
    rng = np.random.default_rng(25)
    formats = [(np.int16, 1), (np.int32, 2), (np.float32, 1), (np.int16, 2), (np.float32, 2), (np.int32, 1)]
    for i in range(HOST_WAVS):
        dtype, channels = formats[i % len(formats)]
        sr = HOST_RATES[i % len(HOST_RATES)]
        t = np.arange(int(sr * (2.0 + 0.1 * i))) / sr
        x = 0.3 * np.sin(2 * math.pi * (150 + 40 * i) * t) + 0.05 * rng.standard_normal(len(t))
        x = np.stack([x, 0.8 * x], axis=1) if channels == 2 else x
        scale = {np.int16: 32767, np.int32: 2**31 - 1, np.float32: 1.0}[dtype]
        wavfile.write(tmp / "wavs" / f"clip{i:02d}.wav", sr, (x * scale).astype(dtype))
    preprocess.main(["--wav-dir", str(tmp / "wavs"), "--out", str(tmp / "train.jsonl"), "--seed", "0"])
    return tmp / "train.jsonl"


def test_native_decode_matches_python(manifest):
    """Every preprocessed clip decoded and resampled to 24 kHz by the native
    C++ backend and by scipy within 2e-5, clip by clip and batch by batch."""
    on_card()
    cuts = load_manifest(str(manifest))
    assert len(cuts) == HOST_WAVS, len(cuts)
    for c in cuts:
        a, b = (audio_mod.load_audio(c.audio_path, SR, backend=backend) for backend in ("native", "python"))
        assert a.shape == b.shape and float(np.abs(a - b).max()) <= 2e-5
    batches = {b: list(DataLoader(cuts, sample_rate=SR, max_duration=16.0, shuffle=False, audio_backend=b))
               for b in ("native", "python")}
    assert len(batches["native"]) == len(batches["python"]) > 1
    for a, b in zip(batches["native"], batches["python"]):
        assert np.array_equal(a["audio_lengths"], b["audio_lengths"]) and a["audios"].shape == b["audios"].shape
        assert float(np.abs(a["audios"] - b["audios"]).max()) <= 2e-5


def test_convert_then_stream_codec(tmp_path):
    """`cli.convert vqgan` and `bigvgan` on made-up reference files at the
    flagship widths, then `cli.stream_codec` on what they wrote: the codes
    of the modules built here from the same state_dicts, the audio within
    2e-5; K1 37 and K2 72 launches, all K2 on the split-TF32 kernel."""
    dev = on_card()
    ccfg, vcfg = DMelCodecConfig(), BigVGANConfig()
    torch.manual_seed(26)
    gen_sd, disc_sd = DMelCodec(ccfg).state_dict(), MelDiscriminator().state_dict()
    vocoder = jitter_snake(BigVGAN(vcfg))
    torch.save({"state_dict": {**gen_sd, **{f"discriminator.{k}": v for k, v in disc_sd.items()},
                               "gt_mel_transform.window": torch.ones(1024)}, "epoch": 0}, tmp_path / "vqgan.ckpt")
    (tmp_path / "release").mkdir()
    (tmp_path / "release" / "config.json").write_text(json.dumps(
        {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(vcfg).items()}))
    torch.save({"generator": vocoder.state_dict()}, tmp_path / "release" / "bigvgan_generator.pt")
    convert.main(["vqgan", "--ckpt", str(tmp_path / "vqgan.ckpt"), "--out", str(tmp_path / "codec")])  # the card
    convert.main(["bigvgan", "--dir", str(tmp_path / "release"), "--out", str(tmp_path / "vocoder")])
    clip = 0.4 * np.sin(2 * math.pi * 220.0 * np.arange(SECONDS * SR) / SR).astype(np.float32)
    wavfile.write(tmp_path / "in.wav", SR, clip)
    reset_launches(anti_alias_activation, amp_stage)
    stream_codec.main(["--in", str(tmp_path / "in.wav"), "--tokens-out", str(tmp_path / "tokens.npy"), "--out",
                       str(tmp_path / "out.wav"), "--codec-ckpt", str(tmp_path / "codec"),
                       "--vocoder-dir", str(tmp_path / "vocoder")])
    torch.cuda.synchronize()
    served = {"K1": anti_alias_activation.launches, "K2": amp_stage.launches,
              "act_conv_tf32_kernel": amp_stage.launches_by_kernel["act_conv_tf32_kernel"]}
    tokens = np.load(tmp_path / "tokens.npy")
    _, wav = wavfile.read(tmp_path / "out.wav")
    # the same modules, built here from the same state_dicts, through stream_codec's steps
    codec = DMelCodec(ccfg)
    codec.load_state_dict(gen_sd)
    codec = codec.to(dev).eval()
    audio = audio_mod.load_audio(str(tmp_path / "in.wav"), target_sr=SR)
    mels = LogMelSpectrogram(sample_rate=SR, hop_length=ccfg.hop_length, n_mels=ccfg.n_mels)(
        torch.from_numpy(audio)[None]).numpy()
    down = ccfg.downsample_total
    want_tokens = streaming.chunked_encode(codec, mels, 1024, streaming.DEFAULT_HALO_FRAMES, device=dev)
    mel = streaming.chunked_decode(codec, want_tokens, chunk_tokens=1024 // down,
                                   halo_tokens=streaming.DEFAULT_HALO_FRAMES // down, seed=0, device=dev)
    want_wav = streaming.chunked_vocode(FusedBigVGAN(vocoder.to(dev).eval()), mel, device=dev)[0]
    assert np.array_equal(tokens, want_tokens) and wav.shape == want_wav.shape
    assert float(np.abs(wav - want_wav).max()) <= 2e-5
    assert served == {"K1": 37, "K2": 72, "act_conv_tf32_kernel": 72}, served


def test_train_lm_distributed_matches_single(tmp_path, monkeypatch):
    """`cli.train_lm --distributed` in a process group of one rank on NCCL
    at full width (float32, flash attention, 2 x 1024, accumulate_grad = 2,
    2 updates) against the same run without: losses within LM_DIST_RTOL,
    one FA, FA-dKV and FA-dQ launch a slow layer a micro-step; the entry
    point destroys the group it made."""
    on_card()
    rng = np.random.default_rng(27)
    t = np.arange(int(SR * LM_CLIP_SECONDS)) / SR
    write_manifest(tmp_path / "lm.jsonl", [0.3 * np.sin(2 * math.pi * (180 + 50 * i) * t)
                                           + 0.05 * rng.standard_normal(len(t)) for i in range(2)],
                   [f"tone number {i}" for i in range(2)])
    torch.manual_seed(0)
    CheckpointManager(str(tmp_path / "codec")).save(0, {"gen_params": DMelCodec(DMelCodecConfig()).state_dict()})
    shapes, losses, launches = {}, {}, {}
    real_step = LMTrainer.train_step
    for name in ("distributed", "single"):
        (tmp_path / f"lm_{name}.yaml").write_text(
            f"codec_ckpt_dir: {tmp_path / 'codec'}\ntext_tokenizer_path: null\n"
            "slow_lm: {flash_attention: true}\n"
            "train: {accumulate_grad: 2, num_warmup_steps: 0}\n"
            f"fit: {{max_steps: 4, val_interval: 1000, log_every: 1, ckpt_dir: {tmp_path / ('ckpt_' + name)}, "
            f"log_dir: {tmp_path / ('logs_' + name)}, seed: 1, keep_checkpoints: 1}}\n"
            f"data: {{train_manifest: {tmp_path / 'lm.jsonl'}, max_duration: 90.0, audio_backend: native}}\n")
        seen = shapes[name] = []

        def step(self, state, batch, _seen=seen):
            _seen.append(tuple(batch["valid"].shape))
            return real_step(self, state, batch)

        monkeypatch.setattr(LMTrainer, "train_step", step)
        reset_launches(*FA_KERNELS.values())
        with pytest.MonkeyPatch.context() as m:
            if name == "distributed":
                torchrun_env(m)
            train_lm.main(["--config", str(tmp_path / f"lm_{name}.yaml")]
                          + (["--distributed"] if name == "distributed" else []))  # the default device: the card
        torch.cuda.synchronize()
        assert not dist.is_initialized()
        launches[name] = fa_launches()
        losses[name] = [json.loads(line)["train/loss"] for line in open(tmp_path / f"logs_{name}" / "metrics.jsonl")]
        # the full-width state and its moments take 11 GB a checkpoint
        assert CheckpointManager(str(tmp_path / f"ckpt_{name}")).all_steps() == [4]
        shutil.rmtree(tmp_path / f"ckpt_{name}")
        free_card()
    assert shapes["distributed"] == shapes["single"] == [(LM_BATCH, TRAIN_SEQ)] * 4, shapes
    assert len(losses["distributed"]) == len(losses["single"]) == 4
    assert max(abs(a - b) / abs(b) for a, b in zip(losses["distributed"], losses["single"])) <= LM_DIST_RTOL, losses
    n = SlowFastLMConfig().slow.num_layers * 4
    assert launches["distributed"] == launches["single"] == {k: n for k in FA_KERNELS}, launches


def test_train_codec_distributed(manifest, tmp_path, monkeypatch):
    """`cli.train_codec --distributed` in a process group of one rank on
    NCCL on the preprocessed manifest through the native decode: 2 logged
    steps of finite metrics; the entry point destroys the group it made."""
    on_card()
    (tmp_path / "codec.yaml").write_text(
        "train: {learning_rate: 1.0e-4, num_warmup_steps: 1}\n"
        f"fit: {{max_steps: 2, val_interval: 1000, log_every: 1, ckpt_dir: {tmp_path / 'ckpt'}, "
        f"log_dir: {tmp_path / 'logs'}, seed: 1, keep_checkpoints: 1}}\n"
        f"data: {{train_manifest: {manifest}, max_duration: 16.0, audio_backend: native}}\n")
    torchrun_env(monkeypatch)
    train_codec.main(["--config", str(tmp_path / "codec.yaml"), "--distributed"])
    torch.cuda.synchronize()
    assert not dist.is_initialized()
    records = [json.loads(line) for line in open(tmp_path / "logs" / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1, 2]
    assert all(math.isfinite(v) for r in records for v in r.values())


# ---- the parallel layer in a group of one rank ------------------------------------------------

LM_CFG = SlowFastLMConfig()
FLASH_CFG = dataclasses.replace(LM_CFG, text_weight=0.01, slow=dataclasses.replace(LM_CFG.slow, flash_attention=True))
TRAIN_CFG = LMTrainConfig(accumulate_grad=2, num_warmup_steps=0)
LOSSES = ("train/loss", "train/text_loss", "train/audio_loss")


def _micro_steps(trainer: LMTrainer, state, batches) -> list:
    """The three losses of MICRO_STEPS micro-steps, with one FA, FA-dKV and FA-dQ launch a slow layer each."""
    reset_launches(*FA_KERNELS.values())
    out = []
    for i in range(MICRO_STEPS):
        state, metrics = trainer.train_step(state, batches[i % 2])
        vals = {k: float(v) for k, v in metrics.items()}
        assert all(math.isfinite(x) for x in vals.values()), vals
        n = (i + 1) * LM_CFG.slow.num_layers
        assert fa_launches() == {"FA": n, "FA-dKV": n, "FA-dQ": n}, (i, fa_launches())
        out.append({k: vals[k] for k in LOSSES})
    return out


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "tp+fsdp"])
def test_laid_out_trainer_matches_plain(nccl_group, fsdp):
    """`LMTrainer.shard_state` on `dp_tp_mesh(model=1, data=1)`, tensor
    parallel with and without FSDP (every collective over a group of one):
    4 micro-steps at full width, float32, against the plain trainer on the
    same seed and batches, the losses within TOL_PARALLEL_LOSS."""
    dev = nccl_group
    plain = LMTrainer(FLASH_CFG, TRAIN_CFG, device=dev)
    batches = lm_train_batches(plain, TRAIN_SEQ, 2, seed=4)
    want = _micro_steps(plain, plain.init_state(0), batches)
    del plain
    free_card()
    trainer = LMTrainer(FLASH_CFG, TRAIN_CFG, device=dev)
    state = trainer.shard_state(trainer.init_state(0), dp_tp_mesh(model=1, data=1), fsdp=fsdp)
    got = _micro_steps(trainer, state, batches)
    for g, w in zip(got, want):
        assert max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30) for k in LOSSES) <= TOL_PARALLEL_LOSS, (got, want)


def test_pipelined_decoder_matches_plain(nccl_group):
    """`pipelined_decoder` (1 stage, 2 microbatches) over the slow decoder,
    flash on, float32, 2 x 1024, against the plain decoder: the hidden state,
    every parameter's gradient and the input's; 2 launches of each FA
    kernel a block."""
    dev = nccl_group
    slow = FLASH_CFG.slow
    gen = torch.Generator(device=dev).manual_seed(26)
    with torch.random.fork_rng(devices=[dev]):
        torch.manual_seed(26)
        decoder = Decoder(slow).to(dev)
    x = torch.randn((LM_BATCH, TRAIN_SEQ, slow.hidden_size), device=dev, generator=gen)
    w = torch.randn(x.shape, device=dev, generator=gen)
    fn = pipelined_decoder(decoder, stage_mesh(1), 2)
    xp = x.clone().requires_grad_()
    reset_launches(*FA_KERNELS.values())
    got = fn(xp)
    (got * w).sum().backward()
    assert fa_launches() == {k: 2 * slow.num_layers for k in FA_KERNELS}, fa_launches()
    got_grads = {n: p.grad.clone() for n, p in decoder.named_parameters()}
    decoder.zero_grad(set_to_none=True)
    xr = x.clone().requires_grad_()
    want, _ = decoder(xr)
    (want * w).sum().backward()
    check_close("pipelined decoder hidden", got.detach(), want.detach(), TOL_PIPELINE_OUT)
    for n, p in decoder.named_parameters():
        assert max_err(got_grads[n], p.grad) <= TOL_TRAIN_GRAD * max(p.grad.abs().max().item(), 1e-30), n
    assert max_err(xp.grad, xr.grad) <= TOL_TRAIN_GRAD * max(xr.grad.abs().max().item(), 1e-30)


@torch.no_grad()
def test_time_sharded_codec_matches_one_process(nccl_group):
    """`time_sharded_encode` / `decode` on 2 x 60 s (one clip 3/4 long) at
    the flagship codec width, float32, against the one-process encode /
    decode: the same tokens, the mel within TOL_CHUNKED_DECODE."""
    dev = nccl_group
    ccfg = DMelCodecConfig()
    gen = torch.Generator(device=dev).manual_seed(27)
    with torch.random.fork_rng(devices=[dev]):
        torch.manual_seed(27)
        codec = DMelCodec(ccfg).to(dev).eval()
    t_frames = (SHARDED_SECONDS * SR // HOP // 4) * 4
    mels = torch.randn((2, t_frames, ccfg.n_mels), device=dev, generator=gen)
    lengths = torch.tensor([t_frames, t_frames * 3 // 4], device=dev)
    want_idx, want_len = codec.encode(mels, lengths)
    got_idx, got_len = time_sharded_encode(codec)(mels, lengths)
    assert torch.equal(got_idx, want_idx) and torch.equal(got_len, want_len)
    noise = torch.randn((2, t_frames, ccfg.concat_dim), device=dev, generator=gen)
    check_close("time-sharded decode", time_sharded_decode(codec)(want_idx, want_len, noise),
                codec.decode(want_idx, want_len, noise), TOL_CHUNKED_DECODE)


# ---- the public modules beside the main path -----------------------------------------------

# Each runs on the card and, on the same seeded weights and inputs, on the
# CPU (float32, TF32 off). Tolerances, relative to max |CPU| (random weights
# keep the outputs small: FireflyGAN's waveform peaks near 4e-3, the
# WaveNet's near 5e-2):
#  FireflyGAN: ~100 float32 convs (ConvNeXt, then 5 HiFiGAN stages) in
#    cuDNN's summation order against the CPU's, ~1e-7 relative per op: 1e-4,
#    the zoo's tolerance for the same backbone and head;
#  WaveNet: 20 gated layers of 700-channel float32 convs: 1e-4;
#  Snake: sinf against the CPU's sin, one op: 1e-5;
#  UpSample1d / DownSample1d: one 12-tap depthwise conv: 1e-5.
FIREFLY_CHECK_FRAMES = 173
TOL_FIREFLY, TOL_WAVENET, TOL_SNAKE, TOL_RESAMPLE = 1e-4, 1e-4, 1e-5, 1e-5
S1_SHAPE = (16, 384, 5952)


def _firefly(gen):
    """FireflyGAN at the firefly-gan-base defaults, 1 x 173 frames of 128-band mel, layer scales spread around 1
    (their init, 1e-6, would hide the blocks)."""
    firefly = FireflyGAN().eval()
    with torch.no_grad():
        for name, p in firefly.named_parameters():
            if name.endswith("gamma"):
                p.copy_(1 + 0.05 * torch.randn(p.shape, generator=gen))
    return firefly, (torch.randn(1, FIREFLY_CHECK_FRAMES, 128, generator=gen),), TOL_FIREFLY


def _wavenet(gen):
    """WaveNet(is_diffusion=True) at the codec decoder's width and depth with a condition and a step t in [0, 1000),
    1 x 375 frames."""
    ccfg = DMelCodecConfig()
    c, frames = ccfg.concat_dim, (SECONDS * SR // HOP // 4) * 4
    wavenet = WaveNet(input_channels=c, output_channels=ccfg.n_mels, residual_channels=c,
                      residual_layers=ccfg.decoder_layers, condition_channels=c, is_diffusion=True).eval()
    t = torch.from_numpy(np.random.default_rng(27).uniform(0, 1000, size=1).astype(np.float32))
    return wavenet, (torch.randn(1, c, frames, generator=gen), torch.randn(1, c, frames, generator=gen), t), TOL_WAVENET


def _snake(gen):
    snake = Snake(S1_SHAPE[1], alpha_logscale=True)
    with torch.no_grad():
        snake.alpha.copy_(0.3 * torch.randn(S1_SHAPE[1], generator=gen))
    return snake, (torch.randn(*S1_SHAPE, generator=gen),), TOL_SNAKE


PUBLIC = {"firefly_gan": _firefly, "wavenet_diffusion": _wavenet, "snake": _snake,
          "upsample": lambda gen: (UpSample1d(2), (torch.randn(*S1_SHAPE, generator=gen),), TOL_RESAMPLE),
          "downsample": lambda gen: (DownSample1d(2), (torch.randn(*S1_SHAPE, generator=gen),), TOL_RESAMPLE)}


@torch.no_grad()
@pytest.mark.parametrize("name", sorted(PUBLIC))
def test_public_module_card_vs_cpu(name):
    """The module on the card against the same seeded weights and inputs on
    the CPU: finite, within its tolerance of max |CPU|. FireflyGAN's
    waveform is 512 samples a frame and not near zero; the WaveNet's step t
    reaches its output (at B = 16 on the card); Snake, UpSample1d and
    DownSample1d run at s1's shape [16, 384, 5952]."""
    dev = on_card()
    gen = torch.Generator().manual_seed(27)
    torch.manual_seed(27)
    module, args, rel = PUBLIC[name](gen)
    want = module(*args)
    on_dev = copy.deepcopy(module).to(dev)
    got = on_dev(*(a.to(dev) for a in args))
    assert got.shape == want.shape and torch.isfinite(got).all(), (got.shape, want.shape)
    assert max_err(got.cpu(), want) <= rel * want.abs().max().item()
    if name == "firefly_gan":
        assert got.shape == (1, FIREFLY_CHECK_FRAMES * 512) and got.abs().max().item() > 1e-3
    if name == "wavenet_diffusion":
        xb, cb = (torch.randn(16, *args[0].shape[1:], generator=gen).to(dev) for _ in range(2))
        tb = torch.from_numpy(np.random.default_rng(28).uniform(0, 1000, size=16).astype(np.float32)).to(dev)
        assert max_err(on_dev(xb, cb, tb), on_dev(xb, cb)) > 0.0, "the step t does not reach the output"
