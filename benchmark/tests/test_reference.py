"""The frozen references against the port, module by module, on the CPU at
small widths: the same seeded parameters by name in both, float32."""

import numpy as np
import torch

from benchmark.drivers import codec_requests, lm_generate, lm_train
from benchmark.harness import weights
from benchmark.reference import bigvgan as ref_bigvgan
from benchmark.reference import codec as ref_codec
from benchmark.reference import lm as ref_lm
from benchmark.tests.conftest import tiny_codec_config, tiny_lm_config

TOL = 2e-5  # float32, relative to the largest magnitude


def close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


def codec_models(cfg):
    from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
    from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig

    params = codec_requests.make_params(cfg, 7, torch.float32, "cpu")
    codec = DMelCodec(DMelCodecConfig(**codec_requests._tuples(cfg["codec"])))
    vocoder = BigVGAN(BigVGANConfig(**codec_requests._tuples(cfg["vocoder"])))
    codec.load_state_dict(params["codec"], strict=True)
    vocoder.load_state_dict(params["vocoder"], strict=True)
    return params, codec.eval(), vocoder.eval()


def test_shapes_are_the_programs():
    params, codec, vocoder = codec_models(tiny_codec_config())
    assert {k: tuple(v.shape) for k, v in codec.state_dict().items()} == {k: tuple(v.shape) for k, v in params["codec"].items()}
    from dmel_codec_tpu_torch.models.lm import ChatMusicLM

    with torch.device("meta"):
        lm = ChatMusicLM(lm_train.lm_config(tiny_lm_config(), flash=False))
    assert {k: tuple(v.shape) for k, v in lm.state_dict().items()} == dict(ref_lm.param_shapes(tiny_lm_config()))


@torch.no_grad()
def test_codec_and_vocoder():
    from dmel_codec_tpu_torch.dsp.spectrogram import LogMelSpectrogram

    cfg = tiny_codec_config()
    cc = cfg["codec"]
    params, codec, vocoder = codec_models(cfg)
    audio = codec_requests.audio_pool(3, 2, 12000, cc["sample_rate"], "cpu")
    audio[1, 9000:] = 0.0
    x = torch.from_numpy(audio)
    mel = ref_codec.log_mel(x, cc["sample_rate"], cc["n_mels"], cc["hop_length"])
    close(mel, LogMelSpectrogram(n_mels=cc["n_mels"])(x))
    t = codec_requests.mel_frames(audio.shape[1], cc)
    lengths = torch.as_tensor(codec_requests.valid_frames(np.array([12000, 9000]), cc))
    idx, _ = codec.encode(mel[:, :t], lengths.int())
    assert torch.equal(ref_codec.encode(params["codec"], cc, mel[:, :t], lengths).long(), idx.long())
    noise = torch.randn(2, t, cc["dmel_groups"] * cc["encoder_residual_channels"])
    close(ref_codec.decode(params["codec"], cc, idx, lengths // 4, noise), codec.decode(idx, lengths // 4, noise))
    m = torch.randn(2, 12, cc["n_mels"]) * 0.3
    close(ref_bigvgan.vocode(params["vocoder"], cfg["vocoder"], m), vocoder(m))


def test_lm_loss_and_gradients():
    from dmel_codec_tpu_torch.train.lm_trainer import LMTrainConfig, LMTrainer

    cfg = tiny_lm_config()
    p = {"batch": 2, "seq": 64, "text_min": 4, "text_max": 10, "pad_max": 6, "pool": 1}
    batch = {k: torch.as_tensor(v) for k, v in lm_train.make_batches(cfg, p, 5)[0].items()}
    trainer = LMTrainer(lm_train.lm_config(cfg, flash=False), LMTrainConfig(accumulate_grad=1), device="cpu")
    params = weights.make(ref_lm.param_shapes(cfg), 9, torch.float32, "cpu")
    trainer.model.load_state_dict(params, strict=True)
    leaves = dict(trainer.model.named_parameters())
    (loss, _), grads = trainer.loss_fn(leaves, batch, wrt=list(leaves.values()))
    ref_loss, ref_grads = ref_lm.loss_and_grads(params, cfg, batch)
    assert abs(float(loss.detach()) - ref_loss) <= 1e-5 * abs(ref_loss)
    for (name, g), want in zip(leaves.items(), grads):
        close(ref_grads[name], want, 1e-4)


def test_adamw_update_matches_the_optimizer():
    from dmel_codec_tpu_torch.train.lm_trainer import LMTrainConfig, _decay_mask
    from dmel_codec_tpu_torch.train.optim import AccumulatingAdamW
    from dmel_codec_tpu_torch.train.schedule import cosine_schedule_with_warmup

    train = {"learning_rate": 1e-3, "betas": [0.8, 0.99], "eps": 1e-5, "weight_decay": 0.08, "grad_clip": 1.0,
             "num_warmup_steps": 0, "num_training_steps": 100, "final_lr_ratio": 0.2, "accumulate_grad": 2}
    gen = torch.Generator().manual_seed(1)
    params = {"a.weight": torch.randn(4, 3, generator=gen), "a.bias": torch.randn(4, generator=gen),
              "norm.weight": torch.randn(4, generator=gen)}
    grads = [{k: torch.randn(v.shape, generator=gen) for k, v in params.items()} for _ in range(4)]
    mine = {k: v.clone() for k, v in params.items()}
    c = LMTrainConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in train.items()})
    opt = AccumulatingAdamW(params, _decay_mask(params), c, cosine_schedule_with_warmup(1e-3, 0, 100, final_lr_ratio=0.2))
    state = {}
    for i in range(0, 4, 2):
        opt.update([grads[i][k].clone() for k in params])
        opt.update([grads[i + 1][k].clone() for k in params])
        ref_lm.adamw_update(mine, {k: (grads[i][k] + grads[i + 1][k]) / 2 for k in params}, state, train)
    for k in params:
        close(mine[k], params[k], 1e-6)


@torch.no_grad()
def test_served_greedy_tokens_have_no_gap():
    """The reference's own greedy tokens read a gap of 0; another token reads more."""
    cfg = tiny_lm_config()
    p = {k: v.float() for k, v in weights.make(ref_lm.param_shapes(cfg), 4, torch.float32, "cpu").items()}
    icfg = {"windows_length": 16, "windows_penalty": 1.2}
    text, audio = lm_generate.make_prompts(cfg, {"batch": 1, "prompt_min": 12, "prompt_max": 12}, 3, 1)[0]
    text, audio = text[0], audio[0]
    text_ids, audio_ids = [], []
    for _ in range(4):  # decode greedily with the reference itself, frame by frame
        ids_t = np.asarray(text_ids + [0], np.int64)
        ids_a = np.asarray(audio_ids + [[0] * 10], np.int64).reshape(-1, 10)
        seq_t = torch.as_tensor(np.concatenate([text, ids_t[:-1]]))[None]
        seq_a = torch.as_tensor(np.concatenate([audio, ids_a[:-1]]))[None]
        hid = ref_lm.decoder(p, "slow_decoder", cfg["slow"], ref_lm.embed(p, cfg, seq_t, seq_a))[0, -1]
        text_ids.append(int(torch.nn.functional.linear(hid, p["text_head.weight"]).argmax()))
        frame = []
        for i in range(10):
            toks = torch.as_tensor(frame + [0] * (10 - len(frame)))[None]
            pos0 = torch.nn.functional.linear(ref_lm.rms_norm(hid[None], p["fast_pre_norm.weight"], 1e-6),
                                              p["fast_projector.weight"], p["fast_projector.bias"])
            x = torch.cat([pos0[:, None], torch.nn.functional.embedding(toks, p["fast_audio_embed.weight"])], 1)
            logits = torch.nn.functional.linear(ref_lm.decoder(p, "fast_decoder", cfg["fast"], x)[0, i], p["audio_head.weight"])
            win = np.concatenate([audio, np.asarray(audio_ids, np.int64).reshape(-1, 10)])[-16:, i]
            if audio_ids:
                logits = torch.where(torch.isin(torch.arange(logits.shape[0]), torch.as_tensor(win)),
                                     torch.where(logits < 0, logits * 1.2, logits / 1.2), logits)
            frame.append(int(logits.argmax()))
        audio_ids.append(frame)
    t, a = np.asarray(text_ids), np.asarray(audio_ids)
    assert lm_generate.token_gap(p, cfg, icfg, text, audio, t, a, None, "cpu") <= 1e-5
    a2 = a.copy()
    a2[2, 3] = (a2[2, 3] + 7) % 1800
    assert lm_generate.token_gap(p, cfg, icfg, text, audio, t, a2, None, "cpu") > 1e-3


def test_program_greedy_generation_in_float32_reads_no_gap():
    """The program's own greedy generation (float32, float32 cache) against
    the reference's teacher-forced logits: the gap is rounding alone."""
    import time

    from benchmark.harness import runner
    from benchmark.tests.conftest import tiny_cell

    cell = tiny_cell("lm.serve.b16.bf16")
    p = cell.workload["params"]
    p.update(dtype="float32", greedy_every=1)
    p["inference"]["cache_dtype"] = "float32"
    out = runner.run_cell(cell, 77, 0.2, False, torch.device("cpu"), time.perf_counter())
    got = {c["name"]: c["value"] for c in out["checks"]}
    assert got["token_gap"] <= 1e-4 and got["wave"] <= 1e-4
