"""The yardstick's arithmetic against counts worked out by hand."""

import math

import pytest

from benchmark import counts
from benchmark.counts import codec, lm, vocoder
from benchmark.tests.conftest import tiny_codec_config, tiny_lm_config


def test_peak_rule():
    assert counts.peak_flops(2) == 989e12
    assert counts.peak_flops(4) == 494.7e12  # float32 counts against one TF32 pass
    with pytest.raises(ValueError):
        counts.peak_flops(1)
    assert counts.least_s(989e12, 0.0, 2) == pytest.approx(1.0)
    assert counts.least_s(0.0, 3.35e12, 4) == pytest.approx(1.0)
    assert counts.least_s(494.7e12, 3.35e12 / 2, 4) == pytest.approx(1.0)  # the larger bound


def test_stage_work_by_hand():
    cfg = {"upsample_initial_channel": 8, "upsample_rates": [2, 2], "upsample_kernel_sizes": [4, 4],
           "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1]], "num_mels": 4}
    # stage 1: C = 2, two frames in -> t_in = 2 * 2 = 4, t = 8; one conv pair of k = 3
    flops, nbytes = vocoder.stage_work(cfg, 1, [2], 4)
    tconv = 2 * 4 * (2 * 2) * 2 * 4  # 2 t_in (2C) C k_up
    convs = 2 * 8 * 2 * 2 * (2 * 3)  # 2 t C C (two convs of k = 3)
    acts = 2 * 58 * 2 * 8  # two activations of 58 flops a sample
    assert flops == tconv + convs + acts
    assert nbytes == (2 * 2 * 4 + 2 * 8) * 4 + (2 * 2 * 2 * 4 + 6 * 2 * 2) * 4
    assert vocoder.stage_work(cfg, 1, [], 4) == (0.0, 0.0)
    # two clips: twice the planes, the weights once
    f2, b2 = vocoder.stage_work(cfg, 1, [2, 2], 4)
    assert f2 == 2 * flops and b2 == nbytes + (2 * 2 * 4 + 2 * 8) * 4


def test_chip_smoke_stage_bound_agrees():
    """The resblock part equals chip_smoke.py's stage_bound_ms conv count."""
    cfg = tiny_codec_config()["vocoder"]
    c, frames = vocoder.stage_channels(cfg, 2), 10
    t = frames * math.prod(cfg["upsample_rates"][:3])
    conv = 2 * c * (1 * c * t) * 6 * sum(cfg["resblock_kernel_sizes"])  # stage_bound_ms, batch 1
    tconv = 2.0 * (t // cfg["upsample_rates"][2]) * 2 * c * c * cfg["upsample_kernel_sizes"][2]
    flops, _ = vocoder.stage_work(cfg, 2, [frames], 4)
    assert flops == pytest.approx(conv + tconv + 18 * 58 * c * t)


def test_lm_counts_by_hand():
    cfg = tiny_lm_config()
    s, f = cfg["slow"], cfg["fast"]
    macs = lambda d: d["num_layers"] * (d["hidden_size"] * (2 * d["hidden_size"] + 2 * d["num_kv_heads"] * d["hidden_size"] // d["num_heads"]) + 3 * d["hidden_size"] * d["intermediate_size"])  # noqa: E731
    assert lm._decoder_macs(s) == macs(s)
    assert lm.attention_pairs(4) == 10
    b, n = 2, 16
    hs, hf, c = s["hidden_size"], f["hidden_size"], cfg["audio_codebook_count"]
    av = c * cfg["audio_codebook_size"]
    want = b * (2 * n * (macs(s) + c * hs * hs + hs * s["vocab_size"])
                + 2 * (n - 1) * (hs * hf + (c + 1) * (macs(f) + hf * av))
                + 4 * hs * lm.attention_pairs(n) * s["num_layers"]
                + (n - 1) * 4 * hf * lm.attention_pairs(c + 1) * f["num_layers"])
    assert lm.forward_flops(cfg, b, n) == pytest.approx(want)
    assert lm.train_flops(cfg, b, n) == pytest.approx(3 * want)
    fl, nb = lm.attention_train_work(cfg, 1, 8, 4)
    hd = hs // s["num_heads"]
    assert fl == s["num_layers"] * 12 * hd * s["num_heads"] * 36
    assert nb == s["num_layers"] * ((6 * 8 * s["num_heads"] * hd + 6 * 8 * s["num_kv_heads"] * hd) * 4 + 3 * s["num_heads"] * 8 * 4)


def test_full_size_counts_match_the_published_scale():
    """The flagship LM's micro-step at 2 x 2048 is ~29 TFLOP (6.8 GFLOP a
    position); a 6 s clip through the float32 vocoder ~1.5 TFLOP."""
    import json

    from benchmark.harness import spec

    lmc = spec.load_json(spec.BENCH / "configs" / "slowfast-qwen2-0.5b.json")
    assert 27e12 < lm.train_flops(lmc, 2, 2048) < 31e12
    cc = json.loads((spec.BENCH / "configs" / "dmel-bigvgan-v2-24k.json").read_text())
    frames = 6 * 24000 // 256
    assert 1.0e12 < vocoder.vocoder_flops(cc["vocoder"], [frames]) < 2.5e12
    assert 0.05e12 < codec.decode_flops(cc["codec"], [frames]) < 0.2e12
    assert lm.generation_flops(lmc, 1, 50, 450) > lm.generation_flops(lmc, 1, 50, 449)
