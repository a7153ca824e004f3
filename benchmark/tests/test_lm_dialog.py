"""The dialog cell (`lm_dialog`, Moonlight-16B-A3B's DeepSeek-V3 slow
decoder) on the CPU at a size of its own: the configuration's widths cut
(3 layers of 64, 4 heads, latent 32, 8 experts of which 3 a token, 4
codebooks of 16), 3 prompts of 8..24 history frames and 8..48 text tokens,
6 frames; its set-up, steps, metrics and check; and counts/moe.py against
a direct count over the reference's parameter shapes."""

import copy
import json
import time

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.counts import lm as lm_counts
from benchmark.counts import moe
from benchmark.harness import runner, spec
from benchmark.reference import lm_mla_moe as ref
from benchmark.tests.conftest import tiny_codec_config
from benchmark.tests.test_drivers import SEED, contract_shaped

CELL = "lm.dialog.b16.moonlight.bf16"


def tiny_moonlight_config() -> dict:
    cfg = json.loads((spec.BENCH / "configs" / "slowfast-moonlight-16b-a3b.json").read_text())
    cfg.update(vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=3, num_attention_heads=4,
               num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
               n_routed_experts=8, num_experts_per_tok=3, moe_intermediate_size=48, n_shared_experts=1,
               audio_codebook_count=4, audio_codebook_size=16, bos_token_id=256, eos_token_id=256,
               start_of_human_id=257, end_of_human_id=258, start_of_robot_id=259, end_of_robot_id=260,
               start_of_music_id=261, end_of_music_id=262, text_pad_id=263, slow_audio_pad_id=15,
               fast_audio_pad_id=12, audio_silence_id=[0, 1, 2, 3])
    cfg["fast"] = dict(cfg["fast"], hidden_size=16, intermediate_size=32, num_layers=2, num_heads=2, num_kv_heads=1)
    return cfg


def tiny_dialog_cell(**router) -> spec.Cell:
    full = spec.cell(CELL)
    wl = copy.deepcopy(full.workload)
    render = tiny_codec_config()
    render["codec"].update(dmel_groups=4, encoder_residual_channels=4)
    wl["params"].update(batch=3, history_min=8, history_max=24, render=render)
    wl["params"]["inference"].update(max_new_tokens=6, max_seq_len=96)
    return spec.Cell(CELL, full.chips, wl, dict(tiny_moonlight_config(), **router), full.metrics)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_dialog_cell_runs_on_the_cpu(trace, capsys):
    cell = tiny_dialog_cell()
    out = runner.run_cell(cell, SEED, 1.0, trace, torch.device("cpu"), time.perf_counter())
    result = bench_run.result_line(cell, out, "cpu")
    contract_shaped(result, cell, trace)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"token_gap", "routing_gap", "routing_differ", "mel_out", "wave"}
    assert "routing choices unlike the reference's" in capsys.readouterr().err
    rec = out["run"].records[0]
    layers = cell.config["num_hidden_layers"] - cell.config["first_k_dense_replace"]
    k = cell.config["num_experts_per_tok"]
    assert rec["pairs_prefill"].shape == (layers, 8)
    assert (rec["pairs_prefill"].sum(-1) == 3 * (24 + 48 + 7) * k).all()  # every prompt position, pads too
    assert (rec["pairs_decode"].sum(-1) > 0).all()
    if trace:
        metrics = result["metrics"]
        assert metrics["expert_skew.dialog"]["value"] >= 1.0 and metrics["frame_ms.dialog"]["value"] > 0
        assert "roofline.experts.dialog" not in metrics  # no device operations on the CPU


def select_unbiased(scores, biased, k):
    return torch.topk(scores, k, dim=-1).indices


def select_seventh_for_sixth(scores, biased, k):
    best = torch.topk(biased, k + 1, dim=-1).indices
    return torch.cat([best[:, :k - 1], best[:, k:]], dim=-1)


def select_second_to_seventh(scores, biased, k):
    return torch.topk(biased, k + 1, dim=-1).indices[:, 1:]


ROUTER_FAULTS = {"unbiased": select_unbiased, "seventh_for_sixth": select_seventh_for_sixth,
                 "second_to_seventh": select_second_to_seventh}


def planted(select):
    """`TopkRouter.forward` with its selection replaced by `select(scores,
    scores + correction bias, k)`; the weights as the program makes them."""
    from dmel_codec_tpu_torch.models.deepseek_v3 import NORM_EPS

    def forward(self, x):
        scores = torch.sigmoid(torch.nn.functional.linear(x.float(), self.weight.float()))
        chosen = select(scores, scores + self.e_score_correction_bias.float(), self.top_k)
        w = scores.gather(1, chosen)
        return chosen, w * (self.scaling / (w.sum(dim=-1, keepdim=True) + NORM_EPS))

    return forward


@pytest.mark.parametrize("fault", ["none", *ROUTER_FAULTS])
def test_a_router_fault_is_not_correct(fault, monkeypatch):
    """The program's router planted with a fault that picks experts near
    the margin (selecting without the correction bias, the 7th best in
    place of the 6th, the 2nd..7th best), through the harness's own check:
    the reference follows the served choices, so only routing_differ, the
    share of the served choices unlike the reference's own, can tell. At
    the published router (64 experts, 6 a token), whose margins the faults
    must cross; the sound router is correct."""
    from dmel_codec_tpu_torch.models.deepseek_v3 import TopkRouter

    if fault != "none":
        monkeypatch.setattr(TopkRouter, "forward", planted(ROUTER_FAULTS[fault]))
    cell = tiny_dialog_cell(n_routed_experts=64, num_experts_per_tok=6)
    out = runner.run_cell(cell, SEED, 0.5, False, torch.device("cpu"), time.perf_counter())
    differ = next(c for c in out["checks"] if c["name"] == "routing_differ")
    print(f"{fault}: routing_differ {differ['value']:.4f}")
    assert runner.correct(out["checks"]) == (fault == "none"), out["checks"]
    assert (differ["value"] > differ["limit"]) == (fault != "none")


def test_the_prompts_share_one_shape():
    from benchmark.drivers.lm_dialog import history_prompts

    cell = tiny_dialog_cell()
    p = cell.workload["params"]
    batches = history_prompts(cell.config, p, SEED, 3)
    assert len({t.shape for t, _ in batches}) == 1
    text, audio = batches[0]
    assert text.shape[1] == 24 + 48 + 7  # the longest history with the longest text prompt's grid
    full = spec.cell(CELL).workload["params"]
    assert full["history_max"] + full["prompt_max"] + 7 + full["inference"]["max_new_tokens"] <= full["inference"]["max_seq_len"]


def direct_active_macs(cfg: dict) -> float:
    """One position's multiply-adds, read off the reference's parameter
    shapes: every matrix of the slow decoder's layers once, but a stacked
    expert tensor only for num_experts_per_tok of its experts."""
    total = 0.0
    for name, shape in ref.param_shapes(cfg).items():
        if not name.startswith("slow_decoder.layers.") or len(shape) == 1:
            continue
        n = float(np.prod(shape))
        total += n / shape[0] * cfg["num_experts_per_tok"] if len(shape) == 3 else n
    return total


@pytest.mark.parametrize("which", ["tiny", "full"])
def test_moe_counts_match_a_direct_count(which):
    cfg = tiny_moonlight_config() if which == "tiny" else json.loads(
        (spec.BENCH / "configs" / "slowfast-moonlight-16b-a3b.json").read_text())
    assert moe.decoder_macs(cfg) == pytest.approx(direct_active_macs(cfg))
    pairs = np.zeros((2, cfg["n_routed_experts"]), np.int64)
    pairs[0, 1], pairs[1, 0], pairs[1, 3] = 5, 2, 1
    flops, nbytes = moe.experts_work(cfg, pairs, 2)
    h, i = cfg["hidden_size"], cfg["moe_intermediate_size"]
    assert flops == 8 * 2 * 3 * h * i
    assert nbytes == 3 * (3 * h * i) * 2 + 8 * 2 * h * 2  # three experts' weights, eight pairs in and out
    # the generation: the decoder's active work and attention over the visible pairs, plus the rest as counts/lm.py
    b, s, n = 2, 7, 3
    f, c = cfg["fast"], cfg["audio_codebook_count"]
    pos = s + n - 1
    qkv = 192 + 128 if which == "full" else 48 + 32  # a head: q.k over nope + rope, then the value
    att = 2 * cfg["num_attention_heads"] * qkv * lm_counts.attention_pairs(pos) * cfg["num_hidden_layers"]
    slow = 2 * pos * (direct_active_macs(cfg) + c * h * h + h * cfg["vocab_size"]) + att
    fast = 2 * n * (h * f["hidden_size"] + (c + 1) * lm_counts._decoder_macs(f) + c * f["hidden_size"] * c * cfg["audio_codebook_size"])
    fast += n * 4 * f["hidden_size"] * lm_counts.attention_pairs(c + 1) * f["num_layers"]
    assert moe.generation_flops(cfg, b, s, n) == pytest.approx(b * (slow + fast))


def test_full_size_generation_is_three_billion_active():
    """Moonlight's ~3 B active parameters a position (A3B): the decoder's
    active matrices 2.2 B, the embedding projector and the text head."""
    cfg = json.loads((spec.BENCH / "configs" / "slowfast-moonlight-16b-a3b.json").read_text())
    assert 2.1e9 < moe.decoder_macs(cfg) < 2.3e9
    h = cfg["hidden_size"]
    assert 2.6e9 < moe.decoder_macs(cfg) + 10 * h * h + h * cfg["vocab_size"] < 2.7e9
