"""The long-dialog cell (`lm_dialog_kimi`, Kimi Linear's slow decoder,
rank 0's expert share) on the CPU at a size of its own: the
configuration's widths cut (5 layers of 64, KDA at 0, 1, 2 and 4 with 2
heads of 16, latent attention at 3 with 4 heads, a router of 16 experts
of which 4 held, 3 a token, 4 codebooks of 16), 3 prompts of 8..24
history frames and 8..48 text tokens, 6 frames; its set-up, steps,
metrics and check; three faults planted in the program, each read not
correct by the harness's own check; and counts/kda.py by hand on one
small shape. Card-marked: the cell at its published widths on two seeds."""

import copy
import json
import time

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.counts import kda
from benchmark.counts import lm as lm_counts
from benchmark.harness import runner, spec
from benchmark.reference import lm_kda as ref
from benchmark.tests.conftest import tiny_codec_config
from benchmark.tests.test_drivers import SEED, contract_shaped

CELL = "lm.longdialog.b16.kimi-linear.bf16"


def tiny_kimi_config() -> dict:
    cfg = json.loads((spec.BENCH / "configs" / "slowfast-kimi-linear-48b-a3b-ep4.json").read_text())
    cfg.update(vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=5, num_attention_heads=4,
               num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
               num_experts=4, published_num_experts=16, num_experts_per_token=3, moe_intermediate_size=48,
               audio_codebook_count=4, audio_codebook_size=16, bos_token_id=256, eos_token_id=256,
               start_of_human_id=257, end_of_human_id=258, start_of_robot_id=259, end_of_robot_id=260,
               start_of_music_id=261, end_of_music_id=262, text_pad_id=263, slow_audio_pad_id=15,
               fast_audio_pad_id=12, audio_silence_id=[0, 1, 2, 3])
    cfg["linear_attn_config"] = dict(cfg["linear_attn_config"], kda_layers=[1, 2, 3, 5], full_attn_layers=[4],
                                     num_heads=2, head_dim=16)
    cfg["fast"] = dict(cfg["fast"], hidden_size=16, intermediate_size=32, num_layers=2, num_heads=2, num_kv_heads=1)
    return cfg


def tiny_longdialog_cell() -> spec.Cell:
    full = spec.cell(CELL)
    wl = copy.deepcopy(full.workload)
    render = tiny_codec_config()
    render["codec"].update(dmel_groups=4, encoder_residual_channels=4)
    wl["params"].update(batch=3, history_min=8, history_max=24, render=render)
    wl["params"]["inference"].update(max_new_tokens=6, max_seq_len=96)
    return spec.Cell(CELL, full.chips, wl, tiny_kimi_config(), full.metrics)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_longdialog_cell_runs_on_the_cpu(trace, capsys):
    cell = tiny_longdialog_cell()
    out = runner.run_cell(cell, SEED, 1.0, trace, torch.device("cpu"), time.perf_counter())
    result = bench_run.result_line(cell, out, "cpu")
    contract_shaped(result, cell, trace)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"token_gap", "routing_gap", "routing_differ", "mel_out", "wave"}
    assert "routing choices unlike the reference's" in capsys.readouterr().err
    rec = out["run"].records[0]
    k = cell.config["num_experts_per_token"]
    assert rec["pairs_prefill"].shape == (4, 16)  # MoE layers, the router's experts
    assert (rec["pairs_prefill"].sum(-1) == 3 * (24 + 48 + 7) * k).all()  # every prompt position, pads too
    assert rec["kda_positions"] == 3 * (24 + 48 + 7) * 4  # rows x positions, four KDA layers
    if trace:
        metrics = result["metrics"]
        assert metrics["frame_ms.longdialog"]["value"] > 0 and metrics["mfu.longdialog"]["value"] > 0
        assert "roofline.kda.longdialog" not in metrics and "kda_ms.longdialog" not in metrics  # no device ops


def per_head_gate(real):
    def gate(self, pre, heads):
        a = real(self, pre, heads)
        return a.mean(-1, keepdim=True).expand_as(a)
    return gate


def stateless_step(real):
    def step(self, x, state, conv):
        return real(self, x, state, conv.zero_())
    return step


def wrapped_share(real):
    def routed(self, x, chosen, w):
        return real(self, x, chosen % self.gate_up_proj.shape[0], w)
    return routed


FAULTS = {"per_head_gate": ("kimi_linear", "KimiDeltaAttention", "_gate", per_head_gate),
          "decode_without_conv_state": ("kimi_linear", "KimiDeltaAttention", "_step", stateless_step),
          "wrapped_share": ("deepseek_v3", "Experts", "routed", wrapped_share)}


@pytest.mark.parametrize("fault", ["none", *FAULTS])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    """The program planted with a fault, through the harness's own check: a
    forget gate a head (the channels' mean) in place of one a channel, a
    decode that drops the convolutions' inputs, a share that computes a
    pair routed to an absent expert with the held expert its id wraps onto.
    The sound program is correct."""
    import importlib

    if fault != "none":
        module, cls, name, plant = FAULTS[fault]
        owner = getattr(importlib.import_module(f"dmel_codec_tpu_torch.models.{module}"), cls)
        monkeypatch.setattr(owner, name, plant(getattr(owner, name)))
    cell = tiny_longdialog_cell()
    out = runner.run_cell(cell, SEED, 0.5, False, torch.device("cpu"), time.perf_counter())
    print(fault, {c["name"]: round(c["value"], 4) for c in out["checks"]})
    assert runner.correct(out["checks"]) == (fault == "none"), out["checks"]


def test_the_prompts_fit_the_cache():
    full = spec.cell(CELL).workload["params"]
    assert full["history_max"] + full["prompt_max"] + 7 + full["inference"]["max_new_tokens"] <= full["inference"]["max_seq_len"]


def test_kda_counts_by_hand():
    """counts/kda.py on a shape small enough to count by hand: 2 KDA heads
    of 16 (4 layers of KDA), chunks of 64."""
    cfg = tiny_kimi_config()
    flops, nbytes = kda.scan_work(cfg, positions=100, calls=3, itemsize=2)
    per_head = 4 * 64 * 64 * 16 + 3 * 64 * 16 * 16  # 4 C^2 d + 3 C d^2 multiply-adds a chunk
    assert flops == 2 * per_head / 64 * 2 * 100
    assert nbytes == 100 * 2 * (4 * 16 * 2 + 17 * 4) + 3 * 2 * 16 * 16 * 4
    # one position through a KDA layer: q, k, v 64 x 32 each, the gates 64 x 16 + 16 x 32 twice, beta 64 x 2,
    # the output 32 x 64, three 4-tap convolutions over 32 channels
    assert kda.kda_layer_macs(cfg) == 3 * 64 * 32 + 2 * (64 * 16 + 16 * 32) + 64 * 2 + 32 * 64 + 3 * 32 * 4
    direct = 0.0
    for name, shape in ref.param_shapes(cfg).items():  # every slow-decoder matrix once, but no routed expert
        if name.startswith("slow_decoder.layers.") and len(shape) > 1 and ".experts." not in name:
            direct += float(np.prod(shape))
    assert kda.decoder_macs(cfg) == direct
    assert kda.recurrence_flops(cfg, 10) == 2 * 3 * 2 * 16 * 16 * 10 * 4
    b, s, n, pairs = 2, 7, 3, 50
    f, c, h = cfg["fast"], cfg["audio_codebook_count"], cfg["hidden_size"]
    pos = s + n - 1
    slow = 2 * pos * (direct + c * h * h) + 2 * n * h * cfg["vocab_size"] + kda.recurrence_flops(cfg, pos)
    slow += 2 * 4 * (48 + 32) * lm_counts.attention_pairs(pos)  # one latent attention layer
    fast = 2 * n * (h * f["hidden_size"] + (c + 1) * lm_counts._decoder_macs(f) + c * f["hidden_size"] * c * 16)
    fast += n * 4 * f["hidden_size"] * lm_counts.attention_pairs(c + 1) * f["num_layers"]
    assert kda.generation_flops(cfg, b, s, n, pairs) == pytest.approx(b * (slow + fast) + 2 * pairs * 3 * 64 * 48)


@pytest.mark.card
@pytest.mark.parametrize("seed", [2**31 + 4101, 2**31 + 4102])
def test_the_cell_at_its_published_widths(seed):
    """The cell as BENCHMARK.json declares it, on the card: set-up, a short
    window, the check; correct, and the prefill's scan counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = spec.cell(CELL)
    out = runner.run_cell(cell, seed, 1.0, False, torch.device("cuda", 0), time.perf_counter())
    assert runner.correct(out["checks"]), out["checks"]
    rec = out["run"].records[0]
    layers = len(cell.config["linear_attn_config"]["kda_layers"])
    assert rec["kda_positions"] == 16 * (cell.workload["params"]["history_max"] + 48 + 7) * layers
