"""The Nemotron-H long-dialog cell (`lm_dialog_nemotron`, rank 0's expert
share) on the CPU at a size of its own: the configuration's widths cut (6
layers of 64 by the pattern "M*M*EM", Mamba-2 8 heads of 8 in 2 groups with
a state of 16, attention 4 heads over 2 of 24, a router of 16 experts of
which 4 held, 3 a token, 4 codebooks of 16), 3 prompts of 8..24 history
frames and 8..48 text tokens, 6 frames; its set-up, steps, metrics and
check; four faults planted in the program, each read not correct by the
harness's own check; and counts/ssd.py by hand on one small shape.
Card-marked: the cell at its published widths for a few seconds."""

import copy
import json
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import run as bench_run
from benchmark.counts import lm as lm_counts
from benchmark.counts import ssd
from benchmark.harness import runner, spec
from benchmark.reference import lm_ssm as ref
from benchmark.tests.conftest import tiny_codec_config
from benchmark.tests.test_drivers import SEED, contract_shaped

CELL = "lm.longdialog.b16.nemotron-3-nano.bf16"


def tiny_nemotron_config() -> dict:
    cfg = json.loads((spec.BENCH / "configs" / "slowfast-nemotron-3-nano-30b-a3b-ep2.json").read_text())
    cfg.update(vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=6,
               hybrid_override_pattern="M*M*EM", num_attention_heads=4, num_key_value_heads=2, head_dim=24,
               mamba_num_heads=8, mamba_head_dim=8, n_groups=2, ssm_state_size=16, n_routed_experts=4,
               published_n_routed_experts=16, num_experts_per_tok=3, moe_intermediate_size=48,
               moe_shared_expert_intermediate_size=96, audio_codebook_count=4, audio_codebook_size=16,
               bos_token_id=256, eos_token_id=256, start_of_human_id=257, end_of_human_id=258,
               start_of_robot_id=259, end_of_robot_id=260, start_of_music_id=261, end_of_music_id=262,
               text_pad_id=263, slow_audio_pad_id=15, fast_audio_pad_id=12, audio_silence_id=[0, 1, 2, 3])
    cfg["fast"] = dict(cfg["fast"], hidden_size=16, intermediate_size=32, num_layers=2, num_heads=2, num_kv_heads=1)
    return cfg


def tiny_nemotron_cell() -> spec.Cell:
    full = spec.cell(CELL)
    wl = copy.deepcopy(full.workload)
    render = tiny_codec_config()
    render["codec"].update(dmel_groups=4, encoder_residual_channels=4)
    wl["params"].update(batch=3, history_min=8, history_max=24, render=render)
    wl["params"]["inference"].update(max_new_tokens=6, max_seq_len=96)
    return spec.Cell(CELL, full.chips, wl, tiny_nemotron_config(), full.metrics)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_nemotron_cell_runs_on_the_cpu(trace, capsys):
    cell = tiny_nemotron_cell()
    out = runner.run_cell(cell, SEED, 1.0, trace, torch.device("cpu"), time.perf_counter())
    result = bench_run.result_line(cell, out, "cpu")
    contract_shaped(result, cell, trace)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"token_gap", "routing_gap", "routing_differ", "mel_out", "wave"}
    assert "routing choices unlike the reference's" in capsys.readouterr().err
    rec = out["run"].records[0]
    k, s = cell.config["num_experts_per_tok"], 24 + 48 + 7
    assert rec["pairs_prefill"].shape == (1, 16)  # MoE layers, the router's experts
    assert (rec["pairs_prefill"].sum(-1) == 3 * s * k).all()  # every prompt position, pads too
    assert rec["ssd_positions"] == 3 * s * 3 and rec["prompt"] == s  # rows x positions, three Mamba layers
    assert rec["attn_flash"] == 0.0  # the plain core on the CPU
    if trace:
        metrics = result["metrics"]
        assert metrics["frame_ms.nemotron"]["value"] > 0 and metrics["mfu.nemotron"]["value"] > 0
        for name in ("mamba_ms.nemotron", "roofline.ssd.nemotron", "roofline.fa.nemotron"):
            assert name not in metrics  # no device ops on the CPU


def modulo_groups(real):
    def ssd_(x, a, b, c, state=None):
        return real(x, a, b.roll(1, dims=2), c.roll(1, dims=2), state)
    return ssd_


def norm_before_gate(real):
    def gated(self, y, z, channels):
        v = y.unflatten(-1, (-1, self.inner // self.config.mamba_n_groups))
        v = (v * torch.rsqrt(v.square().mean(-1, keepdim=True) + self.norm.eps)).flatten(-2)
        return v * F.silu(z.float()) * self.norm.weight[channels].float()
    return gated


def stateless_step(real):
    def step(self, x, state, conv):
        return real(self, x, state, conv.zero_())
    return step


def rotating(real):
    def forward(self, x, mask, cache=None, cache_rows=None, mask_pos=None):
        from dmel_codec_tpu_torch.models.transformer import apply_rope, rope_cos_sin

        b, s, _ = x.shape
        pos = torch.arange(s).expand(b, s) if mask_pos is None else mask_pos
        cos, sin = rope_cos_sin(pos, self.config.head_dim, 1e4)
        x_q, x_k = self.q_proj, self.k_proj  # the modules; the turned ones shadow them in the instance's dict

        def turned(proj, heads):
            return lambda y: apply_rope(proj(y).view(b, s, heads, -1), cos, sin).flatten(2)

        object.__setattr__(self, "q_proj", turned(x_q, self.config.num_heads))
        object.__setattr__(self, "k_proj", turned(x_k, self.config.num_kv_heads))
        try:
            return real(self, x, mask, cache, cache_rows, mask_pos)
        finally:
            del self.__dict__["q_proj"], self.__dict__["k_proj"]
    return forward


FAULTS = {"modulo_groups": ("nemotron_h", None, "ssd", modulo_groups),
          "norm_before_gate": ("nemotron_h", "Mamba2Mixer", "_gated_norm", norm_before_gate),
          "decode_without_conv_state": ("nemotron_h", "Mamba2Mixer", "_step", stateless_step),
          "rotating_attention": ("nemotron_h", "NoPEAttention", "forward", rotating)}


@pytest.mark.parametrize("fault", ["none", *FAULTS])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    """The program planted with a fault, through the harness's own check: a
    head reading the B / C group h % groups (the groups rolled by one), the
    gated norm taken before the gate, a decode that drops the
    convolution's inputs, an attention that rotates its queries and keys.
    The sound program is correct."""
    import importlib

    if fault != "none":
        module, cls, name, plant = FAULTS[fault]
        owner = importlib.import_module(f"dmel_codec_tpu_torch.models.{module}")
        owner = getattr(owner, cls) if cls else owner
        monkeypatch.setattr(owner, name, plant(getattr(owner, name)))
    cell = tiny_nemotron_cell()
    out = runner.run_cell(cell, SEED, 0.5, False, torch.device("cpu"), time.perf_counter())
    print(fault, {c["name"]: round(c["value"], 4) for c in out["checks"]})
    assert runner.correct(out["checks"]) == (fault == "none"), out["checks"]


def test_the_prompts_fit_the_cache():
    full = spec.cell(CELL).workload["params"]
    assert full["history_max"] + full["prompt_max"] + 7 + full["inference"]["max_new_tokens"] <= full["inference"]["max_seq_len"]


def test_the_parent_stops_before_drawing_weights(monkeypatch):
    """A program without the kind (a TransformerConfig that refuses its
    fields) stops the driver's set-up in `lm_config`, before a weight is
    drawn."""
    from benchmark.drivers import lm_dialog_nemotron as drv
    from benchmark.harness import weights
    from dmel_codec_tpu_torch.models import transformer

    def refuse(*args, **kwargs):
        raise TypeError("TransformerConfig.__init__() got an unexpected keyword argument 'layer_pattern'")

    monkeypatch.setattr(transformer, "TransformerConfig", refuse)
    monkeypatch.setattr(weights, "make", lambda *a, **k: pytest.fail("weights drawn"))
    with pytest.raises(TypeError, match="layer_pattern"):
        drv.Driver(tiny_nemotron_cell(), SEED, torch.device("cpu")).setup()


def test_ssd_counts_by_hand():
    """counts/ssd.py on a shape small enough to count by hand: Mamba-2 8
    heads of 8 in 2 groups with a state of 16 (three Mamba layers), chunks
    of 128; attention 4 heads over 2 of 24 (two layers)."""
    cfg = tiny_nemotron_config()
    flops, nbytes = ssd.scan_work(cfg, positions=100, calls=3, itemsize=2)
    per_pos_head = 128 * 16 * 2 / 8 + 128 * 8 + 2 * 8 * 16  # C N / H + C P + 2 P N multiply-adds
    assert flops == 2 * per_pos_head * 8 * 100
    assert nbytes == 100 * ((2 * 64 + 2 * 32) * 2 + 8 * 4) + 3 * 8 * 8 * 16 * 4
    # one position through a Mamba layer: in_proj 64 x (64 + 128 + 8), out_proj 64 x 64, a 4-tap conv over 128
    assert ssd.mamba_layer_macs(cfg) == 64 * 200 + 64 * 64 + 128 * 4
    assert ssd.attention_layer_macs(cfg) == 2 * 64 * 96 + 2 * 64 * 48
    direct = 0.0
    for name, shape in ref.param_shapes(cfg).items():  # every slow-decoder matrix once, but no routed expert
        if name.startswith("slow_decoder.layers.") and len(shape) > 1 and ".experts." not in name:
            direct += float(np.prod(shape))  # a depthwise conv's [channels, 1, taps]: its multiply-adds too
    assert ssd.decoder_macs(cfg) == direct
    assert ssd.recurrence_flops(cfg, 10) == 2 * 2 * 8 * 8 * 16 * 10 * 3
    f, b = ssd.fa_work(cfg, 2, 10, 2)
    assert f == 2 * (2 * 2 * 24 * 2 * 4 * 55) and b == 2 * (2 * 2 * 10 * 4 * 24 + 2 * 2 * 10 * 2 * 24) * 2
    b_, s, n, pairs = 2, 7, 3, 50
    fc, c, h = cfg["fast"], cfg["audio_codebook_count"], cfg["hidden_size"]
    pos = s + n - 1
    slow = 2 * pos * (direct + c * h * h) + 2 * n * h * cfg["vocab_size"] + ssd.recurrence_flops(cfg, pos)
    slow += 2 * 2 * 4 * 2 * 24 * lm_counts.attention_pairs(pos)  # two attention layers
    fast = 2 * n * (h * fc["hidden_size"] + (c + 1) * lm_counts._decoder_macs(fc) + c * fc["hidden_size"] * c * 16)
    fast += n * 4 * fc["hidden_size"] * lm_counts.attention_pairs(c + 1) * fc["num_layers"]
    assert ssd.generation_flops(cfg, b_, s, n, pairs) == pytest.approx(b_ * (slow + fast) + 2 * pairs * 2 * 64 * 48)


@pytest.mark.card
def test_the_cell_at_its_published_widths():
    """The cell as BENCHMARK.json declares it, on the card: set-up, a short
    window, the check; correct, the prefill's SSD counted, its attention
    on FA."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = spec.cell(CELL)
    out = runner.run_cell(cell, 2**31 + 4103, 1.0, False, torch.device("cuda", 0), time.perf_counter())
    assert runner.correct(out["checks"]), out["checks"]
    rec = out["run"].records[0]
    layers = cell.config["hybrid_override_pattern"].count("M")
    assert rec["ssd_positions"] == 16 * (cell.workload["params"]["history_max"] + 48 + 7) * layers
    assert rec["attn_flash"] == 1.0
