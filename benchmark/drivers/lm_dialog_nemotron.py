"""Closed loop of batched spoken-dialog continuation over a long history,
with a Nemotron-H slow decoder (`model_type` "nemotron_h", HF config.json's
keys at the top level, checked by `reference/lm_ssm.py`): one chip's share
of an expert-parallel deployment, its MoE layers holding `n_routed_experts`
of the router's `published_n_routed_experts`. Each unit is one batch
through `SlowFastGenerator.generate_batched` (an eager prefill of the whole
history into the hybrid cache: the Mamba layers' chunked SSD, the
attention layers' FA; then the frames as replays of a captured CUDA
graph), rendered as `lm_generate` renders it.

Traffic parameters: `lm_dialog`'s (`history_prompts`, the same lengths a
batch in another order). The parameters are the seed's as `lm_dialog`
draws them (`weights.make`, the stacked held experts at N(0, 1 / fan_in)
of one expert, the correction biases at N(0, correction_bias_std^2)), and
each Mamba layer's A_log, dt_bias and D in float32 as HF initialises them
(`params`). The check is `lm_dialog_kimi`'s, with this reference: the
served positions' routing followed from the program's log, the token gap,
the routing's gap and share of different choices, the render's mel_out and
wave. Any other configuration (the harness tests' generic tiny cut gives
every LM cell a Qwen2 one) runs `lm_dialog`'s driver.

Spans: `lm_generate`'s; inside the prefill the program's "lm.prefill",
"lm.mamba", "lm.mamba.scan", "lm.attn", "lm.attn.attend", "lm.moe.*".
Each record carries `replay_s`, the router-width pair counts
`pairs_prefill` / `pairs_decode` ([MoE layers, router's experts]),
`ssd_positions` (rows x positions the prefill's chunked SSD processed,
every Mamba layer counted), `attn_flash` (the share of the attention
calls over several positions that ran on FA) and `prompt`, the prefill's
positions a row.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.counts import ssd as ssd_counts
from benchmark.drivers import codec_requests as codec
from benchmark.drivers import lm_dialog, lm_generate
from benchmark.harness import weights
from benchmark.reference import lm as ref_lm
from benchmark.reference import lm_mla_moe as ref_mla
from benchmark.reference import lm_ssm as ref_ssm
from benchmark.reference import precision

# what the program's Nemotron-H decoder computes; other values are refused
SUPPORTED = {"mamba_hidden_act": "silu", "mlp_hidden_act": "relu2", "attention_bias": False, "mlp_bias": False,
             "mamba_proj_bias": False, "use_bias": False, "use_conv_bias": True, "residual_in_fp32": False,
             "n_group": 1, "topk_group": 1, "norm_topk_prob": True, "tie_word_embeddings": False,
             "sliding_window": None, "chunk_size": 128}


def is_nemotron(cfg: dict) -> bool:
    return cfg.get("model_type") == "nemotron_h"


def lm_config(cfg: dict):
    """The program's SlowFastLMConfig of a Nemotron-H configuration file:
    the router's width is `published_n_routed_experts`, the held share
    `n_routed_experts` from rank x n_routed_experts."""
    if not is_nemotron(cfg):
        raise ValueError(f"a nemotron_h configuration, not model_type {cfg.get('model_type')!r}")
    from dmel_codec_tpu_torch.models.lm import SlowFastLMConfig
    from dmel_codec_tpu_torch.models.transformer import TransformerConfig

    wrong = {k: cfg.get(k) for k, v in SUPPORTED.items() if cfg.get(k) != v}
    if wrong or cfg["layer_norm_epsilon"] != cfg["norm_eps"]:
        raise ValueError(f"the Nemotron-H decoder computes {SUPPORTED} with one norm eps; not {wrong}")
    first, held = ref_ssm.held(cfg)
    slow = TransformerConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"], intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], rms_norm_eps=cfg["layer_norm_epsilon"],
        rope_theta=float(cfg["rope_theta"]), kind="nemotron_h", layer_pattern=cfg["hybrid_override_pattern"],
        mamba_num_heads=cfg["mamba_num_heads"], mamba_head_dim=cfg["mamba_head_dim"],
        ssm_state_size=cfg["ssm_state_size"], mamba_n_groups=cfg["n_groups"], mamba_conv_kernel=cfg["conv_kernel"],
        attention_head_dim=cfg["head_dim"], n_routed_experts=cfg["published_n_routed_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"], moe_intermediate_size=cfg["moe_intermediate_size"],
        n_shared_experts=cfg["n_shared_experts"],
        shared_expert_intermediate_size=cfg["moe_shared_expert_intermediate_size"], mlp_hidden_act="relu2",
        routed_scaling_factor=cfg["routed_scaling_factor"], experts_held=held, expert_offset=first)
    keys = ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads", "num_kv_heads",
            "rms_norm_eps", "rope_theta")
    fast = TransformerConfig(**{k: cfg["fast"][k] for k in keys})
    return SlowFastLMConfig(slow=slow, fast=fast, **{k: cfg[k] for k in lm_dialog.IDS})


def params(cfg: dict, seed: int, dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """The LM's parameters from the seed, as the program and the reference
    both receive them: `lm_dialog.params`' draw of this layout, and each
    Mamba layer's A_log = log U(1, 16), dt_bias = the inverse softplus of
    dt = exp U(log 1e-3, log 1e-1) (at least 1e-4) and D = 1, float32,
    from a generator of their own."""
    p = weights.make(ref_ssm.param_shapes(cfg), seed, dtype, device)
    gen = torch.Generator(device=device).manual_seed((int(seed) + 0x737364) % (2**63))
    lo, hi = math.log(cfg["time_step_min"]), math.log(cfg["time_step_max"])
    for name, t in p.items():
        if name.endswith(("experts.up_proj", "experts.down_proj")):
            t.mul_(math.sqrt(t.shape[1]))
        elif name.endswith("e_score_correction_bias"):
            t.mul_(cfg["correction_bias_std"])
        elif name.endswith(".A_log"):
            p[name] = torch.empty(t.shape, device=device).uniform_(1.0, 16.0, generator=gen).log_()
        elif name.endswith(".dt_bias"):
            dt = torch.empty(t.shape, device=device).uniform_(lo, hi, generator=gen).exp_()
            dt.clamp_(min=cfg["time_step_floor"])
            p[name] = dt + torch.log(-torch.expm1(-dt))
        elif name.endswith(".D"):
            p[name] = torch.ones(t.shape, device=device)
    return p


def Driver(cell, seed: int, device: torch.device):
    return (LongDialog if is_nemotron(cell.config) else lm_dialog.Driver)(cell, seed, device)


class LongDialog(lm_dialog.Dialog):
    def setup(self) -> None:
        from dmel_codec_tpu_torch.lm.generate import InferenceConfig, SlowFastGenerator
        from dmel_codec_tpu_torch.models.lm import ChatMusicLM
        from dmel_codec_tpu_torch.utils.precision import strict_float32

        strict_float32()
        lm_cfg = lm_config(self.cfg)  # first: a program without the decoder's kind stops here
        with torch.device("meta"):
            model = ChatMusicLM(lm_cfg).to(self.dtype)
        model.load_state_dict(params(self.cfg, self.seed, self.dtype, self.device), strict=True, assign=True)
        model.eval()
        icfg = InferenceConfig(**self.p["inference"])
        self.routes = model.slow_decoder.track_routes(self.p["batch"], icfg.max_seq_len)  # before the captures
        self.gens = {False: SlowFastGenerator(model, icfg),
                     True: SlowFastGenerator(model, dataclasses.replace(icfg, temperature=lm_generate.GREEDY_TEMPERATURE))}
        self.adapter = codec.build_adapter(self.render_cfg, self.seed + 1, self.dtype, self.device, self.noise_seed)
        self.prompts = lm_dialog.history_prompts(self.cfg, self.p, self.seed, 8)
        self.draws = torch.Generator(device=self.device).manual_seed(self.seed % (2**63))
        for greedy in (True, False):  # each generator captures its graph; the render's shapes
            self._batch(None, self.prompts[-1], greedy)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _held_pairs(self, stats: dict, steps: int, traced: Optional[int] = None) -> float:
        """This chip's routed (token, expert) pairs of the prefill and of
        the first `frames` frames (`steps`, or the traced ones) of a batch:
        the counter's held columns, the decode's spread evenly over the
        frames the graph ran."""
        first, n = ref_ssm.held(self.cfg)
        prefill, decode = stats["pairs_prefill"], stats["pairs_decode"]
        run = decode.sum() / max(1, decode.shape[0] * self.p["batch"] * self.cfg["num_experts_per_tok"])
        per_frame = decode[:, first:first + n].sum() / max(1.0, run)
        frames = steps if traced is None else min(steps, traced)
        return float(prefill[:, first:first + n].sum() + per_frame * (frames - 1))

    def step(self) -> dict:
        k = self.k
        self.k += 1
        greedy = self._greedy(k)
        prompt = self.prompts[k % len(self.prompts)]
        start = time.perf_counter()
        out = self._batch(k, prompt, greedy)
        end = time.perf_counter()
        stats = self.gens[greedy].stats
        rc = self.render_cfg["codec"]
        down = int(np.prod(rc["downsample_factor"]))
        frames = [int(n) * down for n in out["lengths"]]
        self.outputs[k] = out
        b, s, steps = len(frames), prompt[0].shape[1], out["steps"]
        flops = ssd_counts.generation_flops
        rec = {"k": k, "start": start, "end": end, "greedy": greedy, "gen_s": out["gen_s"],
               "replay_s": stats["replay_s"], "gen_steps": steps, "frames": frames, "encoded": False,
               "audio_s": sum(frames) * rc["hop_length"] / rc["sample_rate"],
               "lm_flops": flops(self.cfg, b, s, steps, self._held_pairs(stats, steps)),
               "pairs_prefill": stats["pairs_prefill"], "pairs_decode": stats["pairs_decode"],
               "ssd_positions": stats.get("ssd_positions", 0), "attn_flash": stats.get("attn_flash", 0.0),
               "prompt": s}
        if out["traced_frames"]:  # the part of the generation inside the trace
            traced = min(steps, out["traced_frames"])
            rec["lm_flops_traced"] = flops(self.cfg, b, s, traced, self._held_pairs(stats, steps, traced))
        if greedy:  # what the served tokens were computed with, for the check
            self.served_routes[k] = self.routes[:, :, :s + steps].clone()
        return rec

    def check(self, records: List[dict], control: Optional[str] = None) -> List[dict]:
        """`lm_dialog.Dialog.check` with this reference (`reference/lm_ssm.py`):
        token_gap with the served positions' routing followed, routing_gap,
        routing_differ, and the render's mel_out and wave."""
        pairs = self.sample(records)
        p = params(self.cfg, self.seed, self.dtype, self.device)
        worst = {"token_gap": 0.0, "routing_gap": 0.0}
        differ = total = 0
        with precision(tf32=False):
            for k, i in pairs:
                token, routing, d, n = self._row_gaps(p, k, i, control)
                worst["token_gap"], worst["routing_gap"] = max(worst["token_gap"], token), max(worst["routing_gap"], routing)
                differ, total = differ + d, total + n
        del p
        worst["routing_differ"] = differ / max(1, total)
        print(f"routing choices unlike the reference's own{' (' + control + ')' if control else ''}: {differ} of "
              f"{total} over {len(pairs)} checked rows", file=sys.stderr)
        worst.update(self.check_render(records, pairs, control))
        return [{"name": n, "value": v, "limit": float(self.p["limits"][n])} for n, v in worst.items()]

    @torch.no_grad()
    def _row_gaps(self, p, k: int, i: int, control: Optional[str]) -> tuple:
        """`lm_dialog.Dialog._row_gaps` with this reference's slow decoder."""
        cfg, icfg, c = self.cfg, self.p["inference"], self.cfg["audio_codebook_count"]
        out = self.outputs[k]
        text, audio = (x[i] for x in self.prompts[k % len(self.prompts)])
        text_ids, audio_ids = out["text_ids"][i], out["audio_ids"][i]
        s, n = len(text), len(text_ids)
        if s < icfg["windows_length"]:
            raise ValueError("the penalty window reaches before the prompt")
        served_t = torch.as_tensor(text_ids, device=self.device)
        served_a = torch.as_tensor(audio_ids, device=self.device)
        window = torch.as_tensor(np.concatenate([audio, audio_ids])[-(n + icfg["windows_length"]):], device=self.device)
        seq_t = torch.as_tensor(np.concatenate([text, text_ids[:-1]]), device=self.device)[None]
        seq_a = torch.as_tensor(np.concatenate([audio, audio_ids[:-1]]), device=self.device)[None]

        def logits(cast, forced, routes):
            q = ref_ssm.outer(p, cast)
            hid = ref_ssm.decoder(p, cfg, ref_lm.embed(q, cfg, seq_t, seq_a), cast, routes, forced)[0, s - 1:]
            text_logits = F.linear(hid, q["text_head.weight"])
            pos0 = F.linear(ref_lm.rms_norm(hid, q["fast_pre_norm.weight"], cfg["fast"]["rms_norm_eps"]),
                            q["fast_projector.weight"], q["fast_projector.bias"])
            fast_in = torch.cat([pos0[:, None], F.embedding(served_a, q["fast_audio_embed.weight"])], 1)
            audio_logits = F.linear(ref_lm.decoder(q, "fast_decoder", cfg["fast"], fast_in)[:, :c], q["audio_head.weight"])
            return text_logits, lm_generate.penalized(audio_logits, window, icfg)

        pick_t, pick_a = served_t, served_a
        forced = self.served_routes[k][:, i, :s + n - 1].long()  # [MoE layers, positions, k]
        if control == "fp8":
            own: List[tuple] = []
            low_t, low_a = logits(lm_dialog.fp8, None, own)
            pick_t, pick_a = low_t.argmax(-1), low_a.argmax(-1)
            forced = torch.stack([o for o, _ in own])
        routes: List[tuple] = []
        ref_t, ref_a = logits(ref_mla._float, forced, routes)
        gap_t = ref_t.max(-1).values - ref_t.gather(-1, pick_t[:, None])[:, 0]
        gap_a = ref_a.max(-1).values - ref_a.gather(-1, pick_a[..., None])[..., 0]
        return (float(torch.cat([gap_t, gap_a.flatten()]).max()),) + lm_dialog.routing_numbers(routes, forced)
