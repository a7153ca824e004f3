"""Closed loop of batched spoken-dialog continuation rendered to audio: each
unit is one batch of prompts, each a conversation's history of audio
frames followed by a text prompt, through
`SlowFastGenerator.generate_batched` (an eager prefill of the whole history
into the cache, then the frames as replays of a captured CUDA graph), then
every row's tokens through the codec and vocoder as `lm_generate` renders
them: a reply generated against a minute or two of conversation already in
the cache.

Traffic parameters: `lm_generate`'s, and
  history_min, history_max
                   audio frames of history a prompt: every batch holds the
                   same lengths, evenly spread over [min, max], each with
                   the text prompt of the same rank (so every batch has one
                   padded shape), in another order; codebook ids drawn from
                   the seed, the text column at text_pad_id. A history
                   longer than max_seq_len leaves room for is cut to fit
                   (never at the cell's own size).

The configuration is a DeepSeek-V3 slow decoder (`model_type`
"deepseek_v3", HF config.json's keys at the top level, checked by
`reference/lm_mla_moe.py`). The parameters are the seed's, with the
routers' correction biases drawn as N(0, correction_bias_std^2) and the
stacked experts as N(0, 1 / fan_in) of one expert (`params`); the check
follows the served positions' routing, read from the program's routing log
after each greedy batch (`Dialog.check`). Any other configuration (the
harness tests' generic tiny cut gives every LM cell a Qwen2 one) runs
`lm_generate`'s driver, with the routing checks at 0 (`Qwen2`).

Spans: `lm_generate`'s; inside the prefill the program's "lm.prefill",
"lm.mla", "lm.moe.route", "lm.moe.experts", "lm.moe.shared". Each record
carries the host seconds of its frames after the prefill (`replay_s`) and
the batch's routed (token, expert) pairs from the program's counter,
prefill and decode apart ([moe layers, experts]).
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

from benchmark.counts import moe as moe_counts
from benchmark.drivers import codec_requests as codec
from benchmark.drivers import lm_generate
from benchmark.harness import weights
from benchmark.reference import lm as ref_lm
from benchmark.reference import lm_mla_moe as ref_mla
from benchmark.reference import precision

# what the program's DeepSeek-V3 decoder computes; other values are refused
SUPPORTED = {"scoring_func": "sigmoid", "topk_method": "noaux_tc", "q_lora_rank": None, "norm_topk_prob": True,
             "attention_bias": False, "hidden_act": "silu", "tie_word_embeddings": False, "moe_layer_freq": 1,
             "num_nextn_predict_layers": 0}
IDS = ("audio_codebook_count", "audio_codebook_size", "bos_token_id", "eos_token_id", "start_of_human_id",
       "end_of_human_id", "start_of_robot_id", "end_of_robot_id", "start_of_music_id", "end_of_music_id",
       "text_pad_id", "slow_audio_pad_id", "fast_audio_pad_id", "text_weight", "audio_weight")


# the checks of the routing, besides lm_generate's
ROUTING_CHECKS = ("routing_gap", "routing_differ")


def is_moe(cfg: dict) -> bool:
    return cfg.get("model_type") == "deepseek_v3"


def lm_config(cfg: dict):
    """The program's SlowFastLMConfig of a DeepSeek-V3 configuration file."""
    if not is_moe(cfg):
        raise ValueError(f"a deepseek_v3 configuration, not model_type {cfg.get('model_type')!r}")
    from dmel_codec_tpu_torch.models.lm import SlowFastLMConfig
    from dmel_codec_tpu_torch.models.transformer import TransformerConfig

    wrong = {k: cfg.get(k) for k, v in SUPPORTED.items() if cfg.get(k) != v}
    if wrong or cfg["n_group"] != cfg["topk_group"]:
        raise ValueError(f"the DeepSeek-V3 decoder computes {SUPPORTED} with n_group = topk_group; not {wrong}")
    slow = TransformerConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"], intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], rms_norm_eps=cfg["rms_norm_eps"],
        rope_theta=float(cfg["rope_theta"]), kind="deepseek_v3", kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"], qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"], n_routed_experts=cfg["n_routed_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"], moe_intermediate_size=cfg["moe_intermediate_size"],
        n_shared_experts=cfg["n_shared_experts"], first_k_dense_replace=cfg["first_k_dense_replace"],
        routed_scaling_factor=cfg["routed_scaling_factor"])
    keys = ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads", "num_kv_heads",
            "rms_norm_eps", "rope_theta")
    fast = TransformerConfig(**{k: cfg["fast"][k] for k in keys})
    return SlowFastLMConfig(slow=slow, fast=fast, **{k: cfg[k] for k in IDS})


def params(cfg: dict, seed: int, dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """The LM's parameters from the seed, as the program and the reference
    both receive them. DeepSeek-V3: weights.make's draw, then each stacked
    expert tensor [E, out, in] to N(0, 1 / in) (weights.make takes its
    fan-in over every expert) and each correction bias to N(0,
    correction_bias_std^2) (weights.make draws it N(0, 1))."""
    p = weights.make(ref_mla.param_shapes(cfg), seed, dtype, device)
    for name, t in p.items():
        if name.endswith(("experts.gate_up_proj", "experts.down_proj")):
            t.mul_(math.sqrt(t.shape[1]))  # drawn at 1 / sqrt(out * in): to 1 / sqrt(in)
        elif name.endswith("e_score_correction_bias"):
            t.mul_(cfg["correction_bias_std"])
    return p


def history_prompts(cfg: dict, p: dict, seed: int, batches: int) -> List[tuple]:
    """`batches` left-padded dialog prompt batches ([B, S] text, [B, S, C]
    audio): each row a history of audio frames, then a text prompt grid."""
    rng = np.random.default_rng(seed)
    b, c, size = p["batch"], cfg["audio_codebook_count"], cfg["audio_codebook_size"]
    texts = np.round(np.linspace(p["prompt_min"], p["prompt_max"], b)).astype(int)
    grid = len(lm_generate.prompt_grid(cfg, np.zeros(p["prompt_max"], np.int64))[0])
    room = p["inference"]["max_seq_len"] - p["inference"]["max_new_tokens"] - grid
    history = np.minimum(np.round(np.linspace(p["history_min"], p["history_max"], b)).astype(int), room)
    shift = np.arange(c) * size
    out = []
    for _ in range(batches):
        rows = []
        for r in rng.permutation(b):
            t, a = lm_generate.prompt_grid(cfg, rng.integers(0, cfg["bos_token_id"], texts[r]))
            h = int(history[r])
            rows.append((np.concatenate([np.full(h, cfg["text_pad_id"], np.int64), t]),
                         np.concatenate([rng.integers(0, size, (h, c)) + shift, a])))
        s = max(len(t) for t, _ in rows)
        text = np.full((b, s), cfg["text_pad_id"], np.int64)
        audio = np.full((b, s, c), cfg["slow_audio_pad_id"], np.int64)
        for r, (t, a) in enumerate(rows):
            text[r, s - len(t):], audio[r, s - len(t):] = t, a
        out.append((text, audio))
    return out


def fp8(t: torch.Tensor) -> torch.Tensor:
    """A tensor as the control holds it: matrices rounded to fp8 e4m3 with
    one scale a tensor (lm_generate.quantized), the rest float32."""
    return lm_generate.quantized({"t": t.float()})["t"]


def routing_numbers(routes: List[tuple], forced: torch.Tensor) -> tuple:
    """(largest gap, choices unlike the reference's own, all choices) of
    the reference's `routes` ((own [N, k], gap [N]) a MoE layer) against the
    experts it was made to compute with, `forced` [MoE layers, N, k]."""
    gap, differ, total = 0.0, 0, 0
    for (own, g), chosen in zip(routes, forced):
        chosen = chosen.to(own.device)
        gap = max(gap, float(g.max()))
        differ += chosen.numel() - int((chosen[:, :, None] == own[:, None, :]).any(-1).sum())
        total += chosen.numel()
    return gap, differ, total


def Driver(cell, seed: int, device: torch.device):
    return (Dialog if is_moe(cell.config) else Qwen2)(cell, seed, device)


class Qwen2(lm_generate.Driver):
    """What a configuration other than DeepSeek-V3 runs (the harness tests'
    generic tiny cut gives every LM cell a Qwen2 one): `lm_generate`'s
    driver, and the routing checks at 0 (no routing)."""

    def check(self, records: List[dict], control: Optional[str] = None) -> List[dict]:
        return super().check(records, control) + [
            {"name": n, "value": 0.0, "limit": float(self.p["limits"][n])} for n in ROUTING_CHECKS]


class Dialog(lm_generate.Driver):
    def __init__(self, cell, seed: int, device: torch.device):
        super().__init__(cell, seed, device)
        self.served_routes: Dict[int, torch.Tensor] = {}  # greedy batch -> its routing log, on the device

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
        self.prompts = history_prompts(self.cfg, self.p, self.seed, 8)
        self.draws = torch.Generator(device=self.device).manual_seed(self.seed % (2**63))
        for greedy in (True, False):  # each generator captures its graph; the render's shapes
            self._batch(None, self.prompts[-1], greedy)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        flops = moe_counts.generation_flops
        rec = {"k": k, "start": start, "end": end, "greedy": greedy, "gen_s": out["gen_s"],
               "replay_s": stats["replay_s"], "gen_steps": steps, "frames": frames, "encoded": False,
               "audio_s": sum(frames) * rc["hop_length"] / rc["sample_rate"], "lm_flops": flops(self.cfg, b, s, steps),
               "pairs_prefill": stats["pairs_prefill"], "pairs_decode": stats["pairs_decode"]}
        if out["traced_frames"]:  # the part of the generation inside the trace
            rec["lm_flops_traced"] = flops(self.cfg, b, s, min(steps, out["traced_frames"]))
        if greedy:  # what the served tokens were computed with, for the check
            self.served_routes[k] = self.routes[:, :, :s + steps].clone()
        return rec

    def check(self, records: List[dict], control: Optional[str] = None) -> List[dict]:
        """token_gap, `lm_generate`'s, with this reference's slow decoder
        made to compute with the experts each served position was routed to
        (the program's log): random routers choose among experts whose
        scores lie closer than bf16 resolves, and each different choice
        would carry the two computations apart. The routing itself:
        routing_gap, the widest gap by which a served choice's score +
        correction bias lies below the reference's k-th best on the same
        path, and routing_differ, the share of the served choices that are
        not among the reference's own k (bf16's error flips a few near the
        margin; a router that selects otherwise, say without the bias,
        flips more). Under the fp8 control its own tokens and routing stand
        in for the program's. Each layer's weights are made float32 (or
        fp8) as it is reached. Then the render's mel_out and wave."""
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
        """(token gap, routing gap, choices unlike the reference's own, all
        choices) over one greedy row: the prompt, then its frames."""
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
            q = ref_mla.outer(p, cast)
            hid = ref_mla.decoder(p, cfg, ref_lm.embed(q, cfg, seq_t, seq_a), cast, routes, forced)[0, s - 1:]
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
            low_t, low_a = logits(fp8, None, own)
            pick_t, pick_a = low_t.argmax(-1), low_a.argmax(-1)
            forced = torch.stack([o for o, _ in own])
        routes: List[tuple] = []
        ref_t, ref_a = logits(ref_mla._float, forced, routes)
        gap_t = ref_t.max(-1).values - ref_t.gather(-1, pick_t[:, None])[:, 0]
        gap_a = ref_a.max(-1).values - ref_a.gather(-1, pick_a[..., None])[..., 0]
        return (float(torch.cat([gap_t, gap_a.flatten()]).max()),) + routing_numbers(routes, forced)
