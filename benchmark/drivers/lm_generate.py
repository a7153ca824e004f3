"""Closed loop of batched LM generation rendered to audio: each unit is one
batch of text prompts through `SlowFastGenerator.generate_batched` (its
frames after the prefill replays of a captured CUDA graph), then every
row's de-shifted tokens through `DMelCodecAdapter.decode` to waveforms on
the host, as one batch: batched TTS and music generation.

Traffic parameters (the workload file's "params"):
  batch            prompts a batch
  prompt_min, prompt_max
                   text tokens a prompt: every batch holds the same
                   lengths, evenly spread over [min, max], in another order
                   (so every batch has one padded shape), with ids drawn
                   from the seed; shorter prompts are padded on the left
  inference        the InferenceConfig (configs/lm_infer.yaml, bf16 cache)
  greedy_every     every n-th batch, the first included, decodes greedily
                   (temperature 1e-5): the batches the check can judge
  dtype            the LM's, the codec's and the vocoder's dtype
  render           the configuration file of the codec and vocoder
  check_rows       rows of the window's greedy batches the reference
                   recomputes (drawn from the seed)
  trace_replays    graph replays a traced batch keeps in the trace (then
                   the trace stops until the render)
  limits           each compared number's limit

Spans: "lm.replay" (each traced graph replay), "render", and inside it the
codec adapter's "codec.decode", "vocoder.*"; the prefill is under none.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.drivers import codec_requests as codec
from benchmark.drivers.lm_train import lm_config
from benchmark.harness import spec, weights
from benchmark.counts.lm import generation_flops
from benchmark.harness.trace import span
from benchmark.reference import lm as ref_lm
from benchmark.reference import precision

GREEDY_TEMPERATURE = 1e-5  # the sampler's floor: softmax(logits / 1e-5) puts all mass on the top logit


def prompt_grid(cfg: dict, text_ids: np.ndarray) -> tuple:
    """A text-only inference grid: <SOH><BOS> text <EOS><EOH><SOR><SOM>
    <pad> over modality pads and one silence frame (TokenGridBuilder's)."""
    c = cfg["audio_codebook_count"]
    text = np.concatenate([[cfg["start_of_human_id"], cfg["bos_token_id"]], text_ids,
                           [cfg["eos_token_id"], cfg["end_of_human_id"], cfg["start_of_robot_id"],
                            cfg["start_of_music_id"], cfg["text_pad_id"]]]).astype(np.int64)
    silence = np.asarray(cfg["audio_silence_id"], np.int64) + np.arange(c) * cfg["audio_codebook_size"]
    audio = np.concatenate([np.full((len(text) - 1, c), cfg["slow_audio_pad_id"], np.int64), silence[None]])
    return text, audio


def make_prompts(cfg: dict, p: dict, seed: int, batches: int) -> List[tuple]:
    """`batches` left-padded prompt batches ([B, S] text, [B, S, C] audio)."""
    rng = np.random.default_rng(seed)
    lengths = np.round(np.linspace(p["prompt_min"], p["prompt_max"], p["batch"])).astype(int)
    out = []
    for _ in range(batches):
        grids = [prompt_grid(cfg, rng.integers(0, cfg["bos_token_id"], n)) for n in rng.permutation(lengths)]
        s = max(len(t) for t, _ in grids)
        c = cfg["audio_codebook_count"]
        text = np.full((len(grids), s), cfg["text_pad_id"], np.int64)
        audio = np.full((len(grids), s, c), cfg["slow_audio_pad_id"], np.int64)
        for r, (t, a) in enumerate(grids):
            text[r, s - len(t):], audio[r, s - len(t):] = t, a
        out.append((text, audio))
    return out


class Driver:
    spans = ("lm.", "render", "codec.", "vocoder.")

    def __init__(self, cell, seed: int, device: torch.device):
        self.cfg = cell.config
        self.p = cell.workload["params"]
        render = self.p["render"]  # a configuration's name (or, in tests, the configuration itself)
        self.render_cfg = render if isinstance(render, dict) else spec.load_json(cell.bench / "configs" / f"{render}.json")
        self.seed = int(seed)
        self.noise_seed = (self.seed * 2654435761 + 3) % (2**63)
        self.device = device
        self.dtype = getattr(torch, self.p["dtype"])
        self.k = 0
        self.calls: List[tuple] = []  # (batch or None, rows, frames) per decode, in order
        self.outputs: Dict[int, dict] = {}
        self.tracer = None  # the runner's, while a window runs

    def _greedy(self, k: int) -> bool:
        return k % self.p["greedy_every"] == 0

    def setup(self) -> None:
        from dmel_codec_tpu_torch.lm.generate import InferenceConfig, SlowFastGenerator
        from dmel_codec_tpu_torch.models.lm import ChatMusicLM
        from dmel_codec_tpu_torch.utils.precision import strict_float32

        strict_float32()  # as every entry point of the program does before it builds a model
        with torch.device("meta"):
            model = ChatMusicLM(lm_config(self.cfg, flash=False)).to(self.dtype)
        model.load_state_dict(weights.make(ref_lm.param_shapes(self.cfg), self.seed, self.dtype, self.device),
                              strict=True, assign=True)
        model.eval()
        icfg = InferenceConfig(**self.p["inference"])
        self.gens = {False: SlowFastGenerator(model, icfg),
                     True: SlowFastGenerator(model, dataclasses.replace(icfg, temperature=GREEDY_TEMPERATURE))}
        self.adapter = codec.build_adapter(self.render_cfg, self.seed + 1, self.dtype, self.device, self.noise_seed)
        self.prompts = make_prompts(self.cfg, self.p, self.seed, 8)
        self.draws = torch.Generator(device=self.device).manual_seed(self.seed % (2**63))
        for greedy in (True, False):  # each generator captures its graph; the render's shapes
            self._batch(None, self.prompts[-1], greedy)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _generate(self, gen, text, audio):
        """generate_batched; in a traced unit the trace stops after
        `trace_replays` graph replays, each under a span "lm.replay" (the
        prefill and the first frames: a whole generation is some millions
        of kernels, and the profiler then costs ten times its time), and
        starts again for the render. No span is open across the stop."""
        tracer = self.tracer
        if tracer is None or not tracer.active:
            return gen.generate_batched(text, audio, self.draws), None
        replay, seen = torch.cuda.CUDAGraph.replay, [0]

        def counted(graph):
            if not tracer.active:
                return replay(graph)
            with span("lm.replay"):
                replay(graph)
            seen[0] += 1
            if seen[0] == self.p["trace_replays"]:
                tracer.stop()

        torch.cuda.CUDAGraph.replay = counted
        try:
            out = gen.generate_batched(text, audio, self.draws)
        finally:
            torch.cuda.CUDAGraph.replay = replay
        traced_frames = 1 + seen[0] * gen.stats["frames_per_replay"] if seen[0] else None
        tracer.start()  # the render, traced again
        return out, traced_frames

    def _batch(self, key, prompt, greedy: bool) -> dict:
        text, audio = prompt
        t0 = time.perf_counter()
        (audio_ids, text_ids), traced_frames = self._generate(self.gens[greedy], text, audio)
        t1 = time.perf_counter()
        size, c = self.cfg["audio_codebook_size"], self.cfg["audio_codebook_count"]
        rows = [np.clip(a[:-1] - np.arange(c) * size, 0, size - 1) for a in audio_ids]  # infer_lm: drop <EOM>, de-shift
        n = max(1, max(len(r) for r in rows))
        indices = np.zeros((len(rows), c, n), np.int64)
        for i, r in enumerate(rows):
            indices[i, :, :len(r)] = r.T
        lengths = np.asarray([len(r) for r in rows])
        with span("render"):
            self.calls.append((key, len(rows), n))
            wav, mel = self.adapter.decode(indices, lengths)
        return {"gen_s": t1 - t0, "audio_ids": audio_ids, "text_ids": text_ids, "indices": indices,
                "lengths": lengths, "wav": wav, "mel_out": mel, "steps": max(len(a) for a in audio_ids),
                "traced_frames": traced_frames}

    def step(self) -> dict:
        k = self.k
        self.k += 1
        start = time.perf_counter()
        out = self._batch(k, self.prompts[k % len(self.prompts)], self._greedy(k))
        end = time.perf_counter()
        rc = self.render_cfg["codec"]
        down = int(np.prod(rc["downsample_factor"]))
        frames = [int(n) * down for n in out["lengths"]]
        self.outputs[k] = out
        steps = out["steps"]
        b = len(frames)
        s = self.prompts[k % len(self.prompts)][0].shape[1]
        rec = {"k": k, "start": start, "end": end, "greedy": self._greedy(k), "gen_s": out["gen_s"],
               "gen_steps": steps, "frames": frames, "encoded": False,
               "audio_s": sum(frames) * rc["hop_length"] / rc["sample_rate"],
               "lm_flops": generation_flops(self.cfg, b, s, steps)}
        if out["traced_frames"]:  # the part of the generation inside the trace
            rec["lm_flops_traced"] = generation_flops(self.cfg, b, s, min(steps, out["traced_frames"]))
        return rec

    def release(self) -> None:
        del self.gens, self.adapter

    # ---- the check --------------------------------------------------------
    controls = ("fp8",)

    def sample(self, records: List[dict]) -> List[tuple]:
        """(batch, row) pairs of the window's greedy batches, drawn from the
        seed, the longest row among them."""
        pairs = [(r["k"], i) for r in records if r["greedy"] for i in range(len(r["frames"]))]
        if not pairs:
            raise RuntimeError("the window finished no greedy batch")
        longest = max(pairs, key=lambda kr: (len(self.outputs[kr[0]]["audio_ids"][kr[1]]), -kr[0], -kr[1]))
        rest = [pr for pr in pairs if pr != longest]
        rng = np.random.default_rng(self.seed + 1)
        pick = rng.choice(len(rest), size=min(len(rest), self.p["check_rows"] - 1), replace=False)
        return [longest] + [rest[i] for i in sorted(pick)]

    def check(self, records: List[dict], control: Optional[str] = None) -> List[dict]:
        """token_gap: the widest gap by which a served greedy token's logit
        (the reference's, after the same repetition penalty) lies below the
        reference's best at its position; with control "fp8" the token the
        reference with fp8 (e4m3) weights puts first stands in for the
        served one. mel_out (largest error over largest value) and wave
        (L2 error over L2 norm): the render of the sampled rows against the
        reference's float32 decode of the same tokens and its vocoder run
        on the render's own mel (the stage followed); under the control the
        reference with fp8 weights renders in the program's place."""
        pairs = self.sample(records)
        p = {k: v.float() for k, v in weights.make(ref_lm.param_shapes(self.cfg), self.seed, self.dtype,
                                                   self.device).items()}
        low = quantized(p) if control == "fp8" else None
        gap = 0.0
        with precision(tf32=False):
            for k, i in pairs:
                out = self.outputs[k]
                text, audio = (x[i] for x in self.prompts[k % len(self.prompts)])
                gap = max(gap, token_gap(p, self.cfg, self.p["inference"], text, audio, out["text_ids"][i],
                                         out["audio_ids"][i], low, self.device))
        worst = {"token_gap": gap}
        worst.update(self.check_render(records, pairs, control))
        return [{"name": n, "value": v, "limit": float(self.p["limits"][n])} for n, v in worst.items()]

    def check_render(self, records, pairs, control) -> Dict[str, float]:
        rc = self.render_cfg
        params = codec.make_params(rc, self.seed + 1, self.dtype, self.device)
        params = {part: {k: v.float() for k, v in ps.items()} for part, ps in params.items()}
        concat = rc["codec"]["dmel_groups"] * rc["codec"]["encoder_residual_channels"]
        down = int(np.prod(rc["codec"]["downsample_factor"]))
        g = torch.Generator(device=self.device).manual_seed(self.noise_seed)
        keys = {k for k, _ in pairs}
        noise = {}
        for key, b, n in self.calls:
            z = torch.randn((b, n * down, concat), generator=g, device=self.device, dtype=self.dtype)
            if key in keys:
                noise[key] = z
        worst = {"mel_out": 0.0, "wave": 0.0}
        for k, i in pairs:
            out = self.outputs[k]
            idx = torch.as_tensor(out["indices"][i:i + 1], device=self.device)
            length = torch.as_tensor(out["lengths"][i:i + 1], device=self.device)
            z = noise[k][i:i + 1].float()
            got_mel, got_wav = out["mel_out"][i], out["wav"][i]
            with precision(tf32=False):
                if control == "fp8":
                    lowp = {part: quantized(ps) for part, ps in params.items()}
                    low_mel = codec.ref_codec.decode(lowp["codec"], rc["codec"], idx, length, z)
                    got_wav = codec.ref_bigvgan.vocode(lowp["vocoder"], rc["vocoder"], low_mel)[0].cpu().numpy()
                    got_mel = low_mel[0].cpu().numpy()
                ref_mel = codec.ref_codec.decode(params["codec"], rc["codec"], idx, length, z)[0].cpu().numpy()
                # the vocoder's stage, followed from the mel it was given
                ref_wav = codec.ref_bigvgan.vocode(params["vocoder"], rc["vocoder"],
                                                   torch.as_tensor(got_mel, device=self.device).float()[None])
            f = int(out["lengths"][i]) * down
            hop = rc["codec"]["hop_length"]
            rw = ref_wav[0].cpu().numpy().astype(np.float64)[:f * hop]
            worst["mel_out"] = max(worst["mel_out"], float(np.abs(got_mel[:f] - ref_mel[:f]).max() / np.abs(ref_mel[:f]).max()))
            err = np.sqrt(np.square(got_wav[:f * hop] - rw).sum() / np.square(rw).sum())
            worst["wave"] = max(worst["wave"], float(err))
        return worst


def quantized(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every matrix (and conv kernel) rounded to fp8 e4m3 with one scale a
    tensor (its largest magnitude to 448), the rest as it is: the
    reference one precision below bf16."""
    out = {}
    for k, v in params.items():
        if v.dim() >= 2:
            scale = v.abs().max().clamp(min=1e-30) / 448.0
            v = (v / scale).to(torch.float8_e4m3fn).float() * scale
        out[k] = v
    return out


def token_gap(p, cfg: dict, icfg: dict, text: np.ndarray, audio: np.ndarray, text_ids: np.ndarray,
              audio_ids: np.ndarray, low, device) -> float:
    """The widest gap (reference logits, after the repetition penalty the
    generator applies) between the best token and the served one, over one
    greedy row's frames: the text token and each codebook's token; with
    `low` (fp8 weights) the token those logits put first is judged."""
    s, n, c = len(text), len(text_ids), cfg["audio_codebook_count"]
    seq_t = torch.as_tensor(np.concatenate([text, text_ids[:-1]]), device=device)[None]
    seq_a = torch.as_tensor(np.concatenate([audio, audio_ids[:-1]]), device=device)[None]
    served_a = torch.as_tensor(audio_ids, device=device)
    served_t = torch.as_tensor(text_ids, device=device)
    if s < icfg["windows_length"]:
        raise ValueError("the penalty window reaches before the prompt")
    window = torch.as_tensor(np.concatenate([audio, audio_ids])[-(n + icfg["windows_length"]):], device=device)

    def logits(q):
        with torch.no_grad():
            hid = ref_lm.decoder(q, "slow_decoder", cfg["slow"], ref_lm.embed(q, cfg, seq_t, seq_a))[0, s - 1:]
            text_logits = torch.nn.functional.linear(hid, q["text_head.weight"])
            pos0 = torch.nn.functional.linear(ref_lm.rms_norm(hid, q["fast_pre_norm.weight"], 1e-6),
                                              q["fast_projector.weight"], q["fast_projector.bias"])
            fast_in = torch.cat([pos0[:, None], torch.nn.functional.embedding(served_a, q["fast_audio_embed.weight"])], 1)
            audio_logits = torch.nn.functional.linear(ref_lm.decoder(q, "fast_decoder", cfg["fast"], fast_in)[:, :c],
                                                      q["audio_head.weight"])  # [n, C, V]
        return text_logits, penalized(audio_logits, window, icfg)

    ref_t, ref_a = logits(p)
    pick_t, pick_a = served_t, served_a
    if low is not None:
        low_t, low_a = logits(low)
        pick_t, pick_a = low_t.argmax(-1), low_a.argmax(-1)
    gap_t = ref_t.max(-1).values - ref_t.gather(-1, pick_t[:, None])[:, 0]
    gap_a = ref_a.max(-1).values - ref_a.gather(-1, pick_a[..., None])[..., 0]
    return float(torch.cat([gap_t, gap_a.flatten()]).max())


def penalized(logits: torch.Tensor, window: torch.Tensor, icfg: dict) -> torch.Tensor:
    """The repetition penalty of the frames after the first: frame j's
    codebook i takes the penalty over codebook i's tokens of the rows
    window[j : j + windows_length] (the rows before it: the prompt's last
    audio rows, then the frames); frame 0, sampled at the prefill, takes
    none. logits [n, C, V]."""
    n, c, v = logits.shape
    w = icfg["windows_length"]
    rows = torch.stack([window[j:j + w] for j in range(n)]).transpose(1, 2)  # [n, C, w]
    hit = torch.zeros((n, c, v), dtype=torch.bool, device=logits.device).scatter_(2, rows, True)
    hit[0] = False
    pen = icfg["windows_penalty"]
    return torch.where(hit, torch.where(logits < 0, logits * pen, logits / pen), logits)
