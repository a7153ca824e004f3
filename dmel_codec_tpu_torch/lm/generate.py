"""Autoregressive slow-fast generation: prompt grid -> codec tokens (port
of `dmel_codec_tpu/lm/generate.py`).

Prefill the slow decoder over the prompt grid, then per frame sample one
text token (no repetition penalty) and 10 codebook tokens sequentially
through the fast depth decoder (penalty over a 16-frame window per
codebook), stopping on <EOM> or max_new_tokens; de-shift ids for the codec.

Where the JAX package compiles the whole loop into one `lax.while_loop`,
this runs one frame step (`_step`) over fixed-shape device buffers: the
slow KV cache of max_seq_len positions with its index on the device, the
last frame's tokens, the penalty window, the outputs, the lengths, the stop
flags and the frame counter. The step reads nothing on the host, so:
  * on CUDA, `generate` and `generate_batched` capture FRAMES_PER_GRAPH
    steps in a CUDA graph at their first call for a batch size (warmed up
    on a side stream first; the graph and its buffers are kept for later
    requests) and replay it until every row has stopped or max_new_tokens
    frames are made. The host learns the stop flag once per replay, from a
    copy into pinned memory read while the next replay is queued, and
    fetches the result in one copy. A failed capture raises: there is no
    eager loop on CUDA for these two;
  * on the CPU the same step runs eagerly, frame by frame, with the same
    buffers (the plain version the tests hold against the JAX package).
The prefill runs eagerly (its S is the prompt's length). The three public
forms differ as in the JAX package:"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dmel_codec_tpu_torch.lm.sampling import sample_token
from dmel_codec_tpu_torch.models.deepseek_v3 import LatentAttention
from dmel_codec_tpu_torch.models.kimi_linear import KimiDeltaAttention
from dmel_codec_tpu_torch.models.nemotron_h import Mamba2Mixer, NoPEAttention
from dmel_codec_tpu_torch.models.lm import ChatMusicLM, SlowFastLMConfig
from dmel_codec_tpu_torch.utils.trace import span

# Frames a captured graph runs per replay, and eager frames before capture.
FRAMES_PER_GRAPH = 4
WARMUP_FRAMES = 2


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Sampling defaults of the reference's lm_inference.yaml."""

    temperature: float = 0.7
    top_k: int = 50
    top_p: float = 0.8
    windows_penalty: float = 1.2
    windows_length: int = 16
    max_new_tokens: int = 450
    max_seq_len: int = 4096
    # KV-cache dtype: "bfloat16" halves the cache's memory traffic for
    # serving (float32 softmax throughout)
    cache_dtype: str = "float32"
    # KV-cache the fast depth decode: each codebook step runs ONE new
    # position against the cached prefix instead of re-running the full
    # 11-token forward per codebook. Same maths (RoPE position = cache
    # index, causal prefix attention). Off by default, as in the JAX package.
    fast_kv_cache: bool = False


@dataclasses.dataclass
class _Loop:
    """The fixed-shape device buffers of one generation after its prefill."""

    cache: dict  # the slow KV cache, max_seq_len positions
    text: torch.Tensor  # [B] the last frame's text tokens
    frame: torch.Tensor  # [B, C] and its audio tokens
    window: torch.Tensor  # [B, W, C] the penalty window
    window_valid: torch.Tensor  # [B, W]
    out_text: torch.Tensor  # [B, n]
    out_audio: torch.Tensor  # [B, n, C]
    lengths: torch.Tensor  # [B]
    done: torch.Tensor  # [B] the row has sampled <EOM>
    i: torch.Tensor  # 0-d, the next frame
    stop: torch.Tensor  # 0-d, every row done


@dataclasses.dataclass
class _Graph:
    """A captured frame step and what its replays read and write."""

    loop: _Loop
    graph: "torch.cuda.CUDAGraph"
    generator: torch.Generator  # registered with the graph
    stops: torch.Tensor  # [2] pinned host copies of `loop.stop`
    events: list  # [2] CUDA events after those copies


class SlowFastGenerator:
    """Generation over one model and one InferenceConfig. On CUDA it keeps
    one captured graph, with its buffers, per batch size and fast decode;
    the graph reads the model's parameters where they lie, so a generator
    outlives no move of the model. One generation at a time per instance."""

    def __init__(self, model: ChatMusicLM, inference_config: InferenceConfig = InferenceConfig()):
        self.model = model
        self.cfg: SlowFastLMConfig = model.config
        self.icfg = inference_config
        self._graphs: Dict[tuple, _Graph] = {}
        # the last generation's: graphed, frames_per_replay, host_reads, capture_s, replay_s,
        # fast_block_fused (the share of the fast decoder's block calls in its eager and captured
        # frames that ran as kernel K4), mla_fused (the share of the slow decoder's latent-attention
        # calls over several positions that ran as kernel K5; 0 without latent attention),
        # kda_positions (rows x positions the KDA layers' chunked form processed, every layer's call
        # counted; 0 without KDA), kda_fused (the share of those chunked calls that ran as kernel K6;
        # 0 without KDA), ssd_positions (rows x positions the Mamba layers' chunked SSD processed,
        # every layer's call counted; 0 without Mamba), attn_flash (the share of the NoPE attention
        # calls over several positions that ran on FA; 0 without them), and with experts in the slow
        # decoder pairs_prefill / pairs_decode ([moe layers, router's experts] routed pairs)
        self.stats: dict = {}
        self._pairs = model.slow_decoder.track_pairs()

    @property
    def device(self) -> torch.device:
        return self.model.text_head.weight.device

    # ------------------------------------------------------------------
    def _sample(self, generator, logits, window_col=None, window_valid=None):
        """logits [B, V] (+ window column [B, W]) -> tokens [B]. Without a
        window there is no repetition penalty (text tokens)."""
        icfg = self.icfg
        return sample_token(
            generator,
            logits,
            window_col,
            window_valid,
            icfg.temperature,
            icfg.top_k,
            icfg.top_p,
            icfg.windows_penalty if window_col is not None else 1.0,
        )[0]

    # ---- the three fast depth decodes: slow_hidden [B, 1, H], window
    # [B, W, C] shifted ids, window_valid [B, W] -> frame tokens [B, C] ----
    def _fast_decode_growing(self, slow_hidden, window, window_valid, generator):
        """Step i runs the fast decoder over the i + 1 inputs decided so far."""
        tokens: List[torch.Tensor] = []
        for i in range(self.cfg.audio_codebook_count):
            fast_ids = torch.stack(tokens, dim=1) if tokens else None  # [B, i]
            logits = self.model.forward_generate_audio(slow_hidden, fast_ids)
            tokens.append(self._sample(generator, logits, window[:, :, i], window_valid))
        return torch.stack(tokens, dim=1)

    def _fast_decode_fixed(self, slow_hidden, window, window_valid, generator):
        """The depth input is always [B, C+1, h] (hidden + C token
        embeddings; positions not yet decided hold token 0, which causal
        masking hides), so all 10 steps share one shape."""
        b, c = slow_hidden.shape[0], self.cfg.audio_codebook_count
        tokens = torch.zeros((b, c), dtype=torch.long, device=slow_hidden.device)
        for i in range(c):
            logits_all = self.model.forward_generate_audio_fixed(slow_hidden, tokens)
            tokens[:, i] = self._sample(generator, logits_all[:, i, :], window[:, :, i], window_valid)
        return tokens

    def _fast_decode_cached(self, slow_hidden, window, window_valid, generator):
        """Position i is ONE [B, 1, h_fast] step against the cached prefix
        instead of the full [B, C+1] forward per codebook. Identical maths
        to `_fast_decode_fixed`."""
        b, c = slow_hidden.shape[0], self.cfg.audio_codebook_count
        x = self.model.fast_depth_pos0(slow_hidden)
        cache = self.model.init_fast_cache(b, dtype=getattr(torch, self.icfg.cache_dtype))
        tokens = []
        for i in range(c):
            logits, cache = self.model.forward_generate_audio_cached(x, cache)
            tokens.append(self._sample(generator, logits, window[:, :, i], window_valid))
            x = self.model.fast_embed_tokens(tokens[-1][:, None]).to(x.dtype)
        return torch.stack(tokens, dim=1)

    def _fast_decode(self, *args):
        fn = self._fast_decode_cached if self.icfg.fast_kv_cache else self._fast_decode_fixed
        return fn(*args)

    # ---- one frame over fixed-shape buffers ------------------------------
    def _frame(self, cache, embeds, window, window_valid, generator, fast_decode: Callable):
        """One frame: slow step -> text tokens [B]; the fast decode -> audio
        tokens [B, C]. The cache's index advances in place. The text head
        runs on the last position only (a prefill's [B, S, V] logits of a
        long prompt would take gigabytes)."""
        slow_hidden, stepped = self.model.slow_decoder(embeds, cache=cache)
        cache["index"].copy_(stepped["index"])
        text_tokens = self._sample(generator, self.model.text_head(slow_hidden[:, -1, :]))
        frame = fast_decode(slow_hidden[:, -1:, :], window, window_valid, generator)
        return text_tokens, frame

    def _new_loop(self, b: int) -> _Loop:
        cfg, icfg, dev = self.cfg, self.icfg, self.device
        n, c = icfg.max_new_tokens, cfg.audio_codebook_count
        ids = dict(dtype=torch.long, device=dev)
        flags = dict(dtype=torch.bool, device=dev)
        return _Loop(
            cache=self.model.init_slow_cache(b, icfg.max_seq_len, dtype=getattr(torch, icfg.cache_dtype)),
            text=torch.zeros(b, **ids),
            frame=torch.zeros((b, c), **ids),
            window=torch.zeros((b, icfg.windows_length, c), **ids),
            window_valid=torch.zeros((b, icfg.windows_length), **flags),
            out_text=torch.zeros((b, n), **ids),
            out_audio=torch.zeros((b, n, c), **ids),
            lengths=torch.zeros(b, **ids),
            done=torch.zeros(b, **flags),
            i=torch.zeros((), **ids),
            stop=torch.zeros((), **flags),
        )

    def _roll_in(self, loop: _Loop, frame: torch.Tensor) -> None:
        """The penalty window takes the newest frame as its last row."""
        loop.window.copy_(torch.roll(loop.window, -1, dims=1))
        loop.window[:, -1] = frame
        loop.window_valid.copy_(torch.roll(loop.window_valid, -1, dims=1))
        loop.window_valid[:, -1] = True

    def _prefill(self, loop: _Loop, prompt_t, prompt_a, generator, fast_decode: Callable) -> None:
        """Reset `loop` (and the routed-pair counter) and run the prompt
        [B, S] / [B, S, C] as frame 0."""
        icfg, n = self.icfg, self.icfg.max_new_tokens
        for t in (*loop.cache.values(), loop.window, loop.window_valid, loop.out_text, loop.out_audio):
            t.zero_()
        if self._pairs is not None:
            self._pairs.zero_()
        # rolling penalty window primed with the prompt's last audio rows
        n_hist = min(prompt_t.shape[1], icfg.windows_length)
        if n_hist:
            loop.window[:, :n_hist] = prompt_a[:, -n_hist:]
            loop.window_valid[:, :n_hist] = True
        # prefill samples WITHOUT repetition penalty (the reference passes no
        # previous tokens at prefill): an all-False validity mask makes the
        # penalty a no-op
        embeds = self.model.embed_inputs(prompt_t, prompt_a)
        text, frame = self._frame(
            loop.cache, embeds, loop.window, torch.zeros_like(loop.window_valid), generator, fast_decode
        )
        loop.text.copy_(text)
        loop.frame.copy_(frame)
        loop.out_text[:, 0] = text
        loop.out_audio[:, 0] = frame
        self._roll_in(loop, frame)
        loop.done.copy_(text == self.cfg.end_of_music_id)
        loop.lengths.copy_(torch.where(loop.done, 1, n))
        loop.i.fill_(1)
        loop.stop.copy_(loop.done.all())

    def _step(self, loop: _Loop, generator, fast_decode: Callable) -> None:
        """Frame `loop.i` in place, with no host read. A row writes its
        tokens and its length only until it has stopped, and nothing is
        written from frame max_new_tokens on: a graph's last replay may run
        past it, and frames after every row has stopped change nothing. The
        slow cache takes those frames' keys past the last position a kept
        frame reads (clamped to the cache's end)."""
        n = self.icfg.max_new_tokens
        embeds = self.model.embed_inputs(loop.text[:, None], loop.frame[:, None, :])
        text, frame = self._frame(loop.cache, embeds, loop.window, loop.window_valid, generator, fast_decode)
        loop.text.copy_(text)
        loop.frame.copy_(frame)
        self._roll_in(loop, frame)
        write = ~loop.done & (loop.i < n)
        col = loop.i.clamp(max=n - 1).view(1)
        loop.out_text.index_copy_(
            1, col, torch.where(write[:, None], text[:, None], loop.out_text.index_select(1, col))
        )
        loop.out_audio.index_copy_(
            1, col, torch.where(write[:, None, None], frame[:, None], loop.out_audio.index_select(1, col))
        )
        newly_done = write & (text == self.cfg.end_of_music_id)
        loop.lengths.copy_(torch.where(newly_done, loop.i + 1, loop.lengths))
        loop.done.logical_or_(newly_done)
        loop.stop.copy_(loop.done.all())
        loop.i.add_(1)

    def _fetch(self, loop: _Loop) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (out_text [B, n], out_audio [B, n, C], lengths [B]) in ONE
        device-to-host copy."""
        b, n = loop.out_text.shape
        lengths = torch.where(loop.done, loop.lengths, torch.minimum(loop.lengths, loop.i))
        packed = torch.cat([loop.out_text, loop.out_audio.flatten(1), lengths[:, None]], dim=1).cpu().numpy()
        return packed[:, :n], packed[:, n:-1].reshape(b, n, -1), packed[:, -1]

    # ---- the loop: eager frame by frame, or replays of a captured graph ----
    def _run_eager(self, loop: _Loop, generator, fast_decode: Callable) -> int:
        """Frame by frame until every row has stopped; returns the host reads."""
        reads = 0
        for _ in range(self.icfg.max_new_tokens - 1):
            reads += 1
            if bool(loop.stop):  # the one host read per frame
                break
            self._step(loop, generator, fast_decode)
        return reads

    def _graph(self, b: int, fast_decode: Callable) -> _Graph:
        """The frame step captured for batch `b` (FRAMES_PER_GRAPH frames a
        replay) over buffers of its own, made at the first request and kept
        for later ones: after the prefill no shape depends on the prompt."""
        key = (b, self.icfg, fast_decode.__name__)
        if key in self._graphs:
            return self._graphs[key]
        dev = self.device
        loop, generator = self._new_loop(b), torch.Generator(device=dev)
        with torch.cuda.device(dev):
            # warm up on a side stream (cuBLAS handles, the allocator), then capture
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP_FRAMES):
                    self._step(loop, generator, fast_decode)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(generator)
            with torch.cuda.graph(graph):
                for _ in range(FRAMES_PER_GRAPH):
                    self._step(loop, generator, fast_decode)
            torch.cuda.synchronize()
        entry = _Graph(
            loop, graph, generator,
            stops=torch.zeros(2, dtype=torch.bool, pin_memory=True),
            events=[torch.cuda.Event(), torch.cuda.Event()],
        )
        self._graphs[key] = entry
        return entry

    def _replay(self, entry: _Graph, generator: Optional[torch.Generator]) -> int:
        """Replay until every row has stopped or max_new_tokens frames are
        made. The graph draws from its own generator, set to the caller's
        state first (the caller's then takes the state it ends in), so a
        seeded run draws what the eager step draws. The host learns whether
        every row has stopped once per replay, from a copy into pinned memory
        read while the next replay is already queued; returns those reads."""
        gen = generator if generator is not None else torch.cuda.default_generators[self.device.index]
        entry.generator.set_state(gen.get_state())
        reads = 0
        with torch.cuda.device(self.device):
            for r in range(-(-(self.icfg.max_new_tokens - 1) // FRAMES_PER_GRAPH)):
                entry.graph.replay()
                entry.stops[r % 2].copy_(entry.loop.stop, non_blocking=True)
                entry.events[r % 2].record()
                if r:
                    entry.events[(r - 1) % 2].synchronize()
                    reads += 1
                    if entry.stops[(r - 1) % 2]:
                        break
        gen.set_state(entry.generator.get_state())
        return reads

    @torch.no_grad()
    def _generate(
        self,
        text_tokens: np.ndarray,  # [B, S]
        audio_tokens: np.ndarray,  # [B, S, C]
        generator: Optional[torch.Generator],
        prefill_decode: Callable,
        step_decode: Callable,
        graphed: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (out_text [B, n], out_audio [B, n, C], lengths [B]); row b is
        valid up to lengths[b], its <EOM> frame included. On a CUDA model
        with `graphed` the frames after the prefill are graph replays."""
        icfg = self.icfg
        b, s = text_tokens.shape
        n = icfg.max_new_tokens
        if s + n > icfg.max_seq_len:
            raise ValueError(f"prompt {s} + max_new_tokens {n} exceeds max_seq_len {icfg.max_seq_len}")
        dev = self.device
        graphed = graphed and dev.type == "cuda" and n > 1
        calls = self.model.fast_block_calls
        calls.update(fused=0, module=0)  # counted as the frames' host code runs: eager, warm-up and captured
        mla = LatentAttention.calls
        mla.update(fused=0, plain=0)
        KimiDeltaAttention.scanned["positions"] = 0
        kda = KimiDeltaAttention.calls
        kda.update(fused=0, plain=0)
        Mamba2Mixer.scanned["positions"] = 0
        attn = NoPEAttention.calls
        attn.update(flash=0, plain=0)
        t0 = time.perf_counter()
        entry = self._graph(b, step_decode) if graphed else None
        capture_s = time.perf_counter() - t0  # a first call's capture; a lookup after
        loop = entry.loop if graphed else self._new_loop(b)
        # closed before the replays: a replay runs none of the host code it captured, and a
        # profiler may stop between two of them
        with span("lm.prefill"):
            prompt_t = torch.as_tensor(np.asarray(text_tokens), dtype=torch.long, device=dev)
            prompt_a = torch.as_tensor(np.asarray(audio_tokens), dtype=torch.long, device=dev)
            self._prefill(loop, prompt_t, prompt_a, generator, prefill_decode)
        t1 = time.perf_counter()
        if graphed:
            reads = self._replay(entry, generator)
        else:
            reads = self._run_eager(loop, generator, step_decode)
        replay_s = time.perf_counter() - t1  # from the prefill's last launch to the loop's end
        out = self._fetch(loop)
        self.stats = {
            "graphed": graphed,
            "frames_per_replay": FRAMES_PER_GRAPH if graphed else 1,
            "host_reads": reads + 1,  # and the one fetch
            "capture_s": capture_s,
            "replay_s": replay_s,
            "fast_block_fused": calls["fused"] / max(1, calls["fused"] + calls["module"]),
            "mla_fused": mla["fused"] / max(1, mla["fused"] + mla["plain"]),
            "kda_positions": KimiDeltaAttention.scanned["positions"],
            "kda_fused": kda["fused"] / max(1, kda["fused"] + kda["plain"]),
            "ssd_positions": Mamba2Mixer.scanned["positions"],
            "attn_flash": attn["flash"] / max(1, attn["flash"] + attn["plain"]),
        }
        if self._pairs is not None:  # after the fetch: the device has finished
            pairs = self._pairs.to("cpu", copy=True).numpy()
            self.stats.update(pairs_prefill=pairs[:, 0], pairs_decode=pairs[:, 1])
        return out

    def _generate_one(self, text_tokens, audio_tokens, generator, prefill_decode, step_decode, graphed=True):
        text, audio, lengths = self._generate(
            np.asarray(text_tokens)[None], np.asarray(audio_tokens)[None],
            generator, prefill_decode, step_decode, graphed,
        )
        return audio[0, : lengths[0]].astype(np.int64), text[0, : lengths[0]].astype(np.int64)

    def generate(
        self,
        text_tokens: np.ndarray,
        audio_tokens: np.ndarray,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Prompt grid (lm/inputs.py build_infer_grid) -> generated
        (audio_ids [T_new, C] SHIFTED, text_ids [T_new]). The caller
        slices/de-shifts for the codec (the reference drops the prompt
        region and the final <EOM> frame)."""
        return self._generate_one(
            text_tokens, audio_tokens, generator, self._fast_decode_growing, self._fast_decode
        )

    def generate_stepwise(
        self,
        text_tokens: np.ndarray,
        audio_tokens: np.ndarray,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """As `generate`, every frame through the growing-shape fast decode,
        one eager frame at a time on every device (one host read a frame)."""
        return self._generate_one(
            text_tokens, audio_tokens, generator, self._fast_decode_growing, self._fast_decode_growing,
            graphed=False,
        )

    def generate_batched(
        self,
        text_tokens: np.ndarray,
        audio_tokens: np.ndarray,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[list, list]:
        """Batched serving: prompt grids [B, S] / [B, S, C] (same S: pad
        shorter prompts on the left with modality-pad rows) -> per-sample
        lists of (audio_ids [T_b, C], text_ids [T_b]), each truncated at
        that sample's <EOM>. Rows that have stopped keep running until all
        have, or max_new_tokens; their later frames are dropped."""
        text, audio, lengths = self._generate(
            np.asarray(text_tokens), np.asarray(audio_tokens),
            generator, self._fast_decode_fixed, self._fast_decode_fixed,
        )
        return (
            [audio[i, : lengths[i]].astype(np.int64) for i in range(len(lengths))],
            [text[i, : lengths[i]].astype(np.int64) for i in range(len(lengths))],
        )

    def deshift(self, audio_ids: np.ndarray) -> np.ndarray:
        """Shifted slow-vocab ids [T, C] -> raw codec ids."""
        return audio_ids - self.cfg.codebook_shift
