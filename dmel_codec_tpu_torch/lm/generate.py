"""Autoregressive slow-fast generation: prompt grid -> codec tokens (port
of `dmel_codec_tpu/lm/generate.py`).

Prefill the slow decoder over the prompt grid, then per frame sample one
text token (no repetition penalty) and 10 codebook tokens sequentially
through the fast depth decoder (penalty over a 16-frame window per
codebook), stopping on <EOM> or max_new_tokens; de-shift ids for the codec.

Where the JAX package compiles the whole loop into one `lax.while_loop`,
this is a loop on the host over a static slow KV cache that is updated in
place. Tokens, the penalty window and the stop flags stay on the device;
the host reads one value per frame (have all rows stopped?). The three
public forms differ as in the JAX package:
  * `generate`: one prompt; the first frame through the growing-shape fast
    decode, later frames through the fixed-shape decode, or the KV-cached
    one under `fast_kv_cache=True`;
  * `generate_stepwise`: one prompt, every frame through the growing-shape
    decode (the debuggable reference path);
  * `generate_batched`: B prompts of one length (shorter ones left-padded
    with modality-pad rows, which embed to exact zeros), fixed-shape decode
    throughout, each row truncated at its own <EOM>.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from dmel_codec_tpu_torch.lm.sampling import sample_token
from dmel_codec_tpu_torch.models.lm import ChatMusicLM, SlowFastLMConfig


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


class SlowFastGenerator:
    def __init__(self, model: ChatMusicLM, inference_config: InferenceConfig = InferenceConfig()):
        self.model = model
        self.cfg: SlowFastLMConfig = model.config
        self.icfg = inference_config

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

    # ------------------------------------------------------------------
    def _frame(self, cache, embeds, window, window_valid, generator, fast_decode: Callable):
        """One frame: slow step (+cache) -> text tokens [B]; the fast decode
        -> audio tokens [B, C]."""
        text_logits, slow_hidden, cache = self.model.forward_generate_text(embeds, cache)
        text_tokens = self._sample(generator, text_logits[:, -1, :])
        frame = fast_decode(slow_hidden[:, -1:, :], window, window_valid, generator)
        return cache, text_tokens, frame

    @torch.no_grad()
    def _generate(
        self,
        text_tokens: np.ndarray,  # [B, S]
        audio_tokens: np.ndarray,  # [B, S, C]
        generator: Optional[torch.Generator],
        prefill_decode: Callable,
        step_decode: Callable,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (out_text [B, n], out_audio [B, n, C], lengths [B]); row b is
        valid up to lengths[b], its <EOM> frame included."""
        cfg, icfg, dev = self.cfg, self.icfg, self.device
        b, s = text_tokens.shape
        w, n = icfg.windows_length, icfg.max_new_tokens
        if s + n > icfg.max_seq_len:
            raise ValueError(f"prompt {s} + max_new_tokens {n} exceeds max_seq_len {icfg.max_seq_len}")

        prompt_t = torch.as_tensor(np.asarray(text_tokens), dtype=torch.long, device=dev)
        prompt_a = torch.as_tensor(np.asarray(audio_tokens), dtype=torch.long, device=dev)
        embeds = self.model.embed_inputs(prompt_t, prompt_a)
        cache = self.model.init_slow_cache(b, icfg.max_seq_len, dtype=getattr(torch, icfg.cache_dtype))

        # rolling penalty window primed with the prompt's last audio rows
        n_hist = min(s, w)
        window = torch.zeros((b, w, cfg.audio_codebook_count), dtype=torch.long, device=dev)
        window_valid = torch.zeros((b, w), dtype=torch.bool, device=dev)
        if n_hist:
            window[:, :n_hist] = prompt_a[:, -n_hist:]
            window_valid[:, :n_hist] = True

        def roll_in(frame):
            nonlocal window, window_valid
            window = torch.roll(window, -1, dims=1)
            window[:, -1] = frame
            window_valid = torch.roll(window_valid, -1, dims=1)
            window_valid[:, -1] = True

        # prefill samples WITHOUT repetition penalty (the reference passes no
        # previous tokens at prefill): an all-False validity mask makes the
        # penalty a no-op
        cache, text, frame = self._frame(
            cache, embeds, window, torch.zeros_like(window_valid), generator, prefill_decode
        )
        out_text, out_audio = [text], [frame]
        done = text == cfg.end_of_music_id
        lengths = torch.where(done, 1, n)
        roll_in(frame)

        i = 1
        while i < n and not bool(done.all()):  # the one host read per frame
            embeds = self.model.embed_inputs(text[:, None], frame[:, None, :])
            cache, text, frame = self._frame(cache, embeds, window, window_valid, generator, step_decode)
            out_text.append(text)
            out_audio.append(frame)
            roll_in(frame)
            newly_done = ~done & (text == cfg.end_of_music_id)
            lengths = torch.where(newly_done, i + 1, lengths)
            done = done | newly_done
            i += 1
        lengths = torch.where(done, lengths, lengths.clamp(max=i))
        return (
            torch.stack(out_text, dim=1).cpu().numpy(),
            torch.stack(out_audio, dim=1).cpu().numpy(),
            lengths.cpu().numpy(),
        )

    def _generate_one(self, text_tokens, audio_tokens, generator, prefill_decode, step_decode):
        text, audio, lengths = self._generate(
            np.asarray(text_tokens)[None], np.asarray(audio_tokens)[None],
            generator, prefill_decode, step_decode,
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
        """As `generate`, every frame through the growing-shape fast decode."""
        return self._generate_one(
            text_tokens, audio_tokens, generator, self._fast_decode_growing, self._fast_decode_growing
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
