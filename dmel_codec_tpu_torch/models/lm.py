"""Slow-fast multimodal LM ("MusicLLM"): text + codec-token transformer
(port of `dmel_codec_tpu/models/lm.py`).

  * slow model: Qwen2-0.5B-shaped decoder over summed embeddings
    text_emb(ids) + projector(concat of 10 shifted-codebook audio embs), or
    any `TransformerConfig` kind (a DeepSeek-V3 decoder: MLA and experts;
    a Kimi Linear one: KDA, NoPE MLA and experts, its cache hybrid; a
    Nemotron-H one: Mamba-2, NoPE GQA and squared-ReLU experts, one mixer a
    block, its cache hybrid)
  * fast model: small depth decoder over per-frame windows
    [slow_hidden, cb0..cb9] (11 tokens), pre-RMSNorm on the slow hidden +
    896->480 projection
  * heads: text 896->151936, audio 480->1800, both bias-free
  * losses: shifted CE with ignore -100; audio labels get the shifted text
    label column-concatenated so depth position i predicts codebook i;
    NaN/Inf losses zeroed; weighted sum
  * generation forwards: slow step with explicit KV cache; fast per-frame
    decode over <= 11 tokens, with or without a cache. The fixed-shape one
    (`forward_generate_audio_fixed`) runs each fast block as kernel K4
    (`ops/fast_block.py`) where the fast decoder's `fusable` holds: sizes
    K4 takes, bf16 weights off the CPU, no gradient taken, no block cut for
    tensor parallelism; everywhere else (the CPU, float32, training, tensor
    parallelism, other sizes) the modules run

Logits come out in the activations' dtype; the cross entropy is float32.
Under tensor parallelism a head cut over its vocabulary
(`vocab_groups`, set by `parallel/tensor.set_model_groups`) gives this
rank's slice of the logits, and the cross entropy is taken over the slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dmel_codec_tpu_torch.models.transformer import (
    FAST_LM_CONFIG,
    SLOW_LM_CONFIG,
    Decoder,
    RMSNorm,
    TransformerConfig,
    init_kv_cache,
)
from dmel_codec_tpu_torch.models.deepseek_v3 import Experts, TopkRouter
from dmel_codec_tpu_torch.models.kimi_linear import KimiDeltaAttention
from dmel_codec_tpu_torch.models.nemotron_h import Mamba2Mixer
from dmel_codec_tpu_torch.parallel.mesh import global_count
from dmel_codec_tpu_torch.parallel.tensor import copy_to_model, vocab_parallel_cross_entropy

IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class SlowFastLMConfig:
    slow: TransformerConfig = SLOW_LM_CONFIG
    fast: TransformerConfig = FAST_LM_CONFIG
    audio_codebook_count: int = 10
    audio_codebook_size: int = 180

    # special ids (the reference's slow_lm_0.5B.json)
    bos_token_id: int = 151643
    eos_token_id: int = 151643
    start_of_human_id: int = 151644
    end_of_human_id: int = 151645
    start_of_robot_id: int = 151646
    end_of_robot_id: int = 151647
    start_of_music_id: int = 151648
    end_of_music_id: int = 151649
    text_pad_id: int = 151650  # text_modality_mambaout_token_id
    slow_audio_pad_id: int = 179  # slow_audio_modality_mambaout_token_id
    fast_audio_pad_id: int = 176  # fast audio_pad_token_id

    text_weight: float = 1.0
    audio_weight: float = 1.0

    @property
    def audio_vocab(self) -> int:
        return self.audio_codebook_count * self.audio_codebook_size  # 1800

    @property
    def codebook_shift(self) -> np.ndarray:
        """Per-codebook id offset: cb i lives at [i*size, (i+1)*size)."""
        return np.arange(self.audio_codebook_count) * self.audio_codebook_size


def cross_entropy_ignore(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = IGNORE_INDEX, vocab_group=None
) -> torch.Tensor:
    """Mean CE over labels != ignore_index (HF ForCausalLMLoss semantics,
    on ALREADY-shifted logits/labels); 0 when every label is ignored. Inside
    a data-parallel step (`parallel.mesh.global_batch`) the count is every
    rank's: this rank's share of the global mean. With `vocab_group` the
    logits are this rank's slice of the vocabulary (tensor parallelism)."""
    flat_logits, flat_labels = logits.float().reshape(-1, logits.shape[-1]), labels.reshape(-1)
    if vocab_group is None:
        total = F.cross_entropy(flat_logits, flat_labels, ignore_index=ignore_index, reduction="sum")
    else:
        total = vocab_parallel_cross_entropy(flat_logits, flat_labels, ignore_index, vocab_group)
    return total / global_count((labels != ignore_index).sum()).clamp(min=1)


def _zero_if_not_finite(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


class ChatMusicLM(nn.Module):
    """Full slow-fast LM. Inputs are the multimodal token grid of
    lm/inputs.py; embeddings, both decoders and both heads live here.

    `audio_projector` is the JAX package's DenseGeneral over (codebook,
    hidden) as a Linear over the flattened codebook embeddings."""

    def __init__(self, config: SlowFastLMConfig = SlowFastLMConfig()):
        super().__init__()
        cfg = self.config = config
        hs, hf = cfg.slow.hidden_size, cfg.fast.hidden_size
        self.text_embed = nn.Embedding(cfg.slow.vocab_size, hs)
        self.slow_audio_embed = nn.Embedding(cfg.audio_vocab, hs)
        self.audio_projector = nn.Linear(cfg.audio_codebook_count * hs, hs, bias=False)
        self.slow_decoder = Decoder(cfg.slow)

        self.fast_pre_norm = RMSNorm(hs, cfg.fast.rms_norm_eps)
        self.fast_projector = nn.Linear(hs, hf)
        self.fast_audio_embed = nn.Embedding(cfg.audio_vocab, hf)
        self.fast_decoder = Decoder(cfg.fast)

        self.text_head = nn.Linear(hs, cfg.slow.vocab_size, bias=False)
        self.audio_head = nn.Linear(hf, cfg.audio_vocab, bias=False)
        # tensor parallel: the model group of a head cut over its vocabulary
        self.vocab_groups = {"text_head": None, "audio_head": None}
        # fast-decoder block calls of the generation forwards, through K4 or the modules
        self.fast_block_calls = {"fused": 0, "module": 0}
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(
        self, std: float = 0.02, generator: Optional[torch.Generator] = None
    ) -> None:
        """HF Qwen2's scheme: N(0, std) weights, zero biases, unit norms;
        experts and routers as HF DeepseekV3's (N(0, std), a zero
        correction bias); KDA's convolutions N(0, std) and its gates' A_log
        and dt_bias as fla draws them; Mamba-2's convolution N(0, std) with
        a zero bias, its A_log, dt_bias and D as HF Nemotron-H draws them."""
        for m in self.modules():
            if isinstance(m, KimiDeltaAttention):
                m.reset_gates(generator)
            if isinstance(m, Mamba2Mixer):
                m.reset_ssm(generator)
            if isinstance(m, (nn.Linear, nn.Embedding, TopkRouter, nn.Conv1d)):
                m.weight.normal_(0.0, std, generator=generator)
                for bias in ("bias", "e_score_correction_bias"):
                    if getattr(m, bias, None) is not None:
                        getattr(m, bias).zero_()
            elif isinstance(m, Experts):
                for w in m.parameters(recurse=False):  # gate_up_proj or up_proj, then down_proj
                    w.normal_(0.0, std, generator=generator)
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)

    # ---- embeddings -------------------------------------------------------
    def embed_inputs(self, text_ids: torch.Tensor, audio_ids: torch.Tensor) -> torch.Tensor:
        """text_ids [B, S], audio_ids [B, S, C] (shifted ids) -> [B, S, H].

        Pad ids embed to exact zeros (torch nn.Embedding padding_idx
        semantics), so modality-pad frames contribute nothing through the
        bias-free projector."""
        cfg = self.config
        text = self.text_embed(text_ids)
        text = text.masked_fill((text_ids == cfg.text_pad_id)[..., None], 0.0)
        audio = self.slow_audio_embed(audio_ids)  # [B, S, C, H]
        audio = audio.masked_fill((audio_ids == cfg.slow_audio_pad_id)[..., None], 0.0)
        return text + self.audio_projector(audio.flatten(-2))  # contracts (C, H) -> H

    # ---- training forward -------------------------------------------------
    def forward(
        self,
        inputs_embeds: torch.Tensor,
        text_labels: torch.Tensor,
        audio_labels: torch.Tensor,
    ) -> Dict[str, torch.Tensor]:
        """inputs_embeds [B, S, H]; text_labels [B, S]; audio_labels [B, S, C].
        Labels use -100 for ignored positions (both paddings)."""
        cfg = self.config
        b, s, _ = inputs_embeds.shape
        c = cfg.audio_codebook_count

        text_group, audio_group = self.vocab_groups["text_head"], self.vocab_groups["audio_head"]
        slow_hidden, _ = self.slow_decoder(inputs_embeds)
        text_logits = self.text_head(copy_to_model(slow_hidden, text_group))  # [B, S, V_text (this rank's)]

        # fast model input: labels shifted off the first frame
        frame_labels = audio_labels[:, 1:, :]  # [B, S-1, C]
        pad = frame_labels == IGNORE_INDEX
        fast_ids = frame_labels.masked_fill(pad, cfg.fast_audio_pad_id)
        h = self.fast_projector(self.fast_pre_norm(slow_hidden[:, :-1, :]))  # [B, S-1, h_fast]
        cb_emb = self.fast_audio_embed(fast_ids)  # [B, S-1, C, h_fast]
        # the fast pad row is torch padding_idx
        cb_emb = cb_emb.masked_fill((fast_ids == cfg.fast_audio_pad_id)[..., None], 0.0)
        fast_in = torch.cat([h[:, :, None, :], cb_emb], dim=2).reshape(b * (s - 1), c + 1, -1)
        fast_hidden, _ = self.fast_decoder(fast_in)
        audio_logits = self.audio_head(copy_to_model(fast_hidden, audio_group))  # [B*(S-1), C+1, V_audio]

        # text loss: standard next-token shift
        text_loss = _zero_if_not_finite(
            cross_entropy_ignore(text_logits[:, :-1, :], text_labels[:, 1:], vocab_group=text_group)
        )
        # audio loss: depth-shift with the text label column prepended, so
        # position i predicts codebook i
        text_col = text_labels[:, 1:].reshape(b * (s - 1), 1)
        depth_labels = torch.cat([text_col, frame_labels.reshape(b * (s - 1), c)], dim=1)
        audio_loss = _zero_if_not_finite(
            cross_entropy_ignore(audio_logits[:, :-1, :], depth_labels[:, 1:], vocab_group=audio_group)
        )

        loss = cfg.text_weight * text_loss + cfg.audio_weight * audio_loss
        return {
            "loss": loss,
            "text_loss": text_loss,
            "audio_loss": audio_loss,
            "text_logits": text_logits,
            "audio_logits": audio_logits,
        }

    # ---- generation forwards ----------------------------------------------
    def forward_generate_text(
        self, inputs_embeds: torch.Tensor, cache: dict
    ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
        """Incremental slow step. Returns (text_logits [B, S, V],
        slow_hidden [B, S, H], cache)."""
        slow_hidden, cache = self.slow_decoder(inputs_embeds, cache=cache)
        return self.text_head(slow_hidden), slow_hidden, cache

    def forward_generate_audio(
        self, slow_hidden: torch.Tensor, fast_ids: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """slow_hidden [B, 1, H_slow], fast_ids [B, i] (or None) ->
        audio logits of the LAST depth position [B, V_audio]."""
        h = self.fast_depth_pos0(slow_hidden)  # [B, 1, h_fast]
        if fast_ids is not None:
            h = torch.cat([h, self.fast_audio_embed(fast_ids)], dim=1)
        fast_hidden, _ = self.fast_decoder(h)
        self.fast_block_calls["module"] += len(self.fast_decoder.layers)
        return self.audio_head(fast_hidden[:, -1, :])

    def forward_generate_audio_fixed(
        self, slow_hidden: torch.Tensor, fast_ids: torch.Tensor
    ) -> torch.Tensor:
        """Fixed-shape depth decode: slow_hidden [B, 1, H] + fast_ids [B, C]
        (later entries not yet decided: causal masking hides them) ->
        logits for ALL depth positions [B, C+1, V]. Position i predicts
        codebook i. Each fast block runs as K4 where the fast decoder's
        `fusable` holds, else the decoder's modules run."""
        x = torch.cat([self.fast_depth_pos0(slow_hidden), self.fast_audio_embed(fast_ids)], dim=1)
        fused = self.fast_decoder.fusable(x.shape[1])
        fast_hidden, _ = self.fast_decoder(x, fused=fused)
        self.fast_block_calls["fused" if fused else "module"] += len(self.fast_decoder.layers)
        return self.audio_head(fast_hidden)

    def fast_depth_pos0(self, slow_hidden: torch.Tensor) -> torch.Tensor:
        """Depth-position-0 input: [B, 1, H_slow] -> [B, 1, h_fast]."""
        return self.fast_projector(self.fast_pre_norm(slow_hidden))

    def fast_embed_tokens(self, fast_ids: torch.Tensor) -> torch.Tensor:
        """Codebook token ids -> fast embeddings (depth positions >= 1)."""
        return self.fast_audio_embed(fast_ids)

    def forward_generate_audio_cached(
        self, x: torch.Tensor, cache: dict
    ) -> Tuple[torch.Tensor, dict]:
        """One depth position through the fast decoder with a KV cache
        (same maths as `forward_generate_audio_fixed` position by position:
        RoPE position = the cache's device index, attention over the cache's
        positions up to this one, the rest masked). x
        [B, 1, h_fast] is `fast_depth_pos0` for position 0 and
        `fast_embed_tokens(token)[:, None]` after. Returns (audio logits
        [B, V_audio] for this position, cache)."""
        fast_hidden, cache = self.fast_decoder(x, cache=cache)
        self.fast_block_calls["module"] += len(self.fast_decoder.layers)
        return self.audio_head(fast_hidden[:, -1, :]), cache

    def init_slow_cache(self, batch: int, max_len: int, dtype=torch.float32) -> dict:
        device = self.text_head.weight.device
        return init_kv_cache(self.config.slow, batch, max_len, dtype, device)

    def init_fast_cache(self, batch: int, dtype=torch.float32) -> dict:
        """Depth cache over the C predicted positions (position C's input,
        the last codebook's embedding, is never fed)."""
        device = self.text_head.weight.device
        return init_kv_cache(
            self.config.fast, batch, self.config.audio_codebook_count, dtype, device
        )


@torch.no_grad()
def load_qwen2_foundation(model: ChatMusicLM, sd: dict) -> ChatMusicLM:
    """Load a HF Qwen2-0.5B state_dict ('model.*' keys, tensors or arrays)
    into a ChatMusicLM in place: decoder weights + text embeddings (the
    checkpoint's rows, row `text_pad_id` zeroed like nn.Embedding
    padding_idx); the text head gets `lm_head.weight`, or the tied input
    embedding when that is absent (Qwen2-0.5B tie_word_embeddings=true)."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    prefix = "model."
    decoder_sd = {
        k[len(prefix):]: v
        for k, v in sd.items()
        if k.startswith(prefix + "layers.") or k == prefix + "norm.weight"
    }
    model.slow_decoder.load_state_dict(decoder_sd)
    emb = sd["model.embed_tokens.weight"]  # [V, H]
    model.text_embed.weight[: emb.shape[0]] = emb.to(model.text_embed.weight)
    model.text_embed.weight[model.config.text_pad_id] = 0.0
    head = sd.get("lm_head.weight", emb)  # tying needs a checkpoint with the LM's vocabulary
    model.text_head.weight.copy_(head.to(model.text_head.weight))
    return model
