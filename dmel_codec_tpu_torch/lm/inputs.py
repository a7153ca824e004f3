"""Multimodal token-grid construction for the slow-fast LM.

Copy of `dmel_codec_tpu/lm/inputs.py` (numpy and host code), over this package's
`SlowFastLMConfig`.

Capability parity with reference models/modules/lm_process_input.py:8-313.
Builds the 2-modality grid (host-side numpy — this is data prep, not
device compute):

  text row : <SOH><BOS> text <EOS><EOH><SOR><SOM> [text_pad ...] <EOM><EOR>
  audio row: [slow_pad ...]            sil*3 audio-tokens sil*3  slow_pad^2

with per-codebook id shift (+ i*codebook_size) applied to real audio tokens
and silence frames, and train labels [T, C+1] equal to the token rows
(the reference trains through modality pads too, lm_process_input.py:145).

Inference grids end after one forced silence frame so generation starts in
music mode (text-prompt path, :178-249), or follow the audio-/mixed-prompt
layouts (:201-263).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dmel_codec_tpu_torch.models.lm import IGNORE_INDEX, SlowFastLMConfig

TEXT_SPECIAL_TOKEN_LENGTH = 8


@dataclasses.dataclass
class TokenGridBuilder:
    config: SlowFastLMConfig = SlowFastLMConfig()
    max_length: int = 4096
    silence_length: int = 3
    # flagship silence frame (config/lm/lm_config.yaml:44-54)
    audio_silence_id: Sequence[int] = (0, 0, 29, 174, 0, 6, 0, 146, 146, 6)

    def _shift(self, audio_ids: np.ndarray) -> np.ndarray:
        """[.., C] raw codec ids -> slow/fast vocab ids (+ i*codebook_size)."""
        shift = (
            np.arange(self.config.audio_codebook_count)
            * self.config.audio_codebook_size
        )
        return audio_ids + shift

    def _specials(self):
        c = self.config
        start = np.array([c.start_of_human_id, c.bos_token_id], np.int64)
        middle = np.array(
            [c.eos_token_id, c.end_of_human_id, c.start_of_robot_id, c.start_of_music_id],
            np.int64,
        )
        end = np.array([c.end_of_music_id, c.end_of_robot_id], np.int64)
        return start, middle, end

    def build_train_grid(
        self, text_ids: np.ndarray, audio_ids: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """text_ids [Lt], audio_ids [La, C] (raw, unshifted) ->
        (text_tokens [T], audio_tokens [T, C], labels [T, C+1])."""
        c = self.config
        text_ids = np.asarray(text_ids, np.int64).reshape(-1)
        audio_ids = np.asarray(audio_ids, np.int64)
        lt, la = len(text_ids), len(audio_ids)
        sil = self.silence_length

        start, middle, end = self._specials()
        text_pad = np.full(sil * 2 + la, c.text_pad_id, np.int64)
        text_tokens = np.concatenate([start, text_ids, middle, text_pad, end])

        pad_frame = np.full((1, c.audio_codebook_count), c.slow_audio_pad_id, np.int64)
        silence = self._shift(
            np.tile(np.asarray(self.audio_silence_id, np.int64), (sil, 1))
        )
        audio_tokens = np.concatenate(
            [
                np.tile(pad_frame, (TEXT_SPECIAL_TOKEN_LENGTH + lt - 2, 1)),
                silence,
                self._shift(audio_ids),
                silence,
                np.tile(pad_frame, (2, 1)),
            ]
        )
        assert len(text_tokens) == len(audio_tokens)
        labels = np.concatenate([text_tokens[:, None], audio_tokens], axis=1)
        return text_tokens, audio_tokens, labels

    def build_infer_grid(
        self,
        text_ids: Optional[np.ndarray] = None,
        audio_ids: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Prompt grid -> (text_tokens [T], audio_tokens [T, C]).

        text-only: ends after ONE forced silence frame; text+audio: pads,
        one silence frame, then the audio prompt; audio-only: pad text row
        against [silence, audio] (ref :160-263)."""
        c = self.config
        start, middle, _ = self._specials()
        pad_frame = np.full((1, c.audio_codebook_count), c.slow_audio_pad_id, np.int64)
        one_silence = self._shift(
            np.asarray(self.audio_silence_id, np.int64)[None, :]
        )

        if text_ids is not None:
            text_ids = np.asarray(text_ids, np.int64).reshape(-1)
            lt = len(text_ids)
            n_start_pads = TEXT_SPECIAL_TOKEN_LENGTH + lt - 2
            if audio_ids is not None:
                audio_ids = np.asarray(audio_ids, np.int64)
                la = len(audio_ids)
                text_tokens = np.concatenate(
                    [start, text_ids, middle, np.full(la + 1, c.text_pad_id, np.int64)]
                )
                audio_tokens = np.concatenate(
                    [
                        np.tile(pad_frame, (n_start_pads, 1)),
                        one_silence,
                        self._shift(audio_ids),
                    ]
                )
            else:
                text_tokens = np.concatenate(
                    [start, text_ids, middle, np.full(1, c.text_pad_id, np.int64)]
                )
                audio_tokens = np.concatenate(
                    [np.tile(pad_frame, (n_start_pads, 1)), one_silence]
                )
        else:
            assert audio_ids is not None
            audio_ids = np.asarray(audio_ids, np.int64)
            la = len(audio_ids)
            text_tokens = np.full(la + 1, c.text_pad_id, np.int64)
            audio_tokens = np.concatenate([one_silence, self._shift(audio_ids)])

        assert len(text_tokens) == len(audio_tokens)
        return text_tokens, audio_tokens


def pad_grids_to_batch(
    grids: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    config: SlowFastLMConfig = SlowFastLMConfig(),
    pad_to: Optional[int] = None,
) -> dict:
    """Per-sample train grids -> batch dict with static shapes.

    Token rows are padded with the modality pad ids (their embeddings are
    zeroed via `valid`, matching the reference's zero-padded embed
    pad_sequence); labels are padded with -100 (lm_lit_modules.py:245-250).
    """
    c = config.audio_codebook_count
    s = pad_to or max(len(t) for t, _, _ in grids)
    b = len(grids)
    text = np.full((b, s), config.text_pad_id, np.int64)
    audio = np.full((b, s, c), config.slow_audio_pad_id, np.int64)
    labels = np.full((b, s, c + 1), IGNORE_INDEX, np.int64)
    valid = np.zeros((b, s), np.float32)
    for i, (t, a, l) in enumerate(grids):
        n = min(len(t), s)
        text[i, :n] = t[:n]
        audio[i, :n] = a[:n]
        labels[i, :n] = l[:n]
        valid[i, :n] = 1.0
    return {
        "text_tokens": text,
        "audio_tokens": audio,
        "text_labels": labels[:, :, 0],
        "audio_labels": labels[:, :, 1:],
        "valid": valid,
    }
