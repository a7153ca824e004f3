"""Text tokenizer loading with a dependency-free fallback.

Copy of `dmel_codec_tpu/lm/tokenizer.py` (host code).

The reference requires Qwen2Tokenizer files on disk
(lm_lit_modules.py:106, config text_tokenizer_path). When a HF tokenizer
path is available we use it; otherwise a UTF-8 byte tokenizer keeps the
whole LM pipeline runnable end-to-end (ids stay far below the Qwen2
special-token range, so the grid layout is unaffected).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class ByteTokenizer:
    """UTF-8 bytes as token ids (0..255)."""

    vocab_size = 256

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(np.int64)

    def decode(self, ids) -> str:
        return bytes(int(i) for i in ids if 0 <= int(i) < 256).decode(
            "utf-8", errors="replace"
        )

    def __call__(self, text: str):
        return {"input_ids": self.encode(text)[None, :]}


class HFTokenizer:
    """Thin adapter exposing encode/decode over a HF tokenizer."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path)

    def encode(self, text: str) -> np.ndarray:
        return np.asarray(self.tok(text)["input_ids"], np.int64)

    def decode(self, ids) -> str:
        return self.tok.decode([int(i) for i in ids], skip_special_tokens=True)

    def __call__(self, text: str):
        return {"input_ids": self.encode(text)[None, :]}


def load_text_tokenizer(path: Optional[str] = None):
    if path:
        return HFTokenizer(path)
    return ByteTokenizer()
