"""Audio batches -> LM token-grid batches (a copy of
`dmel_codec_tpu/lm/data.py`; host code without JAX).

The frozen codec tokenizes each waveform (truncated to max_length frames),
the text tokenizer encodes the transcript, and TokenGridBuilder assembles
the per-sample grids, which are padded into one static-shape batch.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from dmel_codec_tpu_torch.lm.inputs import TokenGridBuilder, pad_grids_to_batch


def lm_batch_from_audio(
    codec_adapter,
    gridder: TokenGridBuilder,
    tokenizer,
    batch: Dict,
    pad_to: Optional[int] = None,
    pad_to_multiple: int = 64,
) -> Dict[str, np.ndarray]:
    """batch: {'audios' [B, L], 'audio_lengths' [B], 'texts': [str]}.

    Without an explicit pad_to, the sequence length is rounded up to
    `pad_to_multiple`, so the train step sees a small set of shapes."""
    indices, idx_lengths = codec_adapter.encode(
        np.asarray(batch["audios"]), batch.get("audio_lengths")
    )
    grids = []
    for i, text in enumerate(batch["texts"]):
        n = min(int(idx_lengths[i]), gridder.max_length)
        audio_ids = indices[i, :, :n].T  # [L, C]
        text_ids = tokenizer.encode(text or "")
        grids.append(gridder.build_train_grid(text_ids, audio_ids))
    if pad_to is None and pad_to_multiple > 1:
        m = max(len(t) for t, _, _ in grids)
        pad_to = ((m + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple
    return pad_grids_to_batch(grids, gridder.config, pad_to=pad_to)
