"""Duration-bucketed batching + background-prefetch loader (a copy of
`dmel_codec_tpu/data/loader.py`; host code without JAX, numpy batches).

  * dynamic batch size by TOTAL seconds (`max_duration`, flagship 210 s)
  * batches padded to QUANTIZED lengths (multiples of `length_quantum`
    samples), so the codec sees a small set of shapes
  * per-rank sharding of the cut list (`num_shards`, `shard_index`: the
    data-parallel world size and this process's rank), taken before the
    sort, and silent zero-length fillers that pad the batch size to a
    multiple (`batch_multiple`)
  * `num_workers` decode threads materialize batches concurrently ahead of
    the training loop. Threads (not processes): both decode backends
    (`audio_backend`, data/audio.py: the native C++ kernels, or scipy's
    wavfile mmap read + resample_poly) release the GIL.

Batch dict matches the trainer contract: {'audios' [B, L] float32,
'audio_lengths' [B] int32, 'texts': list[str | None]}; a filler has
`texts` None and `audio_lengths` 0.
"""

from __future__ import annotations

import itertools
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence

import numpy as np

from dmel_codec_tpu_torch.data.audio import BACKENDS, load_audio
from dmel_codec_tpu_torch.data.manifest import Cut


class BucketBatcher:
    """Groups duration-sorted cuts into <= max_duration-second batches."""

    def __init__(
        self,
        cuts: Sequence[Cut],
        max_duration: float = 210.0,
        shuffle: bool = True,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
        max_batch_size: Optional[int] = None,
    ):
        self.cuts = list(cuts)[shard_index::num_shards]
        self.max_duration = max_duration
        self.shuffle = shuffle
        self.seed = seed
        self.max_batch_size = max_batch_size

    def batches(self, epoch: int = 0) -> List[List[Cut]]:
        cuts = sorted(self.cuts, key=lambda c: c.duration)
        batches: List[List[Cut]] = []
        cur: List[Cut] = []
        cur_max = 0.0
        for cut in cuts:
            # padded cost: every item pays the longest duration in the batch
            new_max = max(cur_max, cut.duration)
            if cur and (
                new_max * (len(cur) + 1) > self.max_duration
                or (self.max_batch_size and len(cur) >= self.max_batch_size)
            ):
                batches.append(cur)
                cur, cur_max = [], 0.0
                new_max = cut.duration
            cur.append(cut)
            cur_max = new_max
        if cur:
            batches.append(cur)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(batches)
        return batches


class DataLoader:
    """Iterates padded numpy batches with one background decode thread."""

    def __init__(
        self,
        cuts: Sequence[Cut],
        sample_rate: int = 24000,
        max_duration: float = 210.0,
        length_quantum: int = 1024,  # pad lengths to a multiple (hop*4)
        shuffle: bool = True,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
        prefetch: int = 2,
        max_batch_size: Optional[int] = None,
        batch_multiple: int = 1,
        num_workers: int = 8,
        audio_backend: str = "auto",
    ):
        """batch_multiple: pad each batch with silent zero-length items so
        that its size is a multiple (masked losses make the fillers
        contribute nothing).

        num_workers: decode threads materializing batches concurrently
        (1 = the original single background thread).

        audio_backend: 'auto' (the native C++ decode kernels where they
        build, else scipy), 'native' or 'python'; see data/audio.load_audio."""
        if audio_backend not in BACKENDS:
            raise ValueError(f"audio_backend {audio_backend!r}: expected one of {BACKENDS}")
        self.sample_rate = sample_rate
        self.length_quantum = length_quantum
        self.batch_multiple = batch_multiple
        self.num_workers = num_workers
        self.audio_backend = audio_backend
        self.batcher = BucketBatcher(
            cuts,
            max_duration=max_duration,
            shuffle=shuffle,
            seed=seed,
            num_shards=num_shards,
            shard_index=shard_index,
            max_batch_size=max_batch_size,
        )
        self.prefetch = prefetch

    def _materialize(self, batch: List[Cut]) -> dict:
        audios = [
            load_audio(
                c.audio_path,
                self.sample_rate,
                c.start,
                c.duration if c.duration > 0 else None,
                backend=self.audio_backend,
            )
            for c in batch
        ]
        lengths = np.array([len(a) for a in audios], np.int32)
        q = self.length_quantum
        max_len = ((int(lengths.max()) + q - 1) // q) * q
        b = len(audios)
        m = self.batch_multiple
        b_pad = ((b + m - 1) // m) * m
        out = np.zeros((b_pad, max_len), np.float32)
        for i, a in enumerate(audios):
            out[i, : len(a)] = a
        lengths = np.concatenate([lengths, np.zeros(b_pad - b, np.int32)])
        return {
            "audios": out,
            "audio_lengths": lengths,
            "texts": [c.text for c in batch] + [None] * (b_pad - b),
        }

    def __iter__(self) -> Iterator[dict]:
        return self.epoch(0)

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        batches = self.batcher.batches(epoch)
        if self.num_workers <= 1:
            yield from self._epoch_single_thread(batches)
            return
        # N decode threads, in-order delivery, bounded look-ahead so memory
        # stays at O(prefetch + num_workers) batches
        window = self.prefetch + self.num_workers
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            it = iter(batches)
            pending: "deque" = deque(
                ex.submit(self._materialize, b)
                for b in itertools.islice(it, window)
            )
            while pending:
                fut = pending.popleft()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(ex.submit(self._materialize, nxt))
                yield fut.result()

    def _epoch_single_thread(self, batches: List[List[Cut]]) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            try:
                for b in batches:
                    q.put(self._materialize(b))
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
