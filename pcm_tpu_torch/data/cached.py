"""Reader of cached-latents shards (counterpart of
`pcm_tpu/data/dataset.py:238-287` and the trainer's cached collate).

A cache is a directory of ``shard_*.npz`` files (written by
`scripts/cache_latents.py`), each holding same-length arrays per key: at
least ``latents`` (N, h, w, C), optionally ``prompt_embeds`` (N, 77, D) and,
for SDXL, ``pooled_embeds`` (N, 1280) and ``time_ids`` (N, 6). Every key of
a shard is read.
With several ranks each reads its own slice of the shard files
(`dataset.shard_for_process`).
Batches come out as numpy dicts; fp16 arrays (how the cache stores bf16
tensors) are promoted to fp32, as `scripts/train.py:325-329` does.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Iterator, List

import numpy as np

from .dataset import shard_for_process


class CachedLatentsDataset:
    """Random access over the concatenated shards (process ``process_index``
    of ``process_count``'s slice of them), keeping the last ``keep_shards``
    shards loaded."""

    def __init__(self, cache_dir: str, keep_shards: int = 2, process_index: int = 0,
                 process_count: int = 1):
        files = sorted(os.path.join(cache_dir, f) for f in os.listdir(cache_dir)
                       if f.startswith("shard_") and f.endswith(".npz"))
        if not files:
            raise FileNotFoundError(f"no shard_*.npz under {cache_dir}")
        if process_count > len(files):  # every rank raises, not just those left out
            raise ValueError(f"{len(files)} shard files under {cache_dir} for {process_count} "
                             "ranks: each rank needs one")
        self.files = shard_for_process(files, process_index, process_count)
        sizes = []
        for f in self.files:
            with np.load(f) as z:
                sizes.append(z["latents"].shape[0])
        self._offsets = np.cumsum([0] + sizes)
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._keep = keep_shards

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def _shard(self, si: int) -> Dict[str, np.ndarray]:
        if si not in self._cache:
            if len(self._cache) >= self._keep:
                self._cache.pop(next(iter(self._cache)))
            with np.load(self.files[si]) as z:
                self._cache[si] = {k: z[k] for k in z.files}
        return self._cache[si]

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        si = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        shard = self._shard(si)
        return {k: v[idx - self._offsets[si]] for k, v in shard.items()}


def cached_collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack every key; fp16 -> fp32."""
    out = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    return {k: v.astype(np.float32) if v.dtype == np.float16 else v for k, v in out.items()}


def batches(ds: CachedLatentsDataset, batch_size: int, seed: int = 0) -> Iterator[Dict]:
    """Endless shuffled batches, dropping each epoch's ragged tail: the order
    of `pcm_tpu.data.dataset.DataLoader` with the same seed."""
    if len(ds) < batch_size:
        raise ValueError(f"{len(ds)} cached samples cannot fill a batch of {batch_size}")
    rng = random.Random(seed)
    while True:
        order = list(range(len(ds)))
        rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            yield cached_collate([ds.get(j) for j in order[i:i + batch_size]])
