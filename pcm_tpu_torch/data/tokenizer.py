"""Offline hash tokenizer for smoke runs.

The same ids as `pcm_tpu.data.tokenizer.HashTokenizer` (md5 word hashing with
CLIP-style BOS/EOS framing; a test holds the two equal), kept here so that the
port and `chip_smoke.py` load nothing of the JAX package. Real vocabularies
go through `pcm_tpu.data.tokenizer.resolve_tokenizers` (``--tokenizer-dir``).
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np


class HashTokenizer:
    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos_id = vocab_size - 2
        self.eos_id = self.pad_id = vocab_size - 1  # CLIP pads with end-of-text

    def _tok(self, word: str) -> int:
        h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
        return h % (self.vocab_size - 3) + 1  # avoid 0/bos/eos

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), self.max_length), self.pad_id, np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos_id] + [self._tok(w) for w in t.lower().split()]
            ids = ids[: self.max_length - 1] + [self.eos_id]
            out[i, : len(ids)] = ids
        return out
