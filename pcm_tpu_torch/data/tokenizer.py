"""Tokenizers of the text towers (counterpart of `pcm_tpu/data/tokenizer.py`
and `pcm_tpu/data/native_tokenizer.py`).

`HashTokenizer` is the offline smoke-run fallback: the same ids as the JAX
package's (md5 word hashing with CLIP-style BOS/EOS framing; a test holds the
two equal). `resolve_tokenizers` builds the per-tower tokenizers of a local
tokenizer directory: the native C++ CLIP BPE (``native/clip_bpe.cpp``, bound
with ctypes and built on first use with ``g++`` into
``build/pcm_tpu_torch/native/<source hash>/``, under the image library's lock
and rename: `native_image.load_native`) where ``vocab.json`` and
``merges.txt`` exist, else a transformers tokenizer. The port keeps its own
copy so that it loads nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings
from typing import Dict, Optional, Sequence

import numpy as np

from . import native_image


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


class HFTokenizer:
    """A transformers tokenizer from a local directory (no network)."""

    def __init__(self, path: str, max_length: int = 77):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.max_length = max_length

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        enc = self.tok(list(texts), padding="max_length", max_length=self.max_length,
                       truncation=True, return_tensors="np")
        return enc["input_ids"].astype(np.int32)


class NativeCLIPTokenizer:
    """CLIP BPE from vocab.json + merges.txt in C++ (``native/clip_bpe.cpp``):
    BOS text EOS, padded with EOS, as CLIPTokenizer frames it."""

    def __init__(self, vocab_path: str, merges_path: str, max_length: int = 77,
                 bos_id: int = 49406, eos_id: int = 49407, pad_id: Optional[int] = None):
        lib = native_image.load_native("clip_bpe.cpp", libs=())
        lib.clip_bpe_new.restype = ctypes.c_void_p
        lib.clip_bpe_new.argtypes = [ctypes.c_char_p, ctypes.c_char_p] + [ctypes.c_int] * 3
        lib.clip_bpe_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        lib.clip_bpe_free.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._handle = lib.clip_bpe_new(vocab_path.encode(), merges_path.encode(), bos_id,
                                        eos_id, eos_id if pad_id is None else pad_id)
        if not self._handle:
            raise RuntimeError(f"failed to load vocab/merges: {vocab_path}, {merges_path}")
        self.max_length = max_length

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        n = len(texts)
        out = np.empty((n, self.max_length), np.int32)
        arr = (ctypes.c_char_p * n)(*[t.encode("utf-8", "ignore") for t in texts])
        self._lib.clip_bpe_encode_batch(self._handle, arr, n,
                                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                        self.max_length)
        return out

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.clip_bpe_free(self._handle)


# per-tower subdirectories of a pipeline dump (`tokenizer/`, `tokenizer_2/`, ...)
TOWER_SUBDIRS = {"input_ids": "tokenizer", "input_ids_2": "tokenizer_2",
                 "input_ids_3": "tokenizer_3"}


def resolve_tokenizers(tokenizer_dir: Optional[str], tok_keys: Sequence[str],
                       max_length: int = 77) -> Dict[str, object]:
    """The per-tower tokenizers of the CLIs. ``tokenizer_dir`` is one
    tokenizer directory or a pipeline root with ``tokenizer{,_2,_3}/``. CLIP
    towers take the native BPE where ``vocab.json`` and ``merges.txt`` exist
    (transformers if it cannot be built), the T5 tower (``input_ids_3``)
    transformers. Without a directory: hash tokenizers (smoke runs)."""
    if tokenizer_dir:
        toks = {}
        for k in tok_keys:
            d = tokenizer_dir
            sub = os.path.join(tokenizer_dir, TOWER_SUBDIRS.get(k, ""))
            if TOWER_SUBDIRS.get(k) and os.path.isdir(sub):
                d = sub
            vocab, merges = os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt")
            if k != "input_ids_3" and os.path.exists(vocab) and os.path.exists(merges):
                try:
                    toks[k] = NativeCLIPTokenizer(vocab, merges, max_length=max_length)
                    continue
                except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
                    warnings.warn(f"native CLIP BPE unavailable ({e}); "
                                  f"using transformers for {k}")
            toks[k] = HFTokenizer(d, max_length)
        return toks
    return {k: HashTokenizer(vocab_size=32128 if k == "input_ids_3" else 49408,
                             max_length=max_length) for k in tok_keys}
