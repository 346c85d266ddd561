"""Image-folder dataset with sidecar ``.txt`` captions and a parallel loader
(counterpart of `pcm_tpu/data/dataset.py:23-236`).

`ImageFolderDataset` resizes each image's shortest side to the resolution
(Lanczos-3, `data/native_image.py`), crops it to a square, center (SD1.5)
or at random (SDXL, which also returns the resized size and the crop's
top-left corner for the UNet's micro-conditioning), scales it to [-1, 1]
and reads ``<stem>.txt`` as its caption
(empty when missing), replaced by the empty prompt with probability
``proportion_empty_prompts``; a sample that fails to load is replaced by
another drawn at random, up to 16 times (the reference's skip-bad-sample
retry). A folder holding files its decoder cannot read (under the numpy
decoder WebP, progressive or other non-baseline JPEGs and compressed BMPs,
found from each file's first bytes; BMPs take the numpy decoder under
either) is refused when the dataset is made, not skipped file by file.
`DataLoader` shuffles the indices each epoch with ``random.Random(seed)`` (the JAX
loader's order), drops each epoch's ragged tail, loads a batch's samples on
a pool of workers and keeps `PREFETCH` collated batches ahead. The workers
are threads for the native decoder, whose C call releases the GIL, and
processes for the numpy one, which takes the GIL back a few thousand times
an image: in threads it stalls the training step's dispatch on the same
GIL.

One repair against the JAX loader, which shares one ``random.Random`` across
its load threads (so dropout and retries depend on thread timing): every
sample's randomness here comes from a ``random.Random`` seeded with (seed,
epoch, position in the epoch), so a seed fixes the batches.

With several ranks each reads its own slice of the file list
(`shard_for_process`, applied by the trainer to ``files``).
"""

from __future__ import annotations

import functools
import multiprocessing
import os
import random
import signal
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np

from ..utils.threads import prefetch_thread
from . import native_image

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")
PREFETCH = 4  # collated batches the loader keeps ready


def list_image_files(root: str) -> List[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        out.extend(os.path.join(dirpath, f) for f in files if f.lower().endswith(IMAGE_EXTS))
    return sorted(out)


def shard_for_process(files: Sequence[str], index: int, count: int) -> List[str]:
    """Process ``index`` of ``count``'s files: every ``count``-th from its index."""
    return list(files[index::count])


def sample_rng(seed: int, epoch: int, position: int) -> random.Random:
    """The randomness of one sample: fixed by (seed, epoch, position)."""
    return random.Random(f"{seed}/{epoch}/{position}")


class ImageFolderDataset:
    def __init__(self, root: str, resolution: int = 512, proportion_empty_prompts: float = 0.0,
                 seed: int = 0, use_native: Optional[bool] = None,
                 crop: str = "center"):  # "center" | "random" (SDXL)
        self.files = list_image_files(root)
        if not self.files:
            raise FileNotFoundError(f"no images under {root}")
        self.resolution = resolution
        self.crop = crop
        self.proportion_empty_prompts = proportion_empty_prompts
        self.seed = seed
        self.use_native = native_image.available() if use_native is None else use_native
        self.decoder = "native" if self.use_native else "numpy"
        problems = [(f, why) for f in self.files if (why := self._problem(f))]
        if problems:
            path, why = problems[0]
            hint = "" if self.use_native else (
                f"; the native image library reads WebP and every JPEG: "
                f"{native_image.native_error() or 'not chosen'}")
            raise ValueError(f"{len(problems)} of the {len(self.files)} images under {root} are "
                             f"files the {self.decoder} decoder cannot read (first: {path}: "
                             f"{why}){hint}")

    def _problem(self, path: str) -> Optional[str]:
        """Why ``path`` cannot be loaded (its format read from its first
        bytes), or None: the native decoder reads its extensions' files, the
        numpy one the rest (`native_image.numpy_problem`)."""
        if self.use_native and path.lower().endswith(native_image.NATIVE_EXTS):
            return None
        return native_image.numpy_problem(path)

    def __len__(self) -> int:
        return len(self.files)

    def _load(self, idx: int, rng: random.Random) -> Dict:
        """The sample; ``rng`` draws the random crop's left, then its top, then
        the dropout, in the JAX dataset's order (`pcm_tpu/data/dataset.py:91-104`)."""
        path, res = self.files[idx], self.resolution
        rgb = native_image.load_resized(path, res, self.use_native)
        h, w = rgb.shape[:2]
        if self.crop == "center":
            left, top = (w - res) // 2, (h - res) // 2
        else:
            left = rng.randint(0, w - res) if w > res else 0
            top = rng.randint(0, h - res) if h > res else 0
        crop = rgb[top:top + res, left:left + res]
        caption = ""
        cap_path = os.path.splitext(path)[0] + ".txt"
        if os.path.exists(cap_path):
            with open(cap_path) as f:
                caption = f.read().strip()
        if self.proportion_empty_prompts > 0 and rng.random() < self.proportion_empty_prompts:
            caption = ""
        out = {"pixel_values": crop.astype(np.float32) / 127.5 - 1.0, "caption": caption}
        if self.crop == "random":  # SDXL's micro-conditioning
            out["original_size"] = np.asarray([h, w], np.float32)
            out["crop_coords"] = np.asarray([top, left], np.float32)
        return out

    def get(self, idx: int, rng: Optional[random.Random] = None) -> Dict:
        """Sample ``idx`` (its randomness from ``rng``, else from (seed, 0, idx));
        a sample that fails to load is replaced by a random other, up to 16 tries."""
        rng = rng or sample_rng(self.seed, 0, idx)
        for _ in range(16):
            try:
                return self._load(idx, rng)
            except Exception:  # a bad file: the reference skips it
                idx = rng.randrange(len(self.files))
        raise RuntimeError("too many consecutive bad samples")


_worker_dataset: Optional[ImageFolderDataset] = None  # a load process's dataset


def _init_load_process(dataset: ImageFolderDataset) -> None:
    global _worker_dataset
    _worker_dataset = dataset
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # the trainer handles a Ctrl-C


def _load(dataset: Optional[ImageFolderDataset], seed: int, item: tuple) -> Dict:
    epoch, pos, idx = item
    return (dataset or _worker_dataset).get(idx, sample_rng(seed, epoch, pos))


class DataLoader:
    """Endless shuffled batches of ``collate(samples)``; an error in a load
    is raised from the iterator."""

    def __init__(self, dataset: ImageFolderDataset, batch_size: int,
                 collate: Callable[[List[Dict]], Dict], num_workers: int = 8, seed: int = 0):
        if len(dataset) < batch_size:
            raise ValueError(f"{len(dataset)} images cannot fill a batch of {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.num_workers = max(1, num_workers)
        self.seed = seed

    def index_batches(self) -> Iterator[List[tuple]]:
        """Endless (epoch, position, index) triples a batch, in the JAX loader's order."""
        order_rng = random.Random(self.seed)
        epoch = 0
        while True:
            order = list(range(len(self.dataset)))
            order_rng.shuffle(order)
            for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
                yield [(epoch, p, order[p]) for p in range(i, i + self.batch_size)]
            epoch += 1

    def __iter__(self) -> Iterator[Dict]:
        if self.dataset.use_native:
            pool = ThreadPoolExecutor(self.num_workers, thread_name_prefix="pcm-image-load")
            load = functools.partial(_load, self.dataset, self.seed)
        else:
            pool = ProcessPoolExecutor(self.num_workers,
                                       mp_context=multiprocessing.get_context("spawn"),
                                       initializer=_init_load_process, initargs=(self.dataset,))
            load = functools.partial(_load, None, self.seed)
        batches = (self.collate(list(pool.map(load, items))) for items in self.index_batches())
        feed = prefetch_thread(batches, PREFETCH, "pcm-image-loader")
        try:
            for batch in feed:
                yield batch
        finally:  # cancel the queued loads first, so that closing the feed waits for none
            pool.shutdown(wait=False, cancel_futures=True)
            feed.close()


def make_collate(tokenizers: Mapping[str, Callable], resolution: Optional[int] = None,
                 sdxl: bool = False) -> Callable[[List[Dict]], Dict]:
    """The batch assembly (`pcm_tpu/data/dataset.py:219-236`): stacked pixels,
    each tower's token ids of the captions and, with ``sdxl`` (samples of a
    random-crop dataset), ``time_ids`` [orig_h, orig_w, top, left,
    resolution, resolution] in float32."""
    if sdxl and not resolution:
        raise ValueError("the SDXL collate needs the resolution (the time_ids' target size)")

    def collate(samples: List[Dict]) -> Dict[str, np.ndarray]:
        caps = [s["caption"] for s in samples]
        batch = {"pixel_values": np.stack([s["pixel_values"] for s in samples])}
        for key, tok in tokenizers.items():
            batch[key] = tok(caps)
        if sdxl:
            orig = np.stack([s["original_size"] for s in samples])
            crop = np.stack([s["crop_coords"] for s in samples])
            target = np.full((len(samples), 2), resolution, np.float32)
            batch["time_ids"] = np.concatenate([orig, crop, target], axis=1)
        return batch

    return collate
