"""Metrics and image logging of a training run (counterpart of
`pcm_tpu/utils/logging.py`): JSON lines and PNG grids. The JAX logger also
writes TensorBoard where the package is installed; this one does not
(importing it also pulls in TensorFlow where that is installed)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np

from .png import to_uint8, write_png


class MetricsLogger:
    """``<out_dir>/metrics.jsonl`` rows and ``<out_dir>/images/`` grids,
    written by the main rank only (``is_main``; the others' calls do
    nothing), as the JAX logger writes on process 0."""

    def __init__(self, out_dir: str, is_main: bool = True):
        self.out_dir = out_dir
        self.is_main = is_main
        os.makedirs(out_dir, exist_ok=True)

    def log(self, step: int, metrics: Dict) -> None:
        """One row ``{"step", "time", **metrics}``; values that are not
        numbers are left out, as the JAX logger leaves them."""
        if not self.is_main:
            return
        row = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        with open(os.path.join(self.out_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")

    def log_images(self, step: int, tag: str, images: np.ndarray) -> str:
        """(N, H, W, 3) images in [-1, 1] as a PNG grid of ``min(4, N)``
        columns, rows filled in order and the last one padded with black,
        at ``images/<tag>_<step:07d>.png`` (a tag with ``/`` makes nested
        directories); returns the path."""
        path = os.path.join(self.out_dir, "images", f"{tag}_{step:07d}.png")
        if not self.is_main:
            return path
        arr = to_uint8(images)
        n, h, w, _ = arr.shape
        cols = min(4, n)
        rows = (n + cols - 1) // cols
        grid = np.zeros((rows * h, cols * w, 3), np.uint8)
        for i in range(n):
            r, c = divmod(i, cols)
            grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = arr[i]
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_png(path, grid)
        return path
