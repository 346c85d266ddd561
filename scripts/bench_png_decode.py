#!/usr/bin/env python3
"""Host time of the port's numpy PNG decoder and resize (`data/native_image.py`:
the image loader's path where the native image library does not build), on
PNGs whose rows are filtered as adaptive encoders filter them.

    python scripts/bench_png_decode.py [--root DIR] [--tag NAME] [--out FILE]

``--root`` is the checkout whose ``pcm_tpu_torch`` is imported (default: the
one holding this script), so that a parent commit unpacked into
``build/parent`` and this tree are timed on one host in turns, one process
each. The images are `chip_smoke.py` phase 13's (seeded smooth colour fields
with noise), encoded by this checkout's `chip_smoke.png_filtered` (rows
cycling through Sub, Up, Average and Paeth), at 512 x 512, 576 x 720 and
1024 x 1024. Per image, on one thread: whether the decode gives the image
back, and the median of 5 timings of the decode and of decode + resize of
the shortest side to 512 (`load_resized_numpy`, the loader's call). Prints,
and appends to ``--out``, one JSON object per image. Needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SIZES = ((512, 512), (576, 720), (1024, 1024))


def median_ms(fn, reps: int = 5) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1000.0)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--out", default=None, help="JSON-lines file to append to")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    from chip_smoke import png_filtered

    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np

    from pcm_tpu_torch.data import native_image

    rng = np.random.default_rng(0)
    rows = []
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        for h, w in SIZES:
            coarse = rng.uniform(0, 255, (h // 64 + 1, w // 64 + 1, 3))
            field = np.kron(coarse, np.ones((64, 64, 1)))[:h, :w]
            img = np.clip(field + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
            data = png_filtered(img)
            path = os.path.join(tmp, f"{h}x{w}.png")
            with open(path, "wb") as f:
                f.write(data)
            row = {"tag": args.tag, "root": args.root, "shape": [h, w, 3],
                   "filters": "Sub/Up/Average/Paeth by row", "cpus": os.cpu_count(),
                   "exact": bool(np.array_equal(native_image.decode_png(data), img)),
                   "decode_ms": median_ms(lambda: native_image.decode_png(data)),
                   "load_resized_ms": median_ms(
                       lambda: native_image.load_resized_numpy(path, 512))}
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0 if all(r["exact"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
