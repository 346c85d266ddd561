"""FID between two sets of images or features (counterpart of
`scripts/eval_fid.py`, over `utils/fid.py`):

  python -m pcm_tpu_torch.eval_fid --features-a a.npy --features-b b.npy
  python -m pcm_tpu_torch.eval_fid --image-dir-a gen/ --image-dir-b ref/ \\
      [--clip-weights clip_vit_l14_vision.safetensors | --extractor pkg.mod:fn] \\
      [--batch 32] [--resolution 299] [--device cuda]

In images mode each folder's files (`data/dataset.py:list_image_files`) are
read by the port's numpy decoders (PNG, baseline JPEG, BMP; no PIL) and
resized to ``--resolution`` square with Lanczos-3 (`data/native_image.py:
resize_to`), as PIL's ``resize((res, res), LANCZOS)`` does in the JAX
script. The extractor maps (N, H, W, 3) images in [-1, 1] to (N, D)
activations: ``--clip-weights`` runs the CLIP ViT-L/14 vision tower over a
transformers ``CLIPVisionModelWithProjection`` file on ``--device``
("CLIP-FID"), ``--extractor`` any callable; without either a downsampled-
pixel extractor stands in, a smoke metric only (not comparable to
pytorch-fid numbers), and a warning says so.
"""

from __future__ import annotations

import argparse
import importlib
import sys

import numpy as np


def pixel_extractor(images: np.ndarray, out_hw: int = 16) -> np.ndarray:
    """Downsampled-pixel 'features': a smoke fallback, not Inception-comparable."""
    n, h, w, c = images.shape
    fh, fw = h // out_hw, w // out_hw
    x = images[:, : fh * out_hw, : fw * out_hw]
    x = x.reshape(n, out_hw, fh, out_hw, fw, c).mean(axis=(2, 4))
    return x.reshape(n, -1)


def load_images(files, resolution: int) -> np.ndarray:
    """``files`` decoded and resized to ``resolution`` square: (N, res, res, 3)
    float32 in [-1, 1]."""
    from .data.native_image import load_rgb, resize_to

    return np.stack([resize_to(load_rgb(f), resolution, resolution).astype(np.float32)
                     / 127.5 - 1.0 for f in files])


def iter_image_batches(root: str, batch: int, resolution: int):
    from .data.dataset import list_image_files

    files = list_image_files(root)
    for i in range(0, len(files), batch):
        yield load_images(files[i:i + batch], resolution)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pcm_tpu_torch.eval_fid")
    ap.add_argument("--features-a")
    ap.add_argument("--features-b")
    ap.add_argument("--image-dir-a")
    ap.add_argument("--image-dir-b")
    ap.add_argument("--extractor", default=None, help="import path 'module:callable'")
    ap.add_argument("--clip-weights", default=None,
                    help="HF CLIPVisionModelWithProjection checkpoint (.safetensors/.bin); "
                         "runs the ViT-L/14 tower -> CLIP-FID")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--resolution", type=int, default=299)
    ap.add_argument("--device", default="cuda", help="where the CLIP tower runs")
    return ap


def main(argv=None) -> dict:
    """Parse ``argv``, print ``FID: <value>``; returns the FID and the two
    (N, D) feature matrices."""
    from .utils.fid import CLIPFeatures, fid_from_features

    ap = build_parser()
    args = ap.parse_args(argv)
    if args.features_a and args.features_b:
        fa, fb = np.load(args.features_a), np.load(args.features_b)
    elif args.image_dir_a and args.image_dir_b:
        if args.clip_weights:
            extract = CLIPFeatures.from_torch_file(args.clip_weights, batch=args.batch,
                                                   device=args.device)
        elif args.extractor:
            mod, fn = args.extractor.split(":")
            extract = getattr(importlib.import_module(mod), fn)
        else:
            print("# WARNING: pixel fallback extractor — smoke metric only", file=sys.stderr)
            extract = pixel_extractor
        fa, fb = (np.concatenate([np.asarray(extract(b)) for b in
                                  iter_image_batches(d, args.batch, args.resolution)])
                  for d in (args.image_dir_a, args.image_dir_b))
    else:
        ap.error("need --features-a/-b or --image-dir-a/-b")
    fid = fid_from_features(fa, fb)
    print(f"FID: {fid:.4f}")
    return {"fid": fid, "features": (fa, fb)}


if __name__ == "__main__":
    main()
